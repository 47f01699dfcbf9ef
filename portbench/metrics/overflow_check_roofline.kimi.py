"""``overflow_check_roofline``, read the same way in the Kimi Linear
cell: the overflow screen over the 873 gradient leaves, one launch a
leaf a step."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("overflow_check_roofline.py"),
                   "portbench_metric_overflow_check_roofline").read
