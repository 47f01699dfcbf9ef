"""``adam_staging_gib``, read the same way in the Kimi Linear cell."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("adam_staging_gib.py"),
                   "portbench_metric_adam_staging_gib").read
