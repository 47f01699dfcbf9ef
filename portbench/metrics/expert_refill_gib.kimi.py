"""``expert_refill_gib.moonlight``, read the same way in the Kimi Linear
cell: the held experts' pages read back from the store a step."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("expert_refill_gib.moonlight.py"),
                   "portbench_metric_expert_refill_gib.moonlight").read
