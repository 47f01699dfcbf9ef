"""``pinned_slack_share``, read the same way in the Kimi Linear cell."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("pinned_slack_share.py"),
                   "portbench_metric_pinned_slack_share").read
