"""``expert_drop_share.moonlight``, read the same way in the Kimi Linear
cell: the held experts' pairs past their capacity over the held
experts' pairs (pairs routed to experts held on other chips are counted
apart, as ``expert_unheld_pairs``)."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("expert_drop_share.moonlight.py"),
                   "portbench_metric_expert_drop_share.moonlight").read
