"""``train_mfu``, read the same way in the Moonlight cell: the window's
model FLOPs (``layout_deepseek_v3.train_step_flops``: MLA, the dense and
shared FFNs, the top-k routed experts a token, the head, causal
attention) over window x 989e12."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("train_mfu.py"),
                   "portbench_metric_train_mfu").read
