"""``train_mfu``, read the same way in the Kimi Linear cell: the window's
model FLOPs (``layout_kimi_linear.train_step_flops``: KDA's projections
and chunked recurrence, causal MLA, the dense FFN, the shared expert,
the routed experts' share here, the head) over window x 989e12."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("train_mfu.py"),
                   "portbench_metric_train_mfu").read
