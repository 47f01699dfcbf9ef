"""The Kimi Linear cell's training rate, kept per layer as the Moonlight
cell keeps its own: every token of every step in the window over the
window's seconds."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("train_tokens_per_s.routed.py"),
                   "portbench_metric_train_tokens_per_s.routed").read
