"""``train_mfu``, read the same way in the routed MoE cell, whose rate is
kept per layer (``train_tokens_per_s.routed``)."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("train_mfu.py"),
                   "portbench_metric_train_mfu").read
