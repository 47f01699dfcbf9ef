"""starcoder2-15b [dense] — GQA kv=4, RoPE, native 4k sliding window
[arXiv:2402.19173]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49_152,
    head_dim=128,
    gated_act="gelu",           # starcoder2 uses a plain (ungated) MLP
    sliding_window=4096,        # native SWA -> long_500k runs natively
    source="arXiv:2402.19173",
)
