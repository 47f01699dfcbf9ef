"""qwen3-4b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)
