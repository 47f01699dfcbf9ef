"""gemma-7b [dense] — GeGLU, head_dim=256, GQA kv=16 [arXiv:2403.08295]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256_000,
    head_dim=256,
    gated_act="geglu",
    tie_embeddings=True,
    embed_scale=True,        # gemma ties input/output embeddings
    source="arXiv:2403.08295",
)
