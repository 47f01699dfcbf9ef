"""paligemma-3b [vlm] — SigLIP vision tower is a STUB (input_specs provides
patch embeddings); gemma-2b-class decoder with MQA kv=1 [arXiv:2407.07726]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,                # MQA
    d_ff=16384,
    vocab=257_216,
    head_dim=256,
    gated_act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    prefix_len=256,              # 224px/14 -> 16x16 patches from stubbed SigLIP
    source="arXiv:2407.07726",
)
