"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,                   # per-expert FFN width
    vocab=32_064,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
