"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887]."""

from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65_536,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    moe_period=2,               # MoE every other layer (16 MoE layers)
    ssm=SSMConfig(kind="mamba", d_state=16, expand=2, conv_kernel=4),
    attn_period=8,              # 1 attention layer per 8 (1:7 attn:mamba)
    source="arXiv:2403.19887",
)
