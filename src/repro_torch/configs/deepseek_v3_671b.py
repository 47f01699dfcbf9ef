"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP
[arXiv:2412.19437].

Simplifications vs the release (noted in DESIGN.md): all 61 layers are MoE
(the release keeps the first 3 dense), and sigmoid-gating/bias-free routing
is approximated by softmax top-k with an aux load-balance loss.
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,                   # per-expert FFN width
    vocab=129_280,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    mtp=True,
    source="arXiv:2412.19437",
)
