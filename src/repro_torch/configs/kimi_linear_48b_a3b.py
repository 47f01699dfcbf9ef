"""kimi-linear-48b-a3b [moe] — Kimi Linear: three Kimi Delta Attention
(KDA) layers to one MLA layer with no rope, one leading dense layer, 256
routed experts top-8 under the sigmoid gate with a selection bias, one
shared expert [hf:moonshotai/Kimi-Linear-48B-A3B-Instruct, config.json,
model_type kimi_linear; arXiv:2510.26692].

The layers' kinds come from the published 1-based lists, not a period:
the 27th, the last, is MLA and breaks the 3:1 pattern.  The top-level
``head_dim`` of 72 (d / heads) is used by neither mixer.

The port's departures: the capacity dispatch (the source is dropless),
RMSNorm as ``(1 + w)``; MLA keeps the 64 rope columns of ``w_q`` and
``w_dkv``, unrotated (``mla_use_nope``).
"""

from .base import KDAConfig, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-linear-48b-a3b",
    family="moe",
    n_layers=27,
    d_model=2304,
    n_heads=32,
    n_kv_heads=32,
    d_ff=9216,                   # the leading dense layer's FFN
    vocab=163_840,
    head_dim=72,
    rope_theta=10_000.0,
    rms_eps=1e-5,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=1024, n_shared=1,
                  router_aux_weight=0.0, scoring="sigmoid",
                  routed_scale=2.446),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128, use_rope=False),
    kda=KDAConfig(
        kda_layers=(1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                    21, 22, 23, 25, 26),
        full_attn_layers=(4, 8, 12, 16, 20, 24, 27),
        n_heads=32, head_dim=128, conv_kernel=4),
    first_dense_layers=1,
    source="hf:moonshotai/Kimi-Linear-48B-A3B-Instruct",
)
