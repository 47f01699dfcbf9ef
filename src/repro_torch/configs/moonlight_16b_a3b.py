"""moonlight-16b-a3b [moe] — DeepSeek-V3's block at 16B: MLA with no query
latent, one leading dense layer, 64 routed experts top-6 under the
sigmoid gate with a selection bias, 2 shared experts
[hf:moonshotai/Moonlight-16B-A3B, config.json, model_type deepseek_v3].

The port's departures: the capacity dispatch (the source is dropless),
rope on the rope half's halves (the release interleaves: a fixed
permutation of the 64 rope columns), RMSNorm as ``(1 + w)``.
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11_264,                 # the leading dense layer's FFN
    vocab=163_840,
    rope_theta=50_000.0,
    rms_eps=1e-5,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  router_aux_weight=0.0, scoring="sigmoid",
                  routed_scale=2.446),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    first_dense_layers=1,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
