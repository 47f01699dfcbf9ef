"""A DeepSeek-V3-style configuration (``model_type: deepseek_v3``) as the
benchmark hands it over: the port's ``ModelConfig``, every parameter as a
:class:`weights.Leaf` in the port's unit order, and the frozen FLOP count
of a training step.

Leaves are named so that ``Leaf.is_expert`` holds for the routed experts'
matrices alone: the router's ``moe.w_router`` and ``moe.router_bias``
and the shared experts' ``shared.w_*`` are not experts there.  The
routed experts are one leaf per (expert, matrix) under expert paging,
the port's pages, or stacked along a leading expert axis otherwise.
"""

from __future__ import annotations

import math

import count
from reference.deepseek_v3 import is_moe_layer
from weights import EMBED_STD, Leaf

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

# the gate's selection bias: 0.02 x the truncated normal (the embedding's
# scale); it changes about half of the tokens' choices at 64 experts
BIAS_STD = 0.02


def model_config(cfg: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file.  A port without
    the sigmoid gate or leading dense layers refuses the keywords here,
    before anything is drawn."""
    if cfg["n_group"] != 1 or cfg["topk_group"] != 1 or \
            cfg["topk_method"] != "noaux_tc" or \
            cfg["scoring_func"] != "sigmoid" or not cfg["norm_topk_prob"] \
            or cfg["moe_layer_freq"] != 1 or cfg["tie_word_embeddings"]:
        raise ValueError(f"{cfg['name']}: the port runs one-group noaux_tc "
                         f"sigmoid routing, renormalised, an expert layer "
                         f"after each leading dense one, an untied head")
    moe = MoEConfig(n_experts=cfg["n_routed_experts"],
                    top_k=cfg["num_experts_per_tok"],
                    d_ff_expert=cfg["moe_intermediate_size"],
                    n_shared=cfg["n_shared_experts"],
                    capacity_factor=cfg["moe_capacity_factor"],
                    router_aux_weight=0.0, scoring="sigmoid",
                    routed_scale=cfg["routed_scaling_factor"])
    mla = MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                    q_lora_rank=cfg["q_lora_rank"],
                    qk_nope_head_dim=cfg["qk_nope_head_dim"],
                    qk_rope_head_dim=cfg["qk_rope_head_dim"],
                    v_head_dim=cfg["v_head_dim"])
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"],
        moe=moe, mla=mla, first_dense_layers=cfg["first_k_dense_replace"],
        source=cfg["source"])


def _mla_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    rank, q_rank = cfg["kv_lora_rank"], cfg["q_lora_rank"]
    if q_rank is None:
        q = [("attn.w_q", (d, h * (nope + rope)))]
    else:
        q = [("attn.w_dq", (d, q_rank)), ("attn.q_lat_norm", (q_rank,)),
             ("attn.w_uq", (q_rank, h * (nope + rope)))]
    return q + [("attn.w_dkv", (d, rank + rope)),
                ("attn.kv_lat_norm", (rank,)),
                ("attn.w_ukv", (rank, h * (nope + dv))),
                ("attn.w_o", (h * dv, d))]


def layout(cfg: dict, expert_paging: str = "off") -> list[Leaf]:
    """Every parameter of ``cfg`` in the port's unit order."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * f
    out = [Leaf("embed", "embed", (v, d), EMBED_STD, "embed", None)]
    for i in range(cfg["num_hidden_layers"]):
        unit, pre = f"block_{i:03d}", f"layers.{i}."

        def add(key, shape, std="fan_in", ref=None, expert=None):
            if std == "fan_in":
                std = 1.0 / math.sqrt(shape[-2])
            out.append(Leaf(unit, key, tuple(shape), std,
                            pre + (ref or key), expert))

        add("norm_mixer", (d,), 0.0)
        for key, shape in _mla_shapes(cfg):
            add(key, shape, 0.0 if len(shape) == 1 else "fan_in")
        add("norm_ffn", (d,), 0.0)
        if not is_moe_layer(cfg, i):
            di = cfg["intermediate_size"]
            add("ffn.w_gate", (d, di))
            add("ffn.w_up", (d, di))
            add("ffn.w_down", (di, d))
            continue
        add("moe.w_router", (d, e))
        add("moe.router_bias", (e,), BIAS_STD)
        shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
        if expert_paging == "off":
            for w, shape in shapes.items():
                add(f"moe.{w}", (e, *shape), 1.0 / math.sqrt(shape[0]))
        else:
            for x in range(e):
                for w, shape in shapes.items():
                    add(f"moe.expert{x}.{w}", shape, ref=f"moe.{w}",
                        expert=x)
        for w, shape in {"gate": (d, fs), "up": (d, fs),
                         "down": (fs, d)}.items():
            add(f"moe.shared_{w}", shape, ref=f"shared.w_{w}")
    out.append(Leaf("head", "final_norm", (d,), 0.0, "final_norm", None))
    out.append(Leaf("head", "head", (d, v), 1.0 / math.sqrt(d), "head", None))
    return out


def token_matmul_params(cfg: dict) -> int:
    """Matrix parameters one token passes through: each layer's MLA
    projections (the latent's up-projection applied per token, not
    absorbed) and its dense FFN, or its router, its top-k routed experts
    and its shared experts; the head.  Not the embedding gather."""
    d = cfg["hidden_size"]
    attn = sum(math.prod(s) for _k, s in _mla_shapes(cfg) if len(s) == 2)
    dense = 3 * d * cfg["intermediate_size"]
    moe = d * cfg["n_routed_experts"] + 3 * d * cfg["moe_intermediate_size"] \
        * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
    layers = range(cfg["num_hidden_layers"])
    return sum(attn + (moe if is_moe_layer(cfg, i) else dense)
               for i in layers) + d * cfg["vocab_size"]


def attention_flops(cfg: dict, batch: int, seq: int) -> int:
    """Forward FLOPs of causal MLA's two products: (nope + rope) a
    (query, key) pair a head for QK^T, v for PV, two FLOPs a product."""
    per_pair = 2 * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                    + cfg["v_head_dim"])
    return per_pair * cfg["num_attention_heads"] * batch * \
        count.causal_pairs(seq) * cfg["num_hidden_layers"]


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step (forward and backward, no
    recompute), as ``count.train_step_flops`` takes them."""
    return 6 * token_matmul_params(cfg) * batch * seq + \
        3 * attention_flops(cfg, batch, seq)
