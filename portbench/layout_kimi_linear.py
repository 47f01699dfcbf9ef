"""A Kimi Linear configuration (``model_type: kimi_linear``) as the
benchmark hands it over: the port's ``ModelConfig``, every parameter as a
:class:`weights.Leaf` in the port's unit order, the weights drawn from
the seed, and the frozen FLOP count of a training step.

The chip's share of the experts: ``held_experts`` [first, end) of the
``router_experts`` the gate picks from, ``num_experts`` of them.  The
router keeps every output; the routed experts are the held ones alone,
one leaf per (expert, matrix) under expert paging, the port's pages, or
stacked along a leading expert axis otherwise.  Leaves are named so that
``Leaf.is_expert`` holds for the routed experts' matrices alone.
"""

from __future__ import annotations

import math

import torch

import count
import weights
from layout_deepseek_v3 import BIAS_STD, _mla_shapes
from reference.kimi_linear import is_kda_layer, is_moe_layer
from weights import EMBED_STD, Leaf

from repro_torch.configs.base import (KDAConfig, MLAConfig, ModelConfig,
                                      MoEConfig)

# KDA's A = U[1, 16] (A_log its log) and dt log-uniform in [1e-3, 1e-1],
# dt_bias its inverse softplus: drawn from the leaf's own truncated normal
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)


def model_config(cfg: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file.  A port
    without KDA or a held share of the experts refuses it here, before
    anything is drawn."""
    lin = cfg["linear_attn_config"]
    if cfg["num_expert_group"] != 1 or cfg["topk_group"] != 1 or \
            cfg["moe_router_activation_func"] != "sigmoid" or \
            not cfg["moe_renormalize"] or cfg["moe_layer_freq"] != 1 or \
            cfg["tie_word_embeddings"]:
        raise ValueError(f"{cfg['name']}: the port runs one-group sigmoid "
                         f"routing, renormalised, an expert layer after "
                         f"each leading dense one, an untied head")
    kda = KDAConfig(kda_layers=tuple(lin["kda_layers"]),
                    full_attn_layers=tuple(lin["full_attn_layers"]),
                    n_heads=lin["num_heads"], head_dim=lin["head_dim"],
                    conv_kernel=lin["short_conv_kernel_size"])
    moe = MoEConfig(n_experts=cfg["router_experts"],
                    top_k=cfg["num_experts_per_token"],
                    d_ff_expert=cfg["moe_intermediate_size"],
                    n_shared=cfg["num_shared_experts"],
                    capacity_factor=cfg["moe_capacity_factor"],
                    router_aux_weight=0.0, scoring="sigmoid",
                    routed_scale=cfg["routed_scaling_factor"],
                    held=tuple(cfg["held_experts"]))
    mla = MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                    q_lora_rank=cfg["q_lora_rank"],
                    qk_nope_head_dim=cfg["qk_nope_head_dim"],
                    qk_rope_head_dim=cfg["qk_rope_head_dim"],
                    v_head_dim=cfg["v_head_dim"],
                    use_rope=not cfg["mla_use_nope"])
    if moe.n_held != cfg["num_experts"]:
        raise ValueError(f"{cfg['name']}: held_experts "
                         f"{cfg['held_experts']} are not num_experts "
                         f"{cfg['num_experts']}")
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["head_dim"], rope_theta=float(cfg["rope_theta"]),
        rms_eps=cfg["rms_norm_eps"], moe=moe, mla=mla, kda=kda,
        first_dense_layers=cfg["first_k_dense_replace"],
        source=cfg["source"])


def _kda_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    d = cfg["hidden_size"]
    lin = cfg["linear_attn_config"]
    h, hd = lin["num_heads"], lin["head_dim"]
    w, taps = h * hd, lin["short_conv_kernel_size"]
    return ([(f"kda.w_{x}", (d, w)) for x in "qkv"]
            + [(f"kda.conv_{x}", (taps, w)) for x in "qkv"]
            + [("kda.w_fa", (d, hd)), ("kda.w_fb", (hd, w)),
               ("kda.a_log", (h,)), ("kda.dt_bias", (w,)),
               ("kda.w_b", (d, h)), ("kda.w_ga", (d, hd)),
               ("kda.w_gb", (hd, w)), ("kda.b_gb", (w,)),
               ("kda.o_norm", (hd,)), ("kda.w_o", (w, d))])


# vectors drawn from their truncated normal at std 1 and mapped by
# :func:`draw`; the other vectors are zeros
_MAPPED = ("kda.a_log", "kda.dt_bias")


def layout(cfg: dict, expert_paging: str = "off") -> list[Leaf]:
    """Every parameter of ``cfg`` in the port's unit order."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    e, f = cfg["router_experts"], cfg["moe_intermediate_size"]
    held = cfg["num_experts"]
    fs = cfg["num_shared_experts"] * f
    out = [Leaf("embed", "embed", (v, d), EMBED_STD, "embed", None)]
    for i in range(cfg["num_hidden_layers"]):
        unit, pre = f"block_{i:03d}", f"layers.{i}."

        def add(key, shape, std="fan_in", ref=None, expert=None):
            if std == "fan_in":
                std = 1.0 / math.sqrt(shape[-2])
            out.append(Leaf(unit, key, tuple(shape), std,
                            pre + (ref or key), expert))

        add("norm_mixer", (d,), 0.0)
        mixer = _kda_shapes(cfg) if is_kda_layer(cfg, i) else \
            _mla_shapes(cfg)
        for key, shape in mixer:
            add(key, shape, "fan_in" if len(shape) == 2 else
                1.0 if key in _MAPPED else 0.0)
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
                add(f"moe.{w}", (held, *shape), 1.0 / math.sqrt(shape[0]))
        else:
            for x in range(held):
                for w, shape in shapes.items():
                    add(f"moe.expert{x}.{w}", shape, ref=f"moe.{w}",
                        expert=x)
        for w, shape in {"gate": (d, fs), "up": (d, fs),
                         "down": (fs, d)}.items():
            add(f"moe.shared_{w}", shape, ref=f"shared.w_{w}")
    out.append(Leaf("head", "final_norm", (d,), 0.0, "final_norm", None))
    out.append(Leaf("head", "head", (d, v), 1.0 / math.sqrt(d), "head", None))
    return out


def draw(leaves: list[Leaf], seed: int, device) -> torch.Tensor:
    """:func:`weights.draw`, then KDA's decay parameters mapped from their
    truncated normals z: u = the normal's CDF of z over [-2, 2], uniform
    in [0, 1]; A_log = log(A), A = 1 + 15 u; dt_bias = dt + log(1 -
    exp(-dt)), dt = 1e-3 x 100^u."""
    flat = weights.draw(leaves, seed, device)
    lo, hi = torch.special.ndtr(torch.tensor([-2.0, 2.0], device=device))
    for leaf, off in weights.offsets(leaves):
        if leaf.key not in _MAPPED:
            continue
        view = flat[off:off + leaf.size]
        u = (torch.special.ndtr(view) - lo) / (hi - lo)
        if leaf.key == "kda.a_log":
            a0, a1 = A_RANGE
            view.copy_(torch.log(a0 + (a1 - a0) * u))
        else:
            t0, t1 = (math.log(x) for x in DT_RANGE)
            dt = torch.exp(t0 + (t1 - t0) * u)
            view.copy_(dt + torch.log(-torch.expm1(-dt)))
    return flat


def _mixer_matrices(cfg: dict, i: int) -> int:
    shapes = _kda_shapes(cfg) if is_kda_layer(cfg, i) else _mla_shapes(cfg)
    return sum(math.prod(s) for key, s in shapes if len(s) == 2
               and not key.startswith("kda.conv_"))


def token_matmul_params(cfg: dict, share: float | None = None) -> int:
    """Matrix parameters one token passes through: each layer's KDA
    projections (the decay and output gates' two factors included; not
    the conv taps) or MLA projections (the latent's up-projection applied
    per token), and its dense FFN, or its router, ``share`` routed
    experts and its shared experts; the head.  ``share`` is by default
    k x held / router_experts, what a token passes through here on
    average where no pair is dropped."""
    d = cfg["hidden_size"]
    dense = 3 * d * cfg["intermediate_size"]
    if share is None:
        share = cfg["num_experts_per_token"] * cfg["num_experts"] / \
            cfg["router_experts"]
    moe = d * cfg["router_experts"] + 3 * d * cfg["moe_intermediate_size"] \
        * (share + cfg["num_shared_experts"])
    return int(sum(_mixer_matrices(cfg, i)
                   + (moe if is_moe_layer(cfg, i) else dense)
                   for i in range(cfg["num_hidden_layers"]))
               + d * cfg["vocab_size"])


def mla_flops(cfg: dict, batch: int, seq: int) -> int:
    """Forward FLOPs of causal MLA's two products in the MLA layers:
    (nope + rope) a (query, key) pair a head for QK^T, v for PV."""
    per_pair = 2 * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                    + cfg["v_head_dim"])
    layers = sum(not is_kda_layer(cfg, i)
                 for i in range(cfg["num_hidden_layers"]))
    return per_pair * cfg["num_attention_heads"] * batch * \
        count.causal_pairs(seq) * layers


def kda_flops(cfg: dict, batch: int, seq: int, chunk: int = 64) -> int:
    """Forward FLOPs of KDA's chunked recurrence in the KDA layers, a
    chunk of C tokens a head: the two pair products (C^2 d), the
    triangular solve over keys and values (C^2 (d + d)), the chunk's
    value product (C^2 d), and the state's three products (W S, q S,
    K^T U: 6 C d^2 in all)."""
    lin = cfg["linear_attn_config"]
    d = lin["head_dim"]
    per_chunk = 2 * chunk ** 2 * d + 2 * chunk ** 2 * d + \
        chunk ** 2 * d + 6 * chunk * d * d
    chunks = -(-seq // chunk)
    layers = sum(is_kda_layer(cfg, i) for i in range(cfg["num_hidden_layers"]))
    return per_chunk * chunks * lin["num_heads"] * batch * layers


def train_step_flops(cfg: dict, batch: int, seq: int,
                     kept_pairs: float | None = None) -> int:
    """Model FLOPs of one training step (forward and backward, no
    recompute), as ``count.train_step_flops`` takes them.  ``kept_pairs``
    is the held experts' (token, choice) pairs within capacity in a step,
    over every MoE layer: the pairs the experts compute.  Without it a
    token counts k x held / router_experts of them in each MoE layer."""
    share = None
    if kept_pairs is not None:
        moe_layers = sum(is_moe_layer(cfg, i)
                         for i in range(cfg["num_hidden_layers"]))
        share = kept_pairs / (batch * seq * moe_layers)
    return int(6 * token_matmul_params(cfg, share) * batch * seq
               + 3 * (mla_flops(cfg, batch, seq) + kda_flops(cfg, batch, seq)))
