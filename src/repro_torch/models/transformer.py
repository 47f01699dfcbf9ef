"""Per-layer pieces of the decoder LM on torch tensors.

Port of the layer taxonomy, per-layer init, the FFN half and the
full-sequence block of ``src/repro/models/transformer.py``, for the
families this port runs:
attention mixers with dense FFNs.  Other mixers (MLA, Mamba, xLSTM) and
MoE FFNs raise and name the slice that brings them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from .attention import gqa_attention
from .layers import fan_in_init, gated_mlp, rms_norm

LATER = ("is not ported yet: the PyTorch port runs attention mixers with "
         "dense FFNs (MoE, MLA, Mamba and xLSTM come with the MoE and "
         "model-zoo slices)")


def mixer_kind(cfg: ModelConfig, layer: int) -> str:
    if cfg.family == "ssm":
        if cfg.ssm.kind == "xlstm":
            return "slstm" if layer % cfg.ssm.slstm_every == \
                cfg.ssm.slstm_every - 1 else "mlstm"
        return "mamba"
    if cfg.family == "hybrid" and not cfg.is_attention_layer(layer):
        return "mamba"
    return "mla" if cfg.mla is not None else "attn"


def ffn_kind(cfg: ModelConfig, layer: int) -> str:
    if cfg.moe is not None and layer % cfg.moe_period == cfg.moe_period - 1:
        return "moe"
    return "dense" if cfg.d_ff else "none"


def layer_period(cfg: ModelConfig) -> int:
    p = math.lcm(cfg.attn_period, cfg.moe_period)
    if cfg.ssm is not None and cfg.ssm.kind == "xlstm":
        p = math.lcm(p, cfg.ssm.slstm_every)
    return min(p, cfg.n_layers)


def init_layer_params(generator: torch.Generator, cfg: ModelConfig,
                      layer: int, dtype=torch.float32) -> dict:
    """Fresh parameters of one attention/dense layer, drawn from
    ``generator`` in the reference's parameter order."""
    mk, fk = mixer_kind(cfg, layer), ffn_kind(cfg, layer)
    if mk != "attn":
        raise NotImplementedError(f"mixer {mk!r} {LATER}")
    if fk not in ("dense", "none"):
        raise NotImplementedError(f"ffn {fk!r} {LATER}")
    d = cfg.d_model
    p: dict = {"norm_mixer": torch.zeros((d,), dtype=dtype),
               "attn.w_q": fan_in_init(generator, (d, cfg.q_dim), dtype),
               "attn.w_k": fan_in_init(generator, (d, cfg.kv_dim), dtype),
               "attn.w_v": fan_in_init(generator, (d, cfg.kv_dim), dtype),
               "attn.w_o": fan_in_init(generator, (cfg.q_dim, d), dtype)}
    if cfg.qk_norm:
        p["attn.q_norm"] = torch.zeros((cfg.head_dim,), dtype=dtype)
        p["attn.k_norm"] = torch.zeros((cfg.head_dim,), dtype=dtype)
    if fk == "dense":
        p["norm_ffn"] = torch.zeros((d,), dtype=dtype)
        if cfg.gated_act in ("swiglu", "geglu"):
            p["ffn.w_gate"] = fan_in_init(generator, (d, cfg.d_ff), dtype)
        p["ffn.w_up"] = fan_in_init(generator, (d, cfg.d_ff), dtype)
        p["ffn.w_down"] = fan_in_init(generator, (cfg.d_ff, d), dtype)
    return p


def apply_ffn(cfg: ModelConfig, fk: str, params, h):
    """Pre-norm FFN residual half of a block (dense or none)."""
    if fk == "none":
        return h
    if fk != "dense":
        raise NotImplementedError(f"ffn {fk!r} {LATER}")
    hn = rms_norm(h, params["norm_ffn"], cfg.rms_eps)
    out = gated_mlp(hn, params["ffn.w_up"], params["ffn.w_down"],
                    cfg.gated_act, w_gate=params.get("ffn.w_gate"))
    return h + out


def apply_layer(cfg: ModelConfig, kinds: tuple[str, str], params, h, *,
                causal: bool = True):
    """Pre-norm residual block (training / full sequence): mixer + FFN."""
    mk, fk = kinds
    if mk != "attn":
        raise NotImplementedError(f"mixer {mk!r} {LATER}")
    hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
    mix = gqa_attention(params, hn, cfg, causal=causal)
    return apply_ffn(cfg, fk, params, h + mix)
