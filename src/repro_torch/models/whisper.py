"""Whisper-style encoder-decoder backbone on torch tensors
[arXiv:2212.04356].

Port of ``src/repro/models/whisper.py``.  The mel-spectrogram + conv
feature extractor is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, encoder_seq, D).  This module
runs everything downstream: sinusoidal positions, the bidirectional
encoder stack, and the causal decoder with cross-attention, on the shared
attention and MLP primitives.

The tree is the reference's: ``embed`` (tied with the output head),
``enc_final_norm``, ``final_norm``, and ``enc_layers`` / ``dec_layers``,
each a dict of layer-stacked tensors.  Under autograd each layer is
checkpointed when ``remat`` is set, as the reference's ``jax.checkpoint``
does.  Decode keeps per-layer self-attention K/V caches and the cross K/V
computed once from the encoder memory (:func:`prefill_cross_cache`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from .dist import merge_heads, split_heads
from .attention import (_repeat_kv, attention_scores, cross_attention,
                        gqa_attention, gqa_decode)
from .layers import (cross_entropy, dense, draw_stacked, embed_lookup,
                     fan_in_, gated_mlp, generator_of, lm_logits, rms_norm,
                     sinusoidal_positions, trunc_normal_, zeros_)


def _attn_specs(cfg: ModelConfig, prefix: str) -> list:
    d = cfg.d_model
    return [(f"{prefix}.w_q", (d, cfg.q_dim)),
            (f"{prefix}.w_k", (d, cfg.kv_dim)),
            (f"{prefix}.w_v", (d, cfg.kv_dim)),
            (f"{prefix}.w_o", (cfg.q_dim, d))]


def _ffn_specs(cfg: ModelConfig) -> list:
    up_mult = 2 if cfg.gated_act in ("swiglu", "geglu") else 1
    return [("ffn.w_up", (cfg.d_model, up_mult * cfg.d_ff)),
            ("ffn.w_down", (cfg.d_ff, cfg.d_model))]


def layer_specs(cfg: ModelConfig, decoder: bool) -> list:
    """``(name, shape, init)`` of one encoder or decoder layer, in the
    reference's order: zero norm weights, fan-in trunc-normal
    projections."""
    d = cfg.d_model
    norms = ["norm_mixer", "norm_xattn", "norm_ffn"] if decoder \
        else ["norm_mixer", "norm_ffn"]
    mats = _attn_specs(cfg, "attn") + (
        _attn_specs(cfg, "xattn") if decoder else []) + _ffn_specs(cfg)
    return [(n, (d,), zeros_) for n in norms] + \
        [(n, shape, fan_in_) for n, shape in mats]


def init_whisper_params(generator_or_seed, cfg: ModelConfig,
                        dtype=torch.float32, *, device="cuda") -> dict:
    """The reference's tree drawn in place in ``dtype`` from a generator
    (on its own device) or a seed (a generator on ``device``)."""
    gen = generator_of(generator_or_seed, device)

    def new(shape):
        return torch.empty(shape, dtype=dtype, device=gen.device)

    return {"embed": trunc_normal_(gen, new((cfg.vocab, cfg.d_model)), 0.02),
            "enc_final_norm": new((cfg.d_model,)).zero_(),
            "final_norm": new((cfg.d_model,)).zero_(),
            "enc_layers": draw_stacked(gen, layer_specs(cfg, False),
                                       cfg.encoder_layers, dtype),
            "dec_layers": draw_stacked(gen, layer_specs(cfg, True),
                                       cfg.n_layers, dtype)}


def from_numpy_params(params_np, dtype=torch.float32,
                      device="cuda") -> dict:
    """The port's tree from the reference's ``init_whisper_params`` tree
    as numpy, each array cast to ``dtype`` on ``device``."""
    def conv(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    return {k: ({n: conv(a) for n, a in v.items()} if isinstance(v, dict)
                else conv(v)) for k, v in params_np.items()}


def _positions(n_pos: int, cfg: ModelConfig, like):
    return torch.from_numpy(sinusoidal_positions(n_pos, cfg.d_model)).to(
        device=like.device, dtype=like.dtype)


def _layer(stacked: dict, g: int) -> dict:
    return {k: v[g] for k, v in stacked.items()}


def _run(body, h, stacked, n, remat):
    for g in range(n):
        lp = _layer(stacked, g)
        if remat and torch.is_grad_enabled():
            h = checkpoint(body, h, lp, use_reentrant=False)
        else:
            h = body(h, lp)
    return h


def encode(cfg: ModelConfig, params, frames, *, remat: bool = True):
    """frames: (B, T_enc, D) stub embeddings -> encoder memory."""
    h = frames + _positions(frames.shape[1], cfg, frames)[None]

    def body(h, lp):
        hn = rms_norm(h, lp["norm_mixer"], cfg.rms_eps)
        h = h + gqa_attention(lp, hn, cfg, causal=False)
        hn = rms_norm(h, lp["norm_ffn"], cfg.rms_eps)
        return h + gated_mlp(hn, lp["ffn.w_up"], lp["ffn.w_down"],
                             cfg.gated_act)

    h = _run(body, h, params["enc_layers"], cfg.encoder_layers, remat)
    return rms_norm(h, params["enc_final_norm"], cfg.rms_eps)


def _dec_layer(cfg, lp, h, memory):
    hn = rms_norm(h, lp["norm_mixer"], cfg.rms_eps)
    h = h + gqa_attention(lp, hn, cfg, causal=True)
    hn = rms_norm(h, lp["norm_xattn"], cfg.rms_eps)
    h = h + cross_attention(lp, hn, memory, cfg)
    hn = rms_norm(h, lp["norm_ffn"], cfg.rms_eps)
    return h + gated_mlp(hn, lp["ffn.w_up"], lp["ffn.w_down"], cfg.gated_act)


def decoder_forward(cfg: ModelConfig, params, tokens, memory,
                    compute_dtype=torch.bfloat16, *, remat: bool = True):
    """The decoder stack over tokens (B, S) attending to ``memory``;
    returns the final-normed hidden states."""
    h = embed_lookup(params["embed"], tokens).to(compute_dtype)
    h = h + _positions(tokens.shape[1], cfg, h)[None]
    h = _run(lambda h, lp: _dec_layer(cfg, lp, h, memory), h,
             params["dec_layers"], cfg.n_layers, remat)
    return rms_norm(h, params["final_norm"], cfg.rms_eps)


def whisper_logits(cfg: ModelConfig, params, batch, *,
                   compute_dtype=torch.bfloat16, remat: bool = True):
    """fp32 logits (B, S, V) of frames (B, T_enc, D) and tokens (B, S)."""
    memory = encode(cfg, params, batch["frames"].to(compute_dtype),
                    remat=remat)
    h = decoder_forward(cfg, params, batch["tokens"], memory, compute_dtype,
                        remat=remat)
    return lm_logits(h, params["embed"], transpose=True)


def whisper_loss(cfg: ModelConfig, params, batch, *,
                 compute_dtype=torch.bfloat16, remat: bool = True):
    """batch: frames (B, T_enc, D), tokens (B, S), labels (B, S)."""
    logits = whisper_logits(cfg, params, batch, compute_dtype=compute_dtype,
                            remat=remat)
    return cross_entropy(logits, batch["labels"].long())


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_whisper_cache(cfg: ModelConfig, batch: int, cache_seq: int,
                       dtype=torch.bfloat16, device="cuda") -> dict:
    """Self-attention K/V caches (per decoder layer) and the cross K/V."""
    kv = (cfg.n_layers, batch, cache_seq, cfg.n_kv_heads, cfg.head_dim)
    xkv = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
           cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "xk": torch.zeros(xkv, dtype=dtype, device=device),
            "xv": torch.zeros(xkv, dtype=dtype, device=device)}


def prefill_cross_cache(cfg: ModelConfig, params, memory, cache) -> dict:
    """A new cache whose cross K/V come from the encoder ``memory`` (once
    a request)."""
    lps = params["dec_layers"]

    def proj(name):
        return torch.stack([
            split_heads(dense(memory, w), cfg.n_kv_heads, cfg.head_dim)
            for w in lps[name]])

    return {**cache, "xk": proj("xattn.w_k").to(cache["xk"].dtype),
            "xv": proj("xattn.w_v").to(cache["xv"].dtype)}


def whisper_decode_step(cfg: ModelConfig, params, cache, tokens, cache_len,
                        *, compute_dtype=torch.bfloat16):
    """One decoder token against the self and cross K/V caches.  Returns
    (logits (B, 1, V) fp32, new cache); the cache passed in is left as it
    was."""
    h = embed_lookup(params["embed"], tokens).to(compute_dtype)
    table = _positions(cache["k"].shape[2] + 1, cfg, h)
    # ``dynamic_slice_in_dim`` clamps its start into range
    cl = torch.as_tensor(cache_len, dtype=torch.int64, device=h.device)
    row = torch.clamp(cl, 0, table.shape[0] - 1).reshape(1)
    h = h + table.index_select(0, row)[None]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    new_k, new_v = [], []
    for g in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], g)
        hn = rms_norm(h, lp["norm_mixer"], cfg.rms_eps)
        mix, kv = gqa_decode(lp, hn, cfg, {"k": cache["k"][g],
                                           "v": cache["v"][g]}, cache_len)
        h = h + mix
        new_k.append(kv["k"])
        new_v.append(kv["v"])
        hn = rms_norm(h, lp["norm_xattn"], cfg.rms_eps)
        q = split_heads(dense(hn, lp["xattn.w_q"]), cfg.n_heads,
                        cfg.head_dim)
        out = attention_scores(q, _repeat_kv(cache["xk"][g], n_rep),
                               _repeat_kv(cache["xv"][g], n_rep),
                               causal=False)
        h = h + dense(merge_heads(out), lp["xattn.w_o"])
        hn = rms_norm(h, lp["norm_ffn"], cfg.rms_eps)
        h = h + gated_mlp(hn, lp["ffn.w_up"], lp["ffn.w_down"],
                          cfg.gated_act)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = lm_logits(h, params["embed"], transpose=True)
    return logits, {**cache, "k": torch.stack(new_k),
                    "v": torch.stack(new_v)}
