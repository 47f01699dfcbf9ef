"""The decoder LM on torch tensors: per-layer pieces and the resident model.

Port of ``src/repro/models/transformer.py``: attention (GQA,
sliding-window, bidirectional VLM prefix), MLA, Mamba and xLSTM
(mLSTM/sLSTM) mixers with dense or MoE FFNs, and DeepSeek's
multi-token-prediction (MTP) head.  Whisper's encoder-decoder lives in
:mod:`repro_torch.models.whisper` on the same blocks.

* Per layer: the taxonomy (:func:`mixer_kind`, :func:`ffn_kind`,
  :func:`layer_period`), :func:`init_layer_params` (the reference's
  parameter order) and the blocks :func:`apply_layer` /
  :func:`apply_ffn`, which return ``(h, aux)`` as the reference's do; the
  offload adapter runs them one unit at a time.
* The device-resident model: :func:`init_params` stacks each position of
  the layer period over the ``n_layers / period`` groups
  (``params["groups"]`` is a list of dicts of ``(G, ...)`` tensors), and
  :func:`forward` / :func:`decode_step` loop over the leading group axis
  where the reference scans it.  ``remat=True`` checkpoints each group
  (``torch.utils.checkpoint``, non-reentrant), as the reference's
  ``jax.checkpoint`` does.
* :func:`from_numpy_params` carries the reference's ``init_params`` tree,
  as numpy, into the port's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import kda as kda_mod
from . import mamba as mamba_mod
from . import xlstm as xlstm_mod
from .dist import replicated, roll_seq
from .attention import gqa_attention, gqa_decode, mla_attention, mla_decode
from .layers import (cross_entropy, dense, draw_specs, draw_stacked,
                     embed_lookup, fan_in_, gated_mlp, generator_of,
                     lm_logits, rms_norm, trunc_normal_, zeros_)
from .moe import moe_ffn


# ---------------------------------------------------------------------------
# Layer taxonomy
# ---------------------------------------------------------------------------

def mixer_kind(cfg: ModelConfig, layer: int) -> str:
    if cfg.kda is not None:
        return "mla" if cfg.is_attention_layer(layer) else "kda"
    if cfg.family == "ssm":
        if cfg.ssm.kind == "xlstm":
            return "slstm" if layer % cfg.ssm.slstm_every == \
                cfg.ssm.slstm_every - 1 else "mlstm"
        return "mamba"
    if cfg.family == "hybrid" and not cfg.is_attention_layer(layer):
        return "mamba"
    return "mla" if cfg.mla is not None else "attn"


def ffn_kind(cfg: ModelConfig, layer: int) -> str:
    if cfg.is_moe_layer(layer):
        return "moe"
    return "dense" if cfg.d_ff else "none"


def layer_period(cfg: ModelConfig) -> int:
    """The period of the layers after the leading dense ones (where the
    kinds come from published layer lists, the shortest that repeats
    them and divides the layers)."""
    if cfg.kda is not None:
        n, lead = cfg.n_layers - cfg.first_dense_layers, cfg.first_dense_layers

        def kinds(i):
            return mixer_kind(cfg, lead + i), ffn_kind(cfg, lead + i)
        return next(p for p in range(1, n + 1) if n % p == 0 and all(
            kinds(i) == kinds(i % p) for i in range(n)))
    p = math.lcm(cfg.attn_period, cfg.moe_period)
    if cfg.ssm is not None and cfg.ssm.kind == "xlstm":
        p = math.lcm(p, cfg.ssm.slstm_every)
    return min(p, cfg.n_layers - cfg.first_dense_layers)


def _period_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer, ffn) kinds of each position of the period, which starts
    after the leading dense layers."""
    lead = cfg.first_dense_layers
    return [(mixer_kind(cfg, lead + j), ffn_kind(cfg, lead + j))
            for j in range(layer_period(cfg))]


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------

def layer_param_specs(cfg: ModelConfig, layer: int) -> list:
    """``(name, shape, init)`` of one layer's parameters in the
    reference's order; ``init(generator, out)`` fills a tensor of that
    shape in place (:func:`~repro_torch.models.layers.fan_in_`,
    :func:`~repro_torch.models.layers.zeros_` for norm weights, or a
    mixer's own constants)."""
    mk, fk = mixer_kind(cfg, layer), ffn_kind(cfg, layer)
    d = cfg.d_model
    specs = [("norm_mixer", (d,), zeros_)]
    if mk == "attn":
        specs += [("attn.w_q", (d, cfg.q_dim), fan_in_),
                  ("attn.w_k", (d, cfg.kv_dim), fan_in_),
                  ("attn.w_v", (d, cfg.kv_dim), fan_in_),
                  ("attn.w_o", (cfg.q_dim, d), fan_in_)]
        if cfg.qk_norm:
            specs += [("attn.q_norm", (cfg.head_dim,), zeros_),
                      ("attn.k_norm", (cfg.head_dim,), zeros_)]
    elif mk == "mla":
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        if m.q_lora_rank is None:
            specs.append(("attn.w_q", (d, cfg.n_heads * qk_head), fan_in_))
        else:
            specs += [
                ("attn.w_dq", (d, m.q_lora_rank), fan_in_),
                ("attn.q_lat_norm", (m.q_lora_rank,), zeros_),
                ("attn.w_uq", (m.q_lora_rank, cfg.n_heads * qk_head),
                 fan_in_)]
        specs += [
            ("attn.w_dkv", (d, m.kv_lora_rank + m.qk_rope_head_dim),
             fan_in_),
            ("attn.kv_lat_norm", (m.kv_lora_rank,), zeros_),
            ("attn.w_ukv", (m.kv_lora_rank,
                            cfg.n_heads * (m.qk_nope_head_dim
                                           + m.v_head_dim)), fan_in_),
            ("attn.w_o", (cfg.n_heads * m.v_head_dim, d), fan_in_)]
    elif mk == "kda":
        specs += kda_param_specs(cfg)
    elif mk == "mamba":
        specs += mamba_mod.param_specs(cfg)
    elif mk == "mlstm":
        specs += xlstm_mod.mlstm_param_specs(cfg)
    else:
        specs += xlstm_mod.slstm_param_specs(cfg)
    if fk != "none":
        specs.append(("norm_ffn", (d,), zeros_))
    if fk == "dense":
        if cfg.gated_act in ("swiglu", "geglu"):
            specs.append(("ffn.w_gate", (d, cfg.d_ff), fan_in_))
        specs += [("ffn.w_up", (d, cfg.d_ff), fan_in_),
                  ("ffn.w_down", (cfg.d_ff, d), fan_in_)]
    elif fk == "moe":
        e = cfg.moe
        specs.append(("moe.w_router", (d, e.n_experts), fan_in_))
        if e.scoring == "sigmoid":
            specs.append(("moe.router_bias", (e.n_experts,), _bias_))
        # the held experts' stacks (all of them unless the config holds
        # a share)
        specs += [("moe.w_gate", (e.n_held, d, e.d_ff_expert), fan_in_),
                  ("moe.w_up", (e.n_held, d, e.d_ff_expert), fan_in_),
                  ("moe.w_down", (e.n_held, e.d_ff_expert, d), fan_in_)]
        if e.n_shared:
            f = e.n_shared * e.d_ff_expert
            specs += [("moe.shared_gate", (d, f), fan_in_),
                      ("moe.shared_up", (d, f), fan_in_),
                      ("moe.shared_down", (f, d), fan_in_)]
    return specs


def kda_param_specs(cfg: ModelConfig) -> list:
    """The KDA mixer's parameters (:mod:`repro_torch.models.kda`): the
    projections and output by fan-in, the conv taps by theirs, A = U[1,
    16] with A_log = log A, dt_bias the inverse softplus of dt
    log-uniform in [1e-3, 1e-1], the output gate's bias and norm 0."""
    k, d = cfg.kda, cfg.d_model
    w, r = k.width, k.head_dim
    specs = [(f"kda.w_{x}", (d, w), fan_in_) for x in "qkv"]
    specs += [(f"kda.conv_{x}", (k.conv_kernel, w), fan_in_) for x in "qkv"]
    return specs + [
        ("kda.w_fa", (d, r), fan_in_), ("kda.w_fb", (r, w), fan_in_),
        ("kda.a_log", (k.n_heads,), _a_log_),
        ("kda.dt_bias", (w,), _dt_bias_),
        ("kda.w_b", (d, k.n_heads), fan_in_),
        ("kda.w_ga", (d, r), fan_in_), ("kda.w_gb", (r, w), fan_in_),
        ("kda.b_gb", (w,), zeros_), ("kda.o_norm", (k.head_dim,), zeros_),
        ("kda.w_o", (w, d), fan_in_)]


def _a_log_(generator: torch.Generator, out):
    return out.uniform_(1.0, 16.0, generator=generator).log_()


def _dt_bias_(generator: torch.Generator, out):
    dt = out.uniform_(math.log(1e-3), math.log(1e-1),
                      generator=generator).exp_()
    return dt.add_(torch.log(-torch.expm1(-dt)))


def _bias_(generator: torch.Generator, out):
    """The sigmoid gate's selection bias: 0.02 x a truncated normal (the
    embedding's scale), which changes about half of the tokens' choices at
    64 experts and unit-scale logits."""
    return trunc_normal_(generator, out, 0.02)


def init_layer_params(generator: torch.Generator, cfg: ModelConfig,
                      layer: int, dtype=torch.float32, *,
                      place=None) -> dict:
    """Fresh parameters of one layer drawn from ``generator`` (on its
    device) in the reference's parameter order.  ``place`` maps each
    tensor as soon as it is drawn (the offload adapter moves each to the
    host there, so no whole block is ever held on the device)."""
    return draw_specs(generator, layer_param_specs(cfg, layer), dtype,
                      place=place)


def init_params(generator_or_seed, cfg: ModelConfig, dtype=torch.float32,
                *, device="cuda") -> dict:
    """Full parameter tree with period-stacked layer groups: ``embed``,
    ``final_norm``, ``head`` (untied only), ``lead`` (one dict per leading
    dense layer, where the config has them), ``groups`` (one dict of
    ``(G, ...)`` tensors per position of the period after them) and, for
    MTP configs, ``mtp`` (one block of layer ``n_layers - 1``'s kinds),
    ``mtp_norm`` and ``mtp_proj``.  A seed draws from a generator on ``device``; a
    generator draws on its own device.  Each tensor is drawn in place in
    ``dtype``, so the peak is the tree itself."""
    gen = generator_of(generator_or_seed, device)
    dev = gen.device
    p, lead = layer_period(cfg), cfg.first_dense_layers
    n_groups = (cfg.n_layers - lead) // p
    assert n_groups * p == cfg.n_layers - lead, \
        f"{cfg.name}: n_layers={cfg.n_layers} not divisible by period={p}"

    def new(shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    params: dict = {"embed": trunc_normal_(gen, new((cfg.vocab, cfg.d_model)),
                                           0.02),
                    "final_norm": new((cfg.d_model,)).zero_()}
    if not cfg.tie_embeddings:
        params["head"] = fan_in_(gen, new((cfg.d_model, cfg.vocab)))
    if lead:
        params["lead"] = [init_layer_params(gen, cfg, i, dtype)
                          for i in range(lead)]
    params["groups"] = [draw_stacked(gen, layer_param_specs(cfg, lead + j),
                                     n_groups, dtype) for j in range(p)]
    if cfg.mtp:
        params["mtp"] = init_layer_params(gen, cfg, cfg.n_layers - 1, dtype)
        params["mtp_norm"] = new((cfg.d_model,)).zero_()
        params["mtp_proj"] = fan_in_(gen, new((2 * cfg.d_model, cfg.d_model)))
    return params


def from_numpy_params(cfg: ModelConfig, params_np, dtype=torch.float32,
                      device="cuda") -> dict:
    """The port's parameter tree from the reference's ``init_params`` tree
    as numpy (``groups`` a list or tuple of dicts of stacked arrays, the
    ``mtp*`` keys for MTP configs), each array cast to ``dtype`` on
    ``device``."""
    def conv(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    out = {}
    for key, value in params_np.items():
        if key in ("groups", "lead"):
            out[key] = [{k: conv(v) for k, v in g.items()} for g in value]
        elif isinstance(value, dict):
            out[key] = {k: conv(v) for k, v in value.items()}
        else:
            out[key] = conv(value)
    if len(out["groups"]) != layer_period(cfg):
        raise ValueError(f"{cfg.name}: {len(out['groups'])} groups for a "
                         f"layer period of {layer_period(cfg)}")
    return out


# ---------------------------------------------------------------------------
# Layer application (full sequence)
# ---------------------------------------------------------------------------

def apply_ffn(cfg: ModelConfig, fk: str, params, h):
    """Pre-norm FFN residual half of a block (dense, MoE or none).
    Returns ``(h, aux)``, the MoE load-balance loss or an fp32 zero (the
    offloaded applies drop it, as the reference's offloaded loss does)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if fk == "none":
        return h, aux
    hn = rms_norm(h, params["norm_ffn"], cfg.rms_eps)
    if fk == "moe":
        out, aux = moe_ffn(params, hn, cfg)
        return h + out, aux
    out = gated_mlp(hn, params["ffn.w_up"], params["ffn.w_down"],
                    cfg.gated_act, w_gate=params.get("ffn.w_gate"))
    return h + out, aux


def apply_layer(cfg: ModelConfig, kinds: tuple[str, str], params, h, *,
                prefix_len: int = 0, causal: bool = True):
    """Pre-norm residual block: mixer + FFN.  Returns ``(h, aux)``."""
    mk, fk = kinds
    hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
    mix = apply_mixer(cfg, mk, params, hn, prefix_len=prefix_len,
                      causal=causal)
    return apply_ffn(cfg, fk, params, h + mix)


def apply_mixer(cfg: ModelConfig, mk: str, params, hn, *,
                prefix_len: int = 0, causal: bool = True):
    """The mixer half of a block over normed inputs hn: (B, S, D)."""
    if mk == "attn":
        return gqa_attention(params, hn, cfg, causal=causal,
                             prefix_len=prefix_len)
    if mk == "mla":
        return mla_attention(params, hn, cfg, causal=causal)
    if mk == "kda":
        return replicated(lambda p, x: kda_mod.kda_mixer(p, x, cfg),
                          _prefixed(params, "kda"), hn, batch=(1,))
    if mk in _RECURRENT:
        # the scans' views, einsums and indexing have no sharding
        # propagation: on a mesh each rank runs its own batch rows whole
        mixer, _step, prefix = _RECURRENT[mk]
        return replicated(lambda p, x: mixer(p, x, cfg),
                          _prefixed(params, prefix), hn, batch=(1,))
    raise ValueError(mk)


# recurrent mixer kind -> (full-sequence mixer, one-token step, the
# prefix of its parameters)
_RECURRENT = {"mamba": (mamba_mod.mamba_mixer, mamba_mod.mamba_decode, "ssm"),
              "mlstm": (xlstm_mod.mlstm_mixer, xlstm_mod.mlstm_decode,
                        "mlstm"),
              "slstm": (xlstm_mod.slstm_mixer, xlstm_mod.slstm_decode,
                        "slstm")}


def _prefixed(params: dict, prefix: str) -> dict:
    return {k: v for k, v in params.items() if k.startswith(prefix + ".")}


def _n_groups(params) -> int:
    return next(iter(params["groups"][0].values())).shape[0]


def _group(stacked: dict, g: int) -> dict:
    return {k: v[g] for k, v in stacked.items()}


def forward(cfg: ModelConfig, params, h, *, prefix_len: int = 0,
            causal: bool = True, remat: bool = True, hint=None):
    """Run the layer stack over embedded inputs h: (B, S, D).  Returns
    ``(final-normed h, aux)``.  ``hint`` (optional) re-asserts the
    activation sharding after every layer group
    (:func:`repro_torch.train.step.make_act_hint`), as the reference's
    does."""
    def group_body(h, aux, gparams, kinds):
        for kind, lp in zip(kinds, gparams, strict=True):
            h, a = apply_layer(cfg, kind, lp, h, prefix_len=prefix_len,
                               causal=causal)
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # the leading dense layers one at a time, then the period's groups
    groups = [([(mixer_kind(cfg, i), ffn_kind(cfg, i))], [lp])
              for i, lp in enumerate(params.get("lead", ()))]
    groups += [(_period_kinds(cfg), [_group(s, g) for s in params["groups"]])
               for g in range(_n_groups(params))]
    for gkinds, gparams in groups:
        if remat and torch.is_grad_enabled():
            h, aux = checkpoint(group_body, h, aux, gparams, gkinds,
                                use_reentrant=False)
        else:
            h, aux = group_body(h, aux, gparams, gkinds)
        if hint is not None:
            h = hint(h)
    return rms_norm(h, params["final_norm"], cfg.rms_eps), aux


def logits_fn(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        return lm_logits(h, params["embed"], transpose=True)
    return lm_logits(h, params["head"])


def embed_tokens(cfg: ModelConfig, params, tokens, dtype):
    return embed_lookup(params["embed"], tokens,
                        scale=cfg.embed_scale).to(dtype)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, params, batch, *, compute_dtype=torch.bfloat16,
            remat: bool = True, bf16_logits: bool = False, hint=None):
    """Causal-LM loss.  batch: tokens (B, S), labels (B, S) [+ image_embeds
    (B, prefix, D) for VLM configs, ahead of the text as a bidirectional
    prefix; the loss is taken on text positions only].  MTP configs add
    0.3 × the CE of one extra block predicting t+2; MoE configs add the
    load-balance losses."""
    tokens, labels = batch["tokens"], batch["labels"].long()
    h = embed_tokens(cfg, params, tokens, compute_dtype)
    prefix = 0
    if cfg.prefix_len:
        img = batch["image_embeds"].to(compute_dtype)
        h = torch.cat([img, h], dim=1)
        prefix = cfg.prefix_len
    if hint is not None:
        h = hint(h)
    h, aux = forward(cfg, params, h, prefix_len=prefix, remat=remat,
                     hint=hint)
    if prefix:
        h = h[:, prefix:]
    logits = logits_fn(cfg, params, h)
    if bf16_logits:
        logits = logits.to(torch.bfloat16)
    loss = cross_entropy(logits, labels)

    if cfg.mtp:
        emb_next = embed_tokens(cfg, params, roll_seq(tokens, -1),
                                compute_dtype)
        h_in = dense(torch.cat(
            [rms_norm(h, params["mtp_norm"], cfg.rms_eps), emb_next],
            dim=-1), params["mtp_proj"])
        kinds = (mixer_kind(cfg, cfg.n_layers - 1),
                 ffn_kind(cfg, cfg.n_layers - 1))
        h_mtp, a2 = apply_layer(cfg, kinds, params["mtp"], h_in)
        logits2 = logits_fn(cfg, params, h_mtp)
        loss2 = cross_entropy(logits2, roll_seq(labels, -1))
        loss = loss + 0.3 * loss2
        aux = aux + a2
    return loss + aux


# ---------------------------------------------------------------------------
# Decode: caches + one-token step
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, layer: int, batch: int,
                     cache_seq: int, dtype=torch.bfloat16, device="cuda"):
    """One layer's initial cache: K/V for attention (a rolling window of
    ``sliding_window`` slots when set), the packed latent for MLA, the
    conv window (``dtype``) and SSM state (fp32) for Mamba, the fp32
    matrix state (C, n) for mLSTM and (h, c, n) for sLSTM (n starts at
    ones).  The recurrent states do not grow with ``cache_seq``."""
    mk = mixer_kind(cfg, layer)
    s = min(cache_seq, cfg.sliding_window) if cfg.sliding_window \
        else cache_seq
    f32 = dict(dtype=torch.float32, device=device)
    if mk == "attn":
        shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if mk == "mla":
        m = cfg.mla
        return {"ckv": torch.zeros((batch, s, m.kv_lora_rank
                                    + m.qk_rope_head_dim), dtype=dtype,
                                   device=device)}
    if mk == "mamba":
        ssm = cfg.ssm
        di = ssm.d_inner(cfg.d_model)
        return {"conv": torch.zeros((batch, ssm.conv_kernel - 1, di),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((batch, di, ssm.d_state), **f32)}
    if mk == "mlstm":
        dk = cfg.ssm.d_inner(cfg.d_model) // cfg.n_heads
        return {"c": torch.zeros((batch, cfg.n_heads, dk, dk), **f32),
                "n": torch.zeros((batch, cfg.n_heads, dk), **f32)}
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
            "n": torch.ones(shape, **f32)}


def _no_lead_decode(cfg: ModelConfig) -> None:
    if cfg.first_dense_layers:
        raise NotImplementedError(f"{cfg.name}: the resident decode caches "
                                  f"the period's layers only, not leading "
                                  f"dense ones")


def init_cache(cfg: ModelConfig, batch: int, cache_seq: int,
               dtype=torch.bfloat16, device="cuda") -> tuple:
    """Stacked cache tree mirroring ``params["groups"]``: one dict of
    ``(G, ...)`` tensors per position of the layer period."""
    _no_lead_decode(cfg)
    p = layer_period(cfg)
    n_groups = cfg.n_layers // p
    caches = []
    for j in range(p):
        one = init_layer_cache(cfg, j, batch, cache_seq, dtype, device)
        caches.append({k: v[None].repeat(n_groups, *([1] * v.dim()))
                       for k, v in one.items()})
    return tuple(caches)


def apply_layer_decode(cfg, kinds, params, h, cache, cache_len):
    """One block's one-token step.  Returns ``(h, new_cache)``; a
    recurrent mixer's new state replaces each cache tensor whole."""
    mk, fk = kinds
    hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
    if mk == "attn":
        mix, cache = gqa_decode(params, hn, cfg, cache, cache_len)
    elif mk == "mla":
        mix, cache = mla_decode(params, hn, cfg, cache, cache_len)
    elif mk in _RECURRENT:
        _mixer, step, prefix = _RECURRENT[mk]
        mix, cache = replicated(lambda p, x, c: step(p, x, cfg, c),
                                _prefixed(params, prefix), hn, cache,
                                batch=(1, 2))
    else:
        raise ValueError(mk)
    h, _aux = apply_ffn(cfg, fk, params, h + mix)
    return h, cache


def decode_step(cfg: ModelConfig, params, cache, tokens, cache_len, *,
                compute_dtype=torch.bfloat16):
    """One decode step: tokens (B, 1) + cache -> (logits (B, 1, V) fp32,
    new cache).  The cache passed in is left as it was."""
    _no_lead_decode(cfg)
    p = layer_period(cfg)
    kinds = [(mixer_kind(cfg, j), ffn_kind(cfg, j)) for j in range(p)]
    h = embed_tokens(cfg, params, tokens, compute_dtype)
    new = [{k: [] for k in c} for c in cache]
    for g in range(_n_groups(params)):
        for j in range(p):
            h, c = apply_layer_decode(cfg, kinds[j],
                                      _group(params["groups"][j], g), h,
                                      _group(cache[j], g), cache_len)
            for k, v in c.items():
                new[j][k].append(v)
    new_cache = tuple({k: torch.stack(v) for k, v in c.items()}
                      for c in new)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return logits_fn(cfg, params, h), new_cache
