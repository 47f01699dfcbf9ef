"""Shared neural-net primitives on torch tensors.

Port of ``src/repro/models/layers.py``.  Each function keeps the
reference's precision choices, so the two packages round at the same
places: fp32 statistics and angles, elementwise math and products in the
activation dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .dist import (embed_rows, gold_logits, logsumexp_last, matmul, weight,
                   whole)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without a card
    raises (the port never drops to the CPU on its own).  ``"meta"`` is
    the dry run's device (:mod:`repro_torch.launch.dryrun`): shapes and
    dtypes only, nothing runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda is not "
                           f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm scaling by ``(1 + weight)``: the (…, 1) inverse RMS is fp32,
    the (…, D) multiplies stay in x's dtype."""
    x32 = x.float()
    scale = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return x * scale.to(x.dtype) * (1.0 + weight).to(x.dtype)


def dense(x, w):
    """x @ w.  Equal 16-bit operands stay 16-bit end to end; mixed inputs
    promote as in jnp and the result is cast back to x's dtype.  On a
    mesh the weight is gathered over the batch axes first and a
    row-parallel product's partial sums are all-reduced (``dist.weight``,
    ``dist.whole``), as tensor parallelism does."""
    w = weight(w)
    if w.dtype == x.dtype:
        return whole(matmul(x, w))
    res = torch.promote_types(x.dtype, w.dtype)
    return whole(matmul(x.to(res), w.to(res)).to(x.dtype))


def split_positions(x) -> list:
    """The time positions of a (B, T, ...) tensor as T contiguous
    (B, 1, ...) tensors.  A product or a row reduction over one of them
    runs at a (B, 1) shape whatever T is: the cached decode path computes a
    speculative window position by position so that its results do not
    depend on the window's width (a GEMM's or a reduction's order may
    change with the number of rows)."""
    return [x[:, j:j + 1].contiguous() for j in range(x.shape[1])]


def gated_mlp(x, w_up, w_down, kind: str, w_gate=None):
    """SwiGLU / GeGLU / plain-GELU MLP (separate gate and up tensors)."""
    h = dense(x, w_up)
    if kind in ("swiglu", "geglu"):
        gate = dense(x, w_gate)
        act = F.silu(gate) if kind == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = act * h
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {kind!r}")
    return dense(h, w_down)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Angles, cos and sin in fp32; the rotation in x's dtype."""
    head_dim = x.shape[-1]
    inv_freq = torch.as_tensor(
        rope_frequencies(head_dim, theta).astype(np.float32),
        device=x.device)
    angles = positions[..., :, None].float() * inv_freq      # (.., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :].to(x.dtype)
    sin = torch.sin(angles)[..., :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def sinusoidal_positions(n_pos: int, dim: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal embeddings, the reference's numpy fp32
    table: (n_pos, dim), sines then cosines."""
    log_timescale = math.log(10_000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(n_pos)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_lookup(table, tokens, *, scale: bool = False):
    out = embed_rows(table, tokens)
    if scale:  # gemma multiplies by sqrt(d_model)
        out = out * torch.tensor(math.sqrt(table.shape[1]), dtype=out.dtype,
                                 device=out.device)
    return out


def lm_logits(h, table_or_head, *, transpose: bool = False):
    """Final projection; ``transpose`` for tied (vocab, d) tables.  The
    product runs in the activation dtype (mixed inputs promote as in jnp)
    and is upcast to fp32 after."""
    w = weight(table_or_head)
    w = w.T if transpose else w
    if w.dtype != h.dtype:
        res = torch.promote_types(h.dtype, w.dtype)
        h, w = h.to(res), w.to(res)
    return matmul(h, w).float()


def cross_entropy(logits, labels, *, mask=None):
    """Mean token-level CE in fp32.  labels == -100 are ignored."""
    logits = logits.float()
    valid = (labels >= 0) if mask is None else mask
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    logz = logsumexp_last(logits)
    gold = gold_logits(logits, safe_labels)
    nll = (logz - gold) * valid.float()
    return nll.sum() / torch.clamp(valid.sum().float(), min=1.0)


# ---------------------------------------------------------------------------
# Initializers (explicit torch.Generator)
# ---------------------------------------------------------------------------

def trunc_normal_(generator: torch.Generator, out, std: float):
    """Fill ``out`` in place with ``std`` × a standard normal truncated to
    [-2, 2]."""
    if out.is_meta:
        return out
    return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def trunc_normal(generator: torch.Generator, shape, std: float = 0.02,
                 dtype=torch.float32):
    """``std`` × a standard normal truncated to [-2, 2]."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return trunc_normal_(generator, out, std)


def fan_in_std(shape) -> float:
    """1/sqrt(fan_in); fan-in is the second-to-last axis."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    return 1.0 / math.sqrt(fan_in)


def fan_in_init(generator: torch.Generator, shape, dtype=torch.float32):
    """1/sqrt(fan_in) trunc-normal; fan-in is the second-to-last axis."""
    return trunc_normal(generator, shape, fan_in_std(shape), dtype)


class MetaDraws:
    """The generator of a tree on the meta device, where nothing is drawn:
    the tree gets its shapes and dtypes and no values (the counterpart of
    ``jax.eval_shape(init_params, key)``)."""
    device = torch.device("meta")


def generator_of(generator_or_seed, device) -> torch.Generator:
    """The generator given, or a new one on ``device`` seeded with the
    int given (:class:`MetaDraws` on the meta device)."""
    if isinstance(generator_or_seed, (torch.Generator, MetaDraws)):
        return generator_or_seed
    if torch.device(device).type == "meta":
        return MetaDraws()
    return torch.Generator(device=device).manual_seed(int(generator_or_seed))


# Per-tensor initialisers ``init(generator, out) -> out``: each fills the
# tensor it is given in place (a layer's tensor, or one group's slice of a
# stacked one), so the period-stacked and the per-block draws share them.
# On a meta tensor each runs no draw (:func:`trunc_normal_` returns it
# as it is; a fill or a copy checks shapes only).

def fan_in_(generator: torch.Generator, out, scale: float = 1.0):
    """``scale`` × 1/sqrt(fan_in) trunc-normal (fan-in from out's shape)."""
    return trunc_normal_(generator, out, scale * fan_in_std(out.shape))


def zeros_(generator: torch.Generator, out):
    return out.zero_()


def full_(value: float):
    """An initialiser filling every element with ``value``."""
    def fill(generator: torch.Generator, out):
        return out.fill_(value)
    return fill


def draw_specs(generator: torch.Generator, specs, dtype=torch.float32, *,
               place=None) -> dict:
    """``{name: tensor}`` of ``(name, shape, init)`` specs, each drawn in
    order on the generator's device; ``place`` maps each tensor as soon as
    it is drawn."""
    out = {}
    for name, shape, init in specs:
        t = init(generator, torch.empty(shape, dtype=dtype,
                                        device=generator.device))
        out[name] = t if place is None else place(t)
    return out


def draw_stacked(generator: torch.Generator, specs, n: int,
                 dtype=torch.float32) -> dict:
    """The specs stacked over a leading axis of ``n`` layers: each tensor
    allocated once and drawn in place, layer by layer in spec order."""
    out = {name: torch.empty((n, *shape), dtype=dtype,
                             device=generator.device)
           for name, shape, _init in specs}
    for g in range(n):
        for name, _shape, init in specs:
            init(generator, out[name][g])
    return out
