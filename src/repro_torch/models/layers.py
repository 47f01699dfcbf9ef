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


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm scaling by ``(1 + weight)``: the (…, 1) inverse RMS is fp32,
    the (…, D) multiplies stay in x's dtype."""
    x32 = x.float()
    scale = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return x * scale.to(x.dtype) * (1.0 + weight).to(x.dtype)


def dense(x, w):
    """x @ w.  Equal 16-bit operands stay 16-bit end to end; mixed inputs
    promote as in jnp and the result is cast back to x's dtype."""
    if w.dtype == x.dtype:
        return torch.matmul(x, w)
    res = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(res), w.to(res)).to(x.dtype)


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


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_lookup(table, tokens, *, scale: bool = False):
    out = F.embedding(tokens, table)
    if scale:  # gemma multiplies by sqrt(d_model)
        out = out * torch.tensor(math.sqrt(table.shape[1]), dtype=out.dtype,
                                 device=out.device)
    return out


def lm_logits(h, table_or_head, *, transpose: bool = False):
    """Final projection; ``transpose`` for tied (vocab, d) tables.  The
    product runs in the activation dtype and is upcast to fp32 after."""
    w = table_or_head.T if transpose else table_or_head
    return torch.matmul(h, w).float()


# ---------------------------------------------------------------------------
# Initializers (explicit torch.Generator)
# ---------------------------------------------------------------------------

def trunc_normal(generator: torch.Generator, shape, std: float = 0.02,
                 dtype=torch.float32):
    """``std`` × a standard normal truncated to [-2, 2]."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def fan_in_init(generator: torch.Generator, shape, dtype=torch.float32):
    """1/sqrt(fan_in) trunc-normal; fan-in is the second-to-last axis."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    return trunc_normal(generator, shape, 1.0 / math.sqrt(fan_in), dtype)
