"""Mamba (S6 selective SSM) mixer on torch tensors.

Port of ``src/repro/models/mamba.py``.  The recurrence
h_t = Ā_t h_{t-1} + B̄_t x_t runs chunk by chunk: a Python loop over the
chunks carries the (B, d_inner, d_state) state, and inside a chunk a
log-step (Hillis–Steele) scan composes the affine maps h -> Ā·h + B̄x with
the reference's combine ``(a1·a2, b1·a2 + b2)`` (the reference runs
``jax.lax.associative_scan`` there; PyTorch has no public associative
scan).  Under autograd each chunk is checkpointed, as the reference's
``jax.checkpoint`` does, so only the carried state is kept between chunks:
without it a full-width layer would keep every level of every chunk's scan.
The recurrent scan has no Pallas kernel in the reference, so it stays plain
torch here.

Decode carries ``{"conv": (B, K-1, d_inner), "ssm": (B, d_inner,
d_state)}`` and replaces both tensors whole each step: the state does not
grow with the sequence.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import dense, draw_specs, fan_in_, full_


def softplus(x):
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` at every x (torch's
    ``F.softplus`` switches to x above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_params(params, x, cfg):
    """Input-dependent Δ, B, C from x: (B, L, d_inner)."""
    dt = softplus(dense(dense(x, params["ssm.w_dt_in"]), params["ssm.w_dt"])
                  + params["ssm.dt_bias"].to(x.dtype))
    b_in = dense(x, params["ssm.w_b"])
    c_in = dense(x, params["ssm.w_c"])
    return dt, b_in, c_in                              # (B,L,di), (B,L,ds) x2


def _discretize(dt, b_in, x, a_log):
    """Ā = exp(Δ·A) (ZOH) and B̄x = Δ·x·B, in fp32, over (..., di, ds):
    dt, x (..., di); b_in (..., ds).  The reference's scan body and decode
    step inline exactly this arithmetic."""
    a = -torch.exp(a_log.float())                      # (di, ds), negative
    dt32 = dt.float()
    decay = torch.exp(dt32[..., None] * a)
    inp = (dt32 * x.float())[..., None] * b_in.float()[..., None, :]
    return decay, inp


def causal_conv1d(x, w, *, state=None):
    """Depthwise causal conv, kernel K.  x: (B, L, C), w: (K, C).  With
    ``state`` (B, K-1, C) it continues a stream.  Returns (y, new_state);
    the taps are summed in the reference's order, in x's dtype."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                    # (B, L+K-1, C)
    wc = w.to(x.dtype)
    y = sum(xp[:, i:i + x.shape[1], :] * wc[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad[:, :0]
    return y, new_state


def _log_step_scan(a, b):
    """Inclusive scan over axis 1 of the maps h -> a·h + b: after it,
    ``(a[t], b[t])`` composes positions 0..t.  log2(n) levels, each
    combining position t with t - d by ``(a1·a2, b1·a2 + b2)``."""
    d = 1
    while d < a.shape[1]:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]],
                          dim=1))
        d *= 2
    return a, b


def _scan_chunk(h, a_log, x, dt, b_in, c_in):
    """One chunk: state in (B, di, ds) -> (state out, y (B, chunk, di))."""
    decay, inp = _discretize(dt, b_in, x, a_log)        # (B,chunk,di,ds)
    cum_a, cum_b = _log_step_scan(decay, inp)
    h_t = cum_a * h[:, None] + cum_b
    y = torch.einsum("bcds,bcs->bcd", h_t, c_in.float())
    return h_t[:, -1], y


def selective_scan(x, dt, b_in, c_in, a_log, d_skip, *, chunk: int,
                   h0=None):
    """Chunked selective scan.

    x, dt: (B, L, di); b_in, c_in: (B, L, ds); a_log: (di, ds); d_skip:
    (di,).  Returns (y (B, L, di) in x's dtype, h_final (B, di, ds) fp32).
    """
    bsz, L, di = x.shape
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"seq len {L} not divisible by chunk {chunk}")
    h = torch.zeros((bsz, di, b_in.shape[-1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0
    ys = []
    for lo in range(0, L, chunk):
        args = (h, a_log, x[:, lo:lo + chunk], dt[:, lo:lo + chunk],
                b_in[:, lo:lo + chunk], c_in[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            h, y = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            h, y = _scan_chunk(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1) + d_skip.float() * x.float()
    return y.to(x.dtype), h


def mamba_mixer(params, x, cfg):
    """Full Mamba block mixer (train/prefill).  x: (B, L, D) -> (B, L, D)."""
    xi = dense(x, params["ssm.w_in_x"])                # (B,L,di)
    z = dense(x, params["ssm.w_in_z"])
    xi, _ = causal_conv1d(xi, params["ssm.conv_w"])
    xi = F.silu(xi)
    dt, b_in, c_in = _ssm_params(params, xi, cfg)
    y, _ = selective_scan(xi, dt, b_in, c_in, params["ssm.a_log"],
                          params["ssm.d_skip"], chunk=cfg.ssm.chunk)
    y = y * F.silu(z)
    return dense(y, params["ssm.w_out"])


def mamba_decode(params, x, cfg, cache):
    """One-token streaming update.  x: (B, 1, D); cache ``{"conv": (B,
    K-1, di), "ssm": (B, di, ds)}``.  Returns (out, new_cache); the cache
    passed in is not written."""
    xi = dense(x, params["ssm.w_in_x"])
    z = dense(x, params["ssm.w_in_z"])
    xi, conv_state = causal_conv1d(xi, params["ssm.conv_w"],
                                   state=cache["conv"])
    xi = F.silu(xi)
    dt, b_in, c_in = _ssm_params(params, xi, cfg)
    decay, inp = _discretize(dt[:, 0], b_in[:, 0], xi[:, 0],
                             params["ssm.a_log"])      # (B,di,ds)
    h = cache["ssm"] * decay + inp
    y = torch.einsum("bds,bs->bd", h, c_in[:, 0].float())
    y = y + params["ssm.d_skip"].float() * xi[:, 0].float()
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None, :]
    out = dense(y, params["ssm.w_out"])
    return out, {"conv": conv_state.to(cache["conv"].dtype), "ssm": h}


def _a_log_(d_state: int):
    """log(1..d_state) along the state axis, the same in every row
    (S4D-real), computed in fp32 as the reference does."""
    row = np.log(np.arange(1, d_state + 1, dtype=np.float32))

    def fill(generator, out):
        return out.copy_(torch.from_numpy(row).expand(out.shape))
    return fill


def param_specs(cfg) -> list:
    """``(name, shape, init)`` of one Mamba mixer, in the reference's
    order: fan-in trunc-normal projections, ``dt_bias`` −4.6
    (softplus⁻¹(0.01)), ``a_log`` log(1..d_state), ``d_skip`` ones."""
    s = cfg.ssm
    d, di, ds = cfg.d_model, s.d_inner(cfg.d_model), s.d_state
    dtr = s.dt_rank_for(d)
    return [("ssm.w_in_x", (d, di), fan_in_),
            ("ssm.w_in_z", (d, di), fan_in_),
            ("ssm.conv_w", (s.conv_kernel, di), fan_in_),
            ("ssm.w_dt_in", (di, dtr), fan_in_),
            ("ssm.w_b", (di, ds), fan_in_),
            ("ssm.w_c", (di, ds), fan_in_),
            ("ssm.w_dt", (dtr, di), fan_in_),
            ("ssm.dt_bias", (di,), full_(-4.6)),
            ("ssm.a_log", (di, ds), _a_log_(ds)),
            ("ssm.d_skip", (di,), full_(1.0)),
            ("ssm.w_out", (di, d), fan_in_)]


def init_mamba_params(generator: torch.Generator, cfg,
                      dtype=torch.float32) -> dict:
    """One Mamba mixer's parameters drawn from ``generator`` on its
    device."""
    return draw_specs(generator, param_specs(cfg), dtype)
