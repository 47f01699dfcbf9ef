"""Kimi Delta Attention (KDA), the linear-attention mixer of Kimi Linear
[arXiv:2510.26692], on torch tensors.  The JAX package has no such
mixer.

Over the block's normed input x, with H heads of d_k = d_v channels:

* q, k, v = SiLU(causal depthwise conv of ``conv_kernel`` taps, no bias)
  of the projections ``w_q x``, ``w_k x``, ``w_v x``; q and k
  L2-normalised per head;
* the decay g_t = -exp(A_log_h) * softplus(w_fb w_fa x_t + dt_bias), one
  log-decay per key channel (alpha_t = exp(g_t)), and the write strength
  beta_t = sigmoid(w_b x_t), one per head;
* S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T,
  S_0 = 0, one (d_k, d_v) state per head; o_t = d_k^-1/2 S_t^T q_t;
* y_t = w_o [RMSNorm_dv(o_t) * sigmoid(w_gb w_ga x_t + b_gb)], the norm
  per head with one d_v-wide weight.

Training runs the chunked form (:func:`chunked_delta_rule`, chunks of
:data:`CHUNK` tokens: the chunkwise delta rule of arXiv:2406.06484 and
arXiv:2412.06464 with a decay per key channel).  Within a chunk, with
Gamma the cumulative log-decay from the chunk's start, a decay enters only
as exp(Gamma_i - Gamma_j) with j <= i, an exponent that is never positive:
a one-sided exp(-Gamma_j) would overflow fp32 once a chunk's decays sum
past -88, which A = 16 reaches within a few tokens.  Pairs of tokens in different sub-chunks
of ``SUB`` tokens factor through the later sub-chunk's first token r
(exp(Gamma_i - Gamma_r) * exp(Gamma_r - Gamma_j), both at most 1), so
those products are matrix products; pairs within one sub-chunk take the
per-channel exponent directly.  The state, the decays and the chunk's
triangular solve are fp32; the projections run in the activations'
dtype.

The backward differentiates the forward's own graph
(:class:`_KeptGraph`: no third forward pass) under the span ``kda.bwd``;
each chunked forward runs under ``kda.fwd``.  Both are timed on the
device by the calling thread's ledger (:func:`repro_torch.core.trace.
kda_ledger`: a session's, while it runs a plan), where there is one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import trace
from .layers import dense, rms_norm

CHUNK = 64        # tokens of a chunk (the span of its triangular solve)
SUB = 16          # tokens of a sub-chunk (the per-channel exponent's span)
L2_EPS = 1e-6


def short_conv(x, w):
    """SiLU of the causal depthwise conv of x (B, S, C) with taps w (K, C),
    tap K-1 on the current token, no bias; fp32."""
    taps = w.shape[0]
    xp = F.pad(x.float(), (0, 0, taps - 1, 0))
    s = x.shape[1]
    out = sum(w[i].float() * xp[:, i:i + s] for i in range(taps))
    return F.silu(out)


def l2_normalize(x):
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def kda_mixer(params, x, cfg):
    """The KDA mixer over normed inputs x (B, S, D) -> (B, S, D)."""
    kc = cfg.kda
    b, s, _ = x.shape
    h, dk = kc.n_heads, kc.head_dim

    def heads(t):
        return t.reshape(b, s, h, dk)

    q, k, v = (heads(short_conv(dense(x, params[f"kda.w_{n}"]),
                                params[f"kda.conv_{n}"])) for n in "qkv")
    q, k = l2_normalize(q), l2_normalize(k)
    a = torch.exp(params["kda.a_log"].float())[:, None]          # (H, 1)
    decay_in = dense(dense(x, params["kda.w_fa"]), params["kda.w_fb"])
    g = -a * F.softplus(heads(decay_in.float()
                              + params["kda.dt_bias"].float()))
    beta = torch.sigmoid(dense(x, params["kda.w_b"]).float())    # (B,S,H)
    o = delta_rule(q, k, v, g, beta)
    o = rms_norm(o, params["kda.o_norm"].float(), cfg.rms_eps)
    gate = dense(dense(x, params["kda.w_ga"]), params["kda.w_gb"])
    o = o * heads(torch.sigmoid(gate.float() + params["kda.b_gb"].float()))
    return dense(o.reshape(b, s, h * dk).to(x.dtype), params["kda.w_o"])


def delta_rule(q, k, v, g, beta):
    """o (B, S, H, d_v) fp32 of the gated delta rule over q, k (B, S, H,
    d_k), v (B, S, H, d_v), the log-decays g (B, S, H, d_k) and beta (B,
    S, H), from a zero state."""
    xs = (q, k, v, g, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        return _KeptGraph.apply(*xs)
    with _timed(trace.kda_ledger(), "kda.fwd", q.device,
                tokens=q.shape[0] * q.shape[1]):
        return chunked_delta_rule(*xs)


def _timed(ledger, name: str, device, tokens: int | None = None):
    """The span ``name``, timed by ``ledger`` where there is one."""
    if ledger is None:
        return trace.span(name)
    return ledger.timed(name, device, tokens=tokens)


class _KeptGraph(torch.autograd.Function):
    """:func:`chunked_delta_rule` with its forward's graph kept: the
    backward differentiates that graph under ``kda.bwd``."""

    @staticmethod
    def forward(ctx, *xs):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(xs, ctx.needs_input_grad, strict=True)]
        q = ins[0]
        # the backward may run on another thread: it takes this ledger
        ctx.ledger = trace.kda_ledger()
        with torch.enable_grad(), _timed(ctx.ledger, "kda.fwd", q.device,
                                         tokens=q.shape[0] * q.shape[1]):
            out = chunked_delta_rule(*ins)
        ctx.kept = (ins, out)
        return out.detach()

    @staticmethod
    def backward(ctx, d_out):
        ins, out = ctx.kept
        del ctx.kept
        wanted = [t for t in ins if t.requires_grad]
        with _timed(ctx.ledger, "kda.bwd", d_out.device):
            grads = iter(torch.autograd.grad(out, wanted, d_out))
        return tuple(next(grads) if t.requires_grad else None for t in ins)


def _pair_products(k, gam, *xs):
    """For each x of ``xs``, (…, C, C): sum_c x_i[c] k_j[c] exp(Gamma_i[c]
    - Gamma_j[c]) for j <= i within each chunk (0 above the diagonal),
    for x, k, gam (…, C, d) with gam the chunk's cumulative log-decay.
    The decayed keys are built once for every x."""
    *lead, c, d = k.shape
    sub = SUB
    ns = c // sub
    dev = k.device
    neg = torch.tensor(float("-inf"), device=dev)
    # different sub-chunks: through r, the first token of i's sub-chunk
    start = gam[..., ::sub, :]                                # (…, ns, d)
    to_i = torch.exp(gam - start.repeat_interleave(sub, dim=-2))
    pos = torch.arange(c, device=dev)
    before = pos[None, :] < (torch.arange(ns, device=dev) * sub)[:, None]
    from_j = torch.exp(torch.where(before[:, :, None],
                                   start[..., :, None, :]
                                   - gam[..., None, :, :], neg))
    kr = k[..., None, :, :] * from_j                       # (…, ns, C, d)
    # one sub-chunk: the exponent per channel, masked before the exp
    gs = gam.reshape(*lead, ns, sub, d)
    tri = torch.ones(sub, sub, dtype=torch.bool, device=dev).tril()
    within = torch.exp(torch.where(tri[:, :, None],
                                   gs[..., :, None, :] - gs[..., None, :, :],
                                   neg))                # (…, ns, sub, sub, d)
    kj = k.reshape(*lead, ns, sub, d)[..., None, :, :] * within
    eye = torch.eye(ns, dtype=k.dtype, device=dev)
    out = []
    for x in xs:
        off = torch.einsum("...aic,...ajc->...aij",
                           (x * to_i).reshape(*lead, ns, sub, d), kr)
        blocks = torch.einsum("...aic,...aijc->...aij",
                              x.reshape(*lead, ns, sub, d), kj)
        diag = torch.einsum("...aij,ab->...aibj", blocks, eye)
        out.append(off.reshape(*lead, c, c) + diag.reshape(*lead, c, c))
    return out


def chunked_delta_rule(q, k, v, g, beta):
    """The chunked form of :func:`delta_rule` (fp32 throughout)."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    chunk = CHUNK
    n = -(-s // chunk)
    pad = n * chunk - s

    def chunks(t):          # (B, S, H, ...) -> (B, H, n, C, ...), 0-padded
        t = t.float().movedim(1, 2)
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 3) + (0, pad))
        return t.reshape(b, h, n, chunk, *t.shape[3:])

    q = chunks(q) * dk ** -0.5
    k, v, g = chunks(k), chunks(v), chunks(g)
    beta = chunks(beta)                                   # (B, H, n, C)
    gam = g.cumsum(-2)                 # padded tokens: no decay, no write
    kk, qk = _pair_products(k, gam, k, q)
    kk = torch.tril(kk, -1) * beta[..., None]
    eye = torch.eye(chunk, dtype=k.dtype, device=k.device)
    decayed = torch.exp(gam)
    rhs = torch.cat([k * decayed, v], dim=-1) * beta[..., None]
    wu = torch.linalg.solve_triangular(kk + eye, rhs, upper=False,
                                       unitriangular=True)
    w, u0 = wu.split([dk, dv], dim=-1)
    q_in = q * decayed
    last = gam[..., -1:, :]
    k_out = (k * torch.exp(last - gam)).transpose(-1, -2)   # (…, dk, C)
    carry = torch.exp(last).transpose(-1, -2)               # (…, dk, 1)
    state = k.new_zeros((b, h, dk, dv))
    outs = []
    for i in range(n):
        u = u0[:, :, i] - w[:, :, i] @ state
        outs.append(q_in[:, :, i] @ state + qk[:, :, i] @ u)
        state = carry[:, :, i] * state + k_out[:, :, i] @ u
    o = torch.stack(outs, dim=2).reshape(b, h, n * chunk, dv)
    return o[:, :, :s].movedim(1, 2)
