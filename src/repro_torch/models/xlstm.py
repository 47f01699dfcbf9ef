"""xLSTM blocks on torch tensors: chunked mLSTM + sequential sLSTM
[arXiv:2405.04517].

Port of ``src/repro/models/xlstm.py``.  mLSTM is a matrix-memory
linear-attention recurrence

    C_t = f_t C_{t-1} + i_t k_t v_tᵀ,    n_t = f_t n_{t-1} + i_t k_t,
    y_t = (q_tᵀ C_t) / max(|q_tᵀ n_t|, 1)

run chunk by chunk: inside a chunk the decay products form a banded matrix
D_ts = exp(logcum_f_t − logcum_f_s)·i_s applied to q·kᵀ (a masked
attention product); a Python loop over the chunks carries the (heads, d_k,
d_v) matrix state, each chunk checkpointed under autograd as the
reference's ``jax.checkpoint`` does.

sLSTM has recurrent (h_{t-1}-dependent) gating, so it is a Python loop
over time, as the reference's ``lax.scan`` is: about a dozen small kernels
a step.  Neither recurrence has a Pallas kernel in the reference; both
stay plain torch.

The reference's simplifications are kept: a sigmoid input gate (no exp
gate with a stabiliser state) and a headwise RMS output norm without the
learned output gate.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .layers import dense, draw_specs, fan_in_, rms_norm, zeros_


def _one(x):
    return torch.ones((), dtype=x.dtype, device=x.device)


def _sqrt_in(n: int, dtype) -> float:
    """sqrt(n) computed and rounded in ``dtype``, as the reference's
    ``jnp.sqrt(jnp.asarray(n, dtype))`` (on the host: no device copy)."""
    return float(torch.sqrt(torch.tensor(n, dtype=dtype)))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_chunk(c_state, n_state, qs, ks, vs, isg, fsg):
    """One chunk: (C, n) in -> (C, n) out and y (B, chunk, H, dv), fp32."""
    chunk = qs.shape[1]
    logf = torch.log(fsg + 1e-9)                       # (B,c,H)
    cum = torch.cumsum(logf, dim=1)
    q32, k32, v32 = qs.float(), ks.float(), vs.float()
    # inter-chunk: q_t sees the decayed initial state
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bchk,bhkv->bchv", q32, c_state)
    n_inter = torch.exp(cum)[..., None] * n_state[:, None]
    # intra-chunk: banded decay attention
    dmat = cum[:, :, None, :] - cum[:, None, :, :]     # (B,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=qs.device))
    w = torch.where(tri[None, :, :, None], torch.exp(dmat),
                    torch.zeros((), device=qs.device))
    w = w * isg[:, None, :, :]                         # i_s weighting
    scores = torch.einsum("bthk,bshk->btsh", q32, k32)
    aw = scores * w
    y_intra = torch.einsum("btsh,bshv->bthv", aw, v32)
    n_intra = torch.einsum("btsh,bshk->bthk", w, k32)
    # state update to the chunk's end
    tail = cum[:, -1:, :] - cum                        # decay to chunk end
    wk = (torch.exp(tail) * isg)[..., None] * k32
    c_new = torch.exp(cum[:, -1])[..., None, None] * c_state + \
        torch.einsum("bchk,bchv->bhkv", wk, v32)
    n_new = torch.exp(cum[:, -1])[..., None] * n_state + wk.sum(dim=1)
    denom = torch.maximum(
        torch.abs(torch.einsum("bchk,bchk->bch", q32, n_inter + n_intra)),
        _one(q32))[..., None]
    return c_new, n_new, (y_inter + y_intra) / denom


def mlstm_mixer(params, x, cfg, *, state=None, return_state=False):
    """x: (B, L, D) -> (B, L, D).  state: (C (B,H,dk,dv), n (B,H,dk))."""
    b, L, d = x.shape
    nh = cfg.n_heads
    di = cfg.ssm.d_inner(d)
    dk = di // nh
    q = dense(x, params["mlstm.w_q"]).reshape(b, L, nh, dk)
    k = dense(x, params["mlstm.w_k"]).reshape(b, L, nh, dk) / \
        _sqrt_in(dk, x.dtype)
    v = dense(x, params["mlstm.w_v"]).reshape(b, L, nh, dk)
    gates = dense(x, params["mlstm.w_gates"]).float()
    i_gate = torch.sigmoid(gates[..., :nh])            # (B,L,H)
    f_gate = torch.sigmoid(gates[..., nh:] + 4.0)      # long memory

    chunk = min(cfg.ssm.chunk, L)
    if L % chunk:
        raise ValueError(f"L={L} % chunk={chunk}")
    if state is None:
        c_st = torch.zeros((b, nh, dk, dk), dtype=torch.float32,
                           device=x.device)
        n_st = torch.zeros((b, nh, dk), dtype=torch.float32, device=x.device)
    else:
        c_st, n_st = state
    ys = []
    for lo in range(0, L, chunk):
        sl = slice(lo, lo + chunk)
        args = (c_st, n_st, q[:, sl], k[:, sl], v[:, sl], i_gate[:, sl],
                f_gate[:, sl])
        if torch.is_grad_enabled():
            c_st, n_st, y = checkpoint(_mlstm_chunk, *args,
                                       use_reentrant=False)
        else:
            c_st, n_st, y = _mlstm_chunk(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = rms_norm(y, params["mlstm.out_norm"], cfg.rms_eps)
    out = dense(y.reshape(b, L, di), params["mlstm.w_o"])
    if return_state:
        return out, (c_st, n_st)
    return out


def mlstm_decode(params, x, cfg, cache):
    """One-token mLSTM update.  cache: {"c": (B,H,dk,dk), "n": (B,H,dk)},
    replaced whole (the cache passed in is not written)."""
    b, _one_tok, d = x.shape
    nh = cfg.n_heads
    di = cfg.ssm.d_inner(d)
    dk = di // nh
    q = dense(x, params["mlstm.w_q"])[:, 0].reshape(b, nh, dk).float()
    k = (dense(x, params["mlstm.w_k"])[:, 0].reshape(b, nh, dk).float()
         / _sqrt_in(dk, torch.float32))
    v = dense(x, params["mlstm.w_v"])[:, 0].reshape(b, nh, dk).float()
    gates = dense(x, params["mlstm.w_gates"])[:, 0].float()
    i_g = torch.sigmoid(gates[..., :nh])[..., None]
    f_g = torch.sigmoid(gates[..., nh:] + 4.0)[..., None]
    c = cache["c"] * f_g[..., None] + (i_g * k)[..., :, None] * v[..., None, :]
    n = cache["n"] * f_g + i_g * k
    y = torch.einsum("bhk,bhkv->bhv", q, c)
    denom = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)),
                          _one(q))
    y = (y / denom[..., None]).to(x.dtype)
    y = rms_norm(y, params["mlstm.out_norm"], cfg.rms_eps)
    out = dense(y.reshape(b, 1, di), params["mlstm.w_o"])
    return out, {"c": c, "n": n}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_cell(pre, c, n):
    """The gates of one step from their fp32 pre-activations (B, H, 4hd)."""
    i_g, f_g, z_g, o_g = pre.chunk(4, dim=-1)
    i_g = torch.sigmoid(i_g)
    f_g = torch.sigmoid(f_g + 1.0)
    z_g = torch.tanh(z_g)
    o_g = torch.sigmoid(o_g)
    c_new = f_g * c + i_g * z_g
    n_new = f_g * n + i_g
    h_new = o_g * c_new / torch.maximum(n_new, _one(n_new))
    return h_new, c_new, n_new


def slstm_mixer(params, x, cfg, *, state=None, return_state=False):
    """Sequential sLSTM.  x: (B, L, D) -> (B, L, D); state (h, c, n)."""
    b, L, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    x_pre = dense(x, params["slstm.w_x"])              # (B, L, 4D)
    r = params["slstm.r"].float()                      # (H, hd, 4hd)
    if state is None:
        h = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h)
        n = torch.ones_like(h)
    else:
        h, c, n = state
    hs = []
    for t in range(L):
        pre = x_pre[:, t].reshape(b, nh, 4 * hd).float() + torch.einsum(
            "bhk,hkf->bhf", h, r)
        h, c, n = _slstm_cell(pre, c, n)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, L, d).to(x.dtype)
    out = dense(y, params["slstm.w_o"])
    if return_state:
        return out, (h, c, n)
    return out


def slstm_decode(params, x, cfg, cache):
    """One-token sLSTM.  cache: {"h","c","n"} each (B, H, hd), replaced
    whole."""
    b, _one_tok, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    x_pre = dense(x, params["slstm.w_x"])[:, 0]
    rec = torch.einsum("bhk,hkf->bhf", cache["h"],
                       params["slstm.r"].float())
    pre = x_pre.reshape(b, nh, 4 * hd).float() + rec
    h, c, n = _slstm_cell(pre, cache["c"], cache["n"])
    out = dense(h.reshape(b, 1, d).to(x.dtype), params["slstm.w_o"])
    return out, {"h": h, "c": c, "n": n}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _fan_in_tenth(generator, out):
    return fan_in_(generator, out, 0.1)


def mlstm_param_specs(cfg) -> list:
    """``(name, shape, init)`` of one mLSTM mixer, in the reference's
    order."""
    d = cfg.d_model
    di = cfg.ssm.d_inner(d)
    nh = cfg.n_heads
    return [("mlstm.w_q", (d, di), fan_in_),
            ("mlstm.w_k", (d, di), fan_in_),
            ("mlstm.w_v", (d, di), fan_in_),
            ("mlstm.w_gates", (d, 2 * nh), fan_in_),
            ("mlstm.out_norm", (di // nh,), zeros_),
            ("mlstm.w_o", (di, d), fan_in_)]


def slstm_param_specs(cfg) -> list:
    """``(name, shape, init)`` of one sLSTM mixer: the recurrent ``r`` is
    0.1 × fan-in trunc-normal, as in the reference."""
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    return [("slstm.w_x", (d, 4 * d), fan_in_),
            ("slstm.r", (nh, hd, 4 * hd), _fan_in_tenth),
            ("slstm.w_o", (d, d), fan_in_)]


def init_mlstm_params(generator: torch.Generator, cfg,
                      dtype=torch.float32) -> dict:
    return draw_specs(generator, mlstm_param_specs(cfg), dtype)


def init_slstm_params(generator: torch.Generator, cfg,
                      dtype=torch.float32) -> dict:
    return draw_specs(generator, slstm_param_specs(cfg), dtype)
