"""GQA attention (optionally qk-norm) for cached decode on torch tensors.

Port of the GQA half of ``src/repro/models/attention.py``.  Activations are
(batch, seq, ...) as in the reference; weights are plain dicts.

* :func:`gqa_prefill` runs the prompt's causal self-attention through the
  hand-written kernel (:func:`repro_torch.kernels.ops.swa_attention`): the
  kernel takes (B, H, S, D), so q/k/v pass as transposed views and the
  output comes back in the (B, S, H, D) layout, without copies.
* :func:`gqa_step` is plain torch: no TPU kernel computes it.  It keeps the
  reference's ``chunk`` extent-invariance exactly.
* :func:`attention_scores` is the reference's plain path (probabilities
  cast to q's dtype before the PV product), kept as the comparison for the
  kernel path.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from .layers import apply_rope, dense, rms_norm

NEG_INF = -1e30


def _repeat_kv(k, n_rep: int):
    """(B, S, KH, D) -> (B, S, KH*n_rep, D) for GQA."""
    if n_rep == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(
        b, s, kh * n_rep, d)


def _neg_inf(device):
    return torch.full((), NEG_INF, dtype=torch.float32, device=device)


def _scores(q, k):
    """fp32 (B, H, Sq, Sk) scores of (B, Sq, H, D) x (B, Sk, H, D) — the
    reference's ``preferred_element_type=float32`` einsum."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def attention_scores(q, k, v, *, causal: bool, window: int = 0,
                     q_offset=0):
    """Plain softmax attention over full (or banded) scores.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D); ``q_offset`` is the absolute
    position of q[0]."""
    _b, sq, _h, d = q.shape
    sk = k.shape[1]
    scores = _scores(q, k) / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(mask, scores, _neg_inf(q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


def gqa_project_qkv(params, x, cfg, positions):
    """Project and rope q/k/v.  Returns (q, k, v) with heads unfolded."""
    b, s, _ = x.shape
    q = dense(x, params["attn.w_q"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = dense(x, params["attn.w_k"]).reshape(b, s, cfg.n_kv_heads,
                                             cfg.head_dim)
    v = dense(x, params["attn.w_v"]).reshape(b, s, cfg.n_kv_heads,
                                             cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["attn.q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["attn.k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_prefill(params, x, cfg, *, window=None):
    """Causal prompt attention that also returns the pre-repeat K/V to
    cache.  x may be right-padded past the true prompt length: causal
    masking keeps padded keys out of every valid query's softmax."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = gqa_project_qkv(params, x, cfg, positions)
    w = cfg.sliding_window if window is None else window
    out = ops.swa_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=w, causal=True)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return dense(out, params["attn.w_o"]), k, v


def gqa_step(params, x, cfg, k_cache, v_cache, cache_len, *, window=None,
             chunk=None):
    """One-token attention against a host-fed cache slice.

    x: (B, 1, D); k_cache/v_cache: (B, S_bucket, KH, D) with positions
    < cache_len valid; cache_len: an int tensor, scalar or (B,) per-row.
    Returns (out, k_new, v_new).

    ``chunk`` makes the softmax/PV reductions extent-invariant: the cache
    axis is processed in fixed-size chunks on an absolute position grid and
    the partials combined in a fixed order, so a row's output is bitwise
    identical however far S_bucket extends past its own length.  Masked
    positions score NEG_INF and contribute exactly 0.0 to every partial.
    ``None`` keeps the whole axis as one chunk.
    """
    b = x.shape[0]
    cl = torch.as_tensor(cache_len, dtype=torch.int64, device=x.device)
    cl_col = cl.reshape(-1, 1)        # scalar -> (1,1); per-row -> (B,1)
    positions = cl_col.expand(b, 1)
    q, k_new, v_new = gqa_project_qkv(params, x, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    s_bucket = k_cache.shape[1]
    c = s_bucket if chunk is None else int(chunk)
    w = cfg.sliding_window if window is None else window
    scale = math.sqrt(cfg.head_dim)
    neg = _neg_inf(x.device)

    # per-chunk masked scores on the absolute grid [0, c), [c, 2c), ...
    score_chunks, v_chunks = [], []
    for lo in range(0, s_bucket, c):
        hi = min(lo + c, s_bucket)
        sc = _scores(q, _repeat_kv(k_cache[:, lo:hi], n_rep)) / scale
        idx = torch.arange(lo, hi, device=x.device)[None, :]
        valid = idx < cl_col                          # (1 or B, hi-lo)
        if w:
            valid = valid & (idx > cl_col - w)
        score_chunks.append(torch.where(valid[:, None, None, :], sc, neg))
        v_chunks.append(_repeat_kv(v_cache[:, lo:hi], n_rep))
    # the new token attends to itself (always in window): its score
    # anchors the max, so every row's m is finite
    s_new = _scores(q, _repeat_kv(k_new, n_rep)) / scale

    # two-pass softmax with a fixed combine order
    m = s_new
    for sc in score_chunks:
        m = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
    denom = torch.exp(s_new - m)
    for sc in score_chunks:
        denom = denom + torch.exp(sc - m).sum(dim=-1, keepdim=True)

    out = (torch.exp(s_new - m) / denom).to(x.dtype) * \
        _repeat_kv(v_new, n_rep).transpose(1, 2)          # (B,H,1,D)
    for sc, vv_c in zip(score_chunks, v_chunks, strict=True):
        p_c = (torch.exp(sc - m) / denom).to(x.dtype)
        out = out + torch.einsum("bhqk,bkhd->bhqd", p_c, vv_c.to(x.dtype))
    out = out.transpose(1, 2).reshape(b, 1, -1)           # (B,1,H*D)
    out = dense(out, params["attn.w_o"])
    return out, k_new, v_new
