"""GQA attention (optionally qk-norm) for cached decode on torch tensors.

Port of the GQA half of ``src/repro/models/attention.py``.  Activations are
(batch, seq, ...) as in the reference; weights are plain dicts.

* :func:`gqa_prefill` runs the prompt's causal self-attention through
  :func:`attention_scores`, as the reference's does: the cached prefill
  and the uncached full-prefix pass compute one function, so their greedy
  tokens agree bit for bit.  The hand-written kernel
  (:func:`repro_torch.kernels.ops.swa_attention`, probabilities in fp32)
  is reached at its entry point only, as the reference's Pallas kernel is.
* :func:`gqa_step` is plain torch: no TPU kernel computes it.  It keeps the
  reference's ``chunk`` extent-invariance exactly.
* :func:`gqa_verify` is the speculative-decode window: each position runs
  gqa_step's core at the step's own shapes on the window-merged cache, so
  its output is bitwise K chained steps.
* :func:`gqa_attention` is the full-sequence attention of a training
  block: plain torch through :func:`attention_scores`, differentiated by
  autograd, as the reference's training block runs its plain path (no
  TPU kernel has a backward).
* :func:`attention_scores` is the reference's plain path (probabilities
  cast to q's dtype before the PV product).
"""

from __future__ import annotations

import math

import torch

from .layers import apply_rope, dense, rms_norm, split_positions

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


def gqa_attention(params, x, cfg, *, causal=True, window=None):
    """Full-sequence GQA attention (training), plain torch."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = gqa_project_qkv(params, x, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    w = cfg.sliding_window if window is None else window
    out = attention_scores(q, k, v, causal=causal, window=w)
    return dense(out.reshape(b, s, -1), params["attn.w_o"])


def gqa_prefill(params, x, cfg, *, window=None):
    """Causal prompt attention through :func:`attention_scores` (the
    function :func:`gqa_attention` computes) that also returns the
    pre-repeat K/V to cache.  x may be right-padded past the true prompt length: causal
    masking keeps padded keys out of every valid query's softmax."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = gqa_project_qkv(params, x, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    w = cfg.sliding_window if window is None else window
    out = attention_scores(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                           causal=True, window=w)
    return dense(out.reshape(b, s, -1), params["attn.w_o"]), k, v


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
    cl_col = _cache_len_col(cache_len, x.device)
    q, k_new, v_new = gqa_project_qkv(params, x, cfg, cl_col.expand(b, 1))
    w = cfg.sliding_window if window is None else window
    out = _attend_step(q, k_new, v_new, k_cache, v_cache, cl_col, cfg,
                       chunk=chunk, window=w, dtype=x.dtype)
    return dense(out, params["attn.w_o"]), k_new, v_new


def gqa_verify(params, x, cfg, k_cache, v_cache, cache_len, *, window=None,
               chunk=None):
    """k-query attention for speculative-decode verification.

    x: (B, K, D) — a window of K draft tokens per row, query j at absolute
    position ``cache_len + j``; k_cache/v_cache as :func:`gqa_step` (the
    window's K/V are not in them yet); cache_len: scalar or (B,).  Returns
    (out, k_new, v_new) with k_new/v_new (B, K, KH, D) for the caller to
    append.

    Position j's output is bitwise what K sequential :func:`gqa_step`
    calls would give (append token 0, step token 1, ...), which greedy
    speculative decoding needs to equal plain greedy decoding.  The
    reference's reduction structure is kept — the window's K/V merged onto
    the absolute chunk grid at [cache_len, cache_len + K), query j masked
    to its own prefix ``idx < cache_len + j``, its self term anchoring the
    max, the chunks combined in gqa_step's fixed order — and every
    position runs at the step's own shapes: its q/k/v and output
    projections are (B, 1) products and its attention is gqa_step's core
    on the merged grid.  Batching the K positions into one product would
    let cuBLAS (or the CPU's GEMM) pick another reduction order for the
    larger row count, and the logits would differ in the last bits.
    """
    b, kq, _ = x.shape
    cl_col = _cache_len_col(cache_len, x.device)
    cols = [gqa_project_qkv(params, xj, cfg, (cl_col + j).expand(b, 1))
            for j, xj in enumerate(split_positions(x))]
    k_new = torch.cat([c[1] for c in cols], dim=1)
    v_new = torch.cat([c[2] for c in cols], dim=1)
    w = cfg.sliding_window if window is None else window

    # the window's K/V onto the absolute position grid: position
    # cache_len + r takes window row r, every other position the cache's
    s_bucket = k_cache.shape[1]
    rel = torch.arange(s_bucket, device=x.device)[None, :] - cl_col
    in_win = ((rel >= 0) & (rel < kq)).expand(b, s_bucket)[:, :, None, None]
    gidx = rel.clamp(0, kq - 1).expand(b, s_bucket)[:, :, None, None]
    gidx = gidx.expand(-1, -1, *k_new.shape[2:])
    merged_k = torch.where(in_win, torch.gather(k_new, 1, gidx), k_cache)
    merged_v = torch.where(in_win, torch.gather(v_new, 1, gidx), v_cache)

    outs = []
    for j, (q, kj, vj) in enumerate(cols):
        att = _attend_step(q, kj, vj, merged_k, merged_v, cl_col + j, cfg,
                           chunk=chunk, window=w, dtype=x.dtype)
        outs.append(dense(att, params["attn.w_o"]))
    return torch.cat(outs, dim=1), k_new, v_new


def _cache_len_col(cache_len, device):
    """cache_len as a (1, 1) (scalar) or (B, 1) (per-row) int64 tensor."""
    cl = torch.as_tensor(cache_len, dtype=torch.int64, device=device)
    return cl.reshape(-1, 1)


def _attend_step(q, k_new, v_new, k_cache, v_cache, cl_col, cfg, *, chunk,
                 window, dtype):
    """One query position per row against a cache slice: the attention
    core of :func:`gqa_step` (and of each :func:`gqa_verify` position).

    q: (B, 1, H, D); k_new/v_new: (B, 1, KH, D), the query's own K/V at
    position ``cl_col``; cache positions < ``cl_col`` are valid.  Returns
    the (B, 1, H*D) output before the output projection.  Every operand is
    made contiguous, so equal values give equal bits whatever view they
    came from."""
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    b = q.shape[0]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = math.sqrt(cfg.head_dim)
    s_bucket = k_cache.shape[1]
    c = s_bucket if chunk is None else int(chunk)
    neg = _neg_inf(q.device)

    # per-chunk masked scores on the absolute grid [0, c), [c, 2c), ...
    score_chunks, v_chunks = [], []
    for lo in range(0, s_bucket, c):
        hi = min(lo + c, s_bucket)
        sc = _scores(q, _repeat_kv(k_cache[:, lo:hi].contiguous(),
                                   n_rep)) / scale
        idx = torch.arange(lo, hi, device=q.device)[None, :]
        valid = idx < cl_col                          # (1 or B, hi-lo)
        if window:
            valid = valid & (idx > cl_col - window)
        score_chunks.append(torch.where(valid[:, None, None, :], sc, neg))
        v_chunks.append(_repeat_kv(v_cache[:, lo:hi].contiguous(), n_rep))
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

    out = (torch.exp(s_new - m) / denom).to(dtype) * \
        _repeat_kv(v_new, n_rep).transpose(1, 2)          # (B,H,1,D)
    for sc, vv_c in zip(score_chunks, v_chunks, strict=True):
        p_c = (torch.exp(sc - m) / denom).to(dtype)
        out = out + torch.einsum("bhqk,bkhd->bhqd", p_c, vv_c.to(dtype))
    return out.transpose(1, 2).reshape(b, 1, -1)          # (B,1,H*D)
