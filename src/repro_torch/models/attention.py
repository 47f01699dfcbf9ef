"""GQA (optionally qk-norm, sliding-window, bidirectional-prefix) and MLA
attention on torch tensors.

Port of ``src/repro/models/attention.py``.  Activations are (batch, seq,
...) as in the reference; weights are plain dicts.

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
* :func:`gqa_decode` and :func:`mla_decode` are the device-resident
  model's one-token steps against its own cache tree; the cache comes back
  as a new tensor (an out-of-place slot write), never mutated under the
  caller.
* MLA (DeepSeek-V3): :func:`mla_project_q`, :func:`mla_compress_kv` (the
  cached latent), :func:`mla_expand_kv` and :func:`mla_attention`.
* :func:`cross_attention` is whisper's decoder-to-encoder attention.
"""

from __future__ import annotations

import math

import torch

from .dist import (einsum, merge_heads, split_heads, whole, whole_last,
                   write_row)
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
    return einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def attention_scores(q, k, v, *, causal: bool, window: int = 0,
                     q_offset=0, prefix_len: int = 0):
    """Plain softmax attention over full (or banded) scores.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D); ``q_offset`` is the absolute
    position of q[0].  ``prefix_len`` marks a bidirectional prefix
    (PaliGemma): positions < prefix_len attend freely among themselves."""
    _b, sq, _h, d = q.shape
    sk = k.shape[1]
    scores = _scores(q, k) / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
        if prefix_len:
            in_prefix = (q_pos[:, None] < prefix_len) & \
                (k_pos[None, :] < prefix_len)
            mask = mask | in_prefix
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(mask, scores, _neg_inf(q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


def gqa_project_qkv(params, x, cfg, positions):
    """Project and rope q/k/v.  Returns (q, k, v) with heads unfolded."""
    q = split_heads(dense(x, params["attn.w_q"]), cfg.n_heads, cfg.head_dim)
    k = split_heads(dense(x, params["attn.w_k"]), cfg.n_kv_heads,
                    cfg.head_dim)
    v = split_heads(dense(x, params["attn.w_v"]), cfg.n_kv_heads,
                    cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["attn.q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["attn.k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(params, x, cfg, *, causal=True, window=None,
                  prefix_len: int = 0):
    """Full-sequence GQA attention (training), plain torch."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = gqa_project_qkv(params, x, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    w = cfg.sliding_window if window is None else window
    out = attention_scores(q, k, v, causal=causal, window=w,
                           prefix_len=prefix_len)
    return dense(merge_heads(out), params["attn.w_o"])


def _einsum(eq, a, b):
    """``torch.einsum`` with jnp's promotion of mixed float operands."""
    if a.dtype != b.dtype:
        res = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(res), b.to(res)
    return einsum(eq, a, b)


def _write_slot(cache, new, slot):
    """``cache`` with the (B, 1, ...) ``new`` written at position ``slot``
    of axis 1, out of place: ``jax.lax.dynamic_update_slice``, whose start
    is clamped into range."""
    start = torch.clamp(slot, 0, cache.shape[1] - 1).reshape(1)
    return write_row(cache, new.to(cache.dtype), start)


def gqa_decode(params, x, cfg, cache, cache_len):
    """One-token decode against the resident model's KV cache.

    cache: dict(k=(B, S_max, KH, D), v=...); ``cache_len`` (an int or an
    int tensor) counts the tokens already cached; the new token goes to
    slot ``cache_len % S_max`` for sliding-window caches, ``cache_len``
    otherwise.  Attention reads the pre-update cache and merges the new
    token's own term analytically (a two-term softmax), as the reference
    does.  Returns (out, new_cache)."""
    b = x.shape[0]
    cl = torch.as_tensor(cache_len, dtype=torch.int64, device=x.device)
    q, k_new, v_new = gqa_project_qkv(params, x, cfg,
                                      cl.reshape(1, 1).expand(b, 1))
    s_max = cache["k"].shape[1]
    slot = (cl % s_max) if cfg.sliding_window else cl
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = math.sqrt(cfg.head_dim)
    kk = _repeat_kv(cache["k"], n_rep)
    vv = _repeat_kv(cache["v"], n_rep)
    scores = _scores(q, kk) / scale
    # valid old entries: the first min(cache_len, S_max) slots; in a
    # rolling cache the slot about to be overwritten is stale too
    idx = torch.arange(s_max, device=x.device)[None, None, None, :]
    valid = idx < torch.clamp(cl, max=s_max)
    if cfg.sliding_window:
        valid = valid & (idx != slot)
    scores = torch.where(valid, scores, _neg_inf(x.device))

    s_new = (einsum("bqhd,bqhd->bhq", q, _repeat_kv(k_new, n_rep))
             / scale).float()[..., None]
    m = torch.maximum(whole(scores.amax(dim=-1, keepdim=True)), s_new)
    p_old = torch.exp(scores - m)
    p_new = torch.exp(s_new - m)                           # (B,H,1,1)
    denom = whole(p_old.sum(dim=-1, keepdim=True)) + p_new
    out_old = _einsum("bhqk,bkhd->bqhd", (p_old / denom).to(q.dtype), vv)
    w_new = (p_new / denom)[:, :, 0].to(q.dtype)           # (B,H,1)
    out_new = w_new.transpose(1, 2)[..., None] * _repeat_kv(v_new, n_rep)
    out = (whole(out_old) + out_new).to(x.dtype)
    out = dense(merge_heads(out), params["attn.w_o"])
    return out, {"k": _write_slot(cache["k"], k_new, slot),
                 "v": _write_slot(cache["v"], v_new, slot)}


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
    return dense(merge_heads(out), params["attn.w_o"]), k, v


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


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V3 multi-head latent attention
# ---------------------------------------------------------------------------

def mla_project_q(params, x, cfg, positions):
    """Queries through the q latent, or through one ``w_q`` where the
    config has none (``q_lora_rank`` None): (B, S, H, nope + rope), the
    rope half rotated (unless the config has no rope)."""
    m = cfg.mla
    if m.q_lora_rank is None:
        q = dense(x, params["attn.w_q"])
    else:
        q_lat = dense(x, params["attn.w_dq"])                # (B,S,q_rank)
        if "attn.q_lat_norm" in params:
            q_lat = rms_norm(q_lat, params["attn.q_lat_norm"], cfg.rms_eps)
        q = dense(q_lat, params["attn.w_uq"])
    q = split_heads(q, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    if not m.use_rope:
        return q
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                             dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def mla_compress_kv(params, x, cfg, positions):
    """The cached latent: (c_kv (B, S, kv_rank), k_rope (B, S, rope)), the
    one rope head shared by every query head (left unrotated where the
    config has no rope)."""
    m = cfg.mla
    ckv = whole_last(dense(x, params["attn.w_dkv"]))         # (B,S,rank+rope)
    c_kv, k_rope = ckv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    if not m.use_rope:
        return c_kv, k_rope
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_expand_kv(params, c_kv, k_rope, cfg):
    """Per-head K (B, S, H, nope + rope) and V (B, S, H, v) from the
    latent; the shared rope head is broadcast over the heads."""
    m = cfg.mla
    b, s, _ = c_kv.shape
    if "attn.kv_lat_norm" in params:
        c_kv = rms_norm(c_kv, params["attn.kv_lat_norm"], cfg.rms_eps)
    kv = split_heads(dense(c_kv, params["attn.w_ukv"]), cfg.n_heads,
                     m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope_b = k_rope[:, :, None, :].expand(b, s, cfg.n_heads,
                                            m.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def mla_attention(params, x, cfg, *, causal=True, window=None):
    """Full-sequence MLA (training, prefill, the uncached pass)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q = mla_project_q(params, x, cfg, positions)
    c_kv, k_rope = mla_compress_kv(params, x, cfg, positions)
    k, v = mla_expand_kv(params, c_kv, k_rope, cfg)
    w = cfg.sliding_window if window is None else window
    out = attention_scores(q, k, v, causal=causal, window=w)
    return dense(merge_heads(out), params["attn.w_o"])


def mla_decode(params, x, cfg, cache, cache_len):
    """One-token decode with the compressed-latent cache
    ``{"ckv": (B, S_max, kv_rank + rope)}``: the new token's latent is
    written first (out of place), then K/V are expanded from the whole
    cache and the scores (fp32) masked to its first
    ``min(cache_len + 1, S_max)`` slots.  Returns (out, new_cache)."""
    m = cfg.mla
    b = x.shape[0]
    cl = torch.as_tensor(cache_len, dtype=torch.int64, device=x.device)
    positions = cl.reshape(1, 1).expand(b, 1)
    q = mla_project_q(params, x, cfg, positions)
    c_new, krope_new = mla_compress_kv(params, x, cfg, positions)
    s_max = cache["ckv"].shape[1]
    slot = (cl % s_max) if cfg.sliding_window else cl
    ckv = _write_slot(cache["ckv"], torch.cat([c_new, krope_new], dim=-1),
                      slot)
    c_kv, k_rope = ckv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    k, v = mla_expand_kv(params, c_kv, k_rope, cfg)
    scores = _scores(q, k) / math.sqrt(m.qk_nope_head_dim
                                       + m.qk_rope_head_dim)
    valid = torch.arange(s_max, device=x.device)[None, None, None, :] < \
        torch.clamp(cl + 1, max=s_max)
    scores = torch.where(valid, scores, _neg_inf(x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _einsum("bhqk,bkhd->bqhd", probs, v).to(x.dtype)
    out = dense(merge_heads(out), params["attn.w_o"])
    return out, {"ckv": ckv}


def cross_attention(params, x, memory, cfg):
    """Decoder-to-encoder attention (whisper): no rope, no mask.
    x: (B, S, D) queries, memory: (B, S_mem, D) encoder output."""
    q = split_heads(dense(x, params["xattn.w_q"]), cfg.n_heads,
                    cfg.head_dim)
    k = split_heads(dense(memory, params["xattn.w_k"]), cfg.n_kv_heads,
                    cfg.head_dim)
    v = split_heads(dense(memory, params["xattn.w_v"]), cfg.n_kv_heads,
                    cfg.head_dim)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    out = attention_scores(q, k, v, causal=False)
    return dense(merge_heads(out), params["xattn.w_o"])
