"""Mixture-of-Experts FFN with sort-based capacity dispatch, on torch.

Port of ``src/repro/models/moe.py``: softmax-then-top-k routing with the
Switch-style auxiliary load-balance loss, a sort + scatter dispatch into
(E, C, D) expert buffers, the gated expert MLPs batched over the expert
axis, and a weighted combine.  Shared (always-on) experts run densely
beside the routed path.

Where torch's primitives would order ties or sums differently from the
reference, the port fixes the order itself:

* top-k is a stable descending sort: equal probabilities keep the lower
  expert index first, as ``jax.lax.top_k`` does (``torch.topk`` leaves
  their order unspecified);
* ranks within an expert come from a stable ``argsort`` and
  ``searchsorted(side="left")``, as ``jnp.argsort`` (stable) does;
* the dispatch writes only kept (expert, slot) pairs, which are unique;
  dropped pairs land in one scratch row that is never read;
* the combine adds each token's k weighted choices in the order
  j = 0 … k-1 in the activations' dtype (the reference's scatter-add
  order), never through atomics, so a token's output is the same bits
  from run to run and whatever rows of the expert stacks are unrouted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense


def ordered_top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, top_k: int):
    """Switch-style load-balance loss: E * mean_e(frac_tokens_e *
    mean_prob_e) * k, frac_tokens from the chosen indices."""
    n_experts = probs.shape[-1]
    assign = torch.zeros_like(probs).scatter_add_(
        1, idx, torch.ones_like(idx, dtype=probs.dtype)) / top_k
    return n_experts * torch.mean(assign.mean(0) * probs.mean(0)) * top_k


def router_topk(logits: torch.Tensor, top_k: int):
    """Softmax-then-top-k routing.

    Returns (weights (T, k) fp32 normalized over the chosen k, indices
    (T, k) int64, aux load-balance loss)."""
    probs = torch.softmax(logits.float(), dim=-1)                 # (T, E)
    w, idx = ordered_top_k(probs, top_k)                     # (T, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w.float(), idx, _aux_loss(probs, idx, top_k)


def _positions_in_expert(flat_experts: torch.Tensor, n_tokens_k: int):
    """Rank of each (token, choice) within its expert, via a stable sort:
    the first-come position among the entries with the same expert id."""
    order = torch.argsort(flat_experts, stable=True)
    sorted_e = flat_experts[order].contiguous()
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(n_tokens_k, device=flat_experts.device) \
        - run_start
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with :func:`dense`'s dtype rule: equal operands
    stay in their dtype, mixed ones promote and come back as ``a``'s."""
    if a.dtype == b.dtype:
        return torch.bmm(a, b)
    res = torch.promote_types(a.dtype, b.dtype)
    return torch.bmm(a.to(res), b.to(res)).to(a.dtype)


def moe_ffn(params, x, cfg, idx=None):
    """Routed expert FFN (+ shared experts).  x: (B, S, D) -> (B, S, D).

    params: moe.w_router (D, E), moe.w_gate / moe.w_up (E, D, F) each,
    moe.w_down (E, F, D); optionally moe.shared_gate/up/down.  Returns
    (out, aux_loss).

    ``idx`` ((T, k) or (B, S, k) integers) pins the expert assignment
    instead of recomputing top-k: the expert-paging path passes the
    routing stage's choice, so the host's fetch decision and the expert
    compute agree by construction.  The weights are re-gathered from the
    softmax at those indices, which equals the top-k values bit for bit
    when ``idx`` came from the same logits."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = e.top_k
    xf = x.reshape(t, d)

    logits = dense(xf, params["moe.w_router"])
    if idx is None:
        w, idx, aux = router_topk(logits, k)
    else:
        idx = torch.as_tensor(idx, device=x.device).reshape(t, k).long()
        probs = torch.softmax(logits.float(), dim=-1)
        w = torch.gather(probs, -1, idx)
        w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)).float()
        aux = _aux_loss(probs, idx, k)

    capacity = int(max(k * t // e.n_experts * e.capacity_factor, 4))
    flat_e = idx.reshape(-1)                                   # (T*k,)
    pos = _positions_in_expert(flat_e, t * k)                  # (T*k,)
    keep = pos < capacity
    # row of each (token, choice) in the flat (E*C, D) buffers; dropped
    # pairs go to the scratch row E*C, which nothing reads
    scratch = e.n_experts * capacity
    row = torch.where(keep, flat_e * capacity + pos,
                      torch.full_like(pos, scratch))

    # dispatch: each token's activations repeated for its k choices (an
    # expand, whose backward sums over k without atomics), written into
    # the kept rows
    rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    dispatched = x.new_zeros((scratch + 1, d)).index_put(
        (row,), rep)[:scratch].reshape(e.n_experts, capacity, d)

    # expert compute: gated MLP per expert, batched over E
    up = _bmm(dispatched, params["moe.w_up"])
    gate = _bmm(dispatched, params["moe.w_gate"])
    out_e = _bmm(F.silu(gate) * up, params["moe.w_down"])      # (E, C, D)

    # combine: gather each choice's expert output (dropped pairs read a
    # zero row), weight it, and sum the k choices in a fixed order
    out_rows = torch.cat([out_e.reshape(scratch, d), x.new_zeros((1, d))])
    wk = (w.reshape(-1) * keep).to(x.dtype)
    contrib = (out_rows[row] * wk[:, None]).reshape(t, k, d)
    yf = x.new_zeros((t, d))
    for j in range(k):
        yf = yf + contrib[:, j]

    if "moe.shared_up" in params:
        u = dense(xf, params["moe.shared_up"])
        g = dense(xf, params["moe.shared_gate"])
        yf = yf + dense(F.silu(g) * u, params["moe.shared_down"])

    return yf.reshape(b, s, d), aux * e.router_aux_weight
