"""Mixture-of-Experts FFN with sort-based capacity dispatch, on torch.

Port of ``src/repro/models/moe.py``: softmax-then-top-k routing with the
Switch-style auxiliary load-balance loss (or, for ``MoEConfig.scoring ==
"sigmoid"``, DeepSeek-V3's gate, which the JAX package has not:
:func:`router_sigmoid`), a sort + scatter dispatch into
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
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from .dist import (BATCH_AXES, _batch_placements, _global, mesh_of,
                   replicated, weight)
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


def router_sigmoid(logits: torch.Tensor, bias: torch.Tensor, top_k: int,
                   scale: float):
    """DeepSeek-V3's ``noaux_tc`` gate with one group: scores
    ``sigmoid(logits)`` in fp32, the experts chosen by the top-k of
    ``scores + bias`` (the bias only picks: no gradient reaches it), the
    weights the *unbiased* scores at the chosen experts over their sum
    (+ 1e-20), times ``scale``.

    Returns (weights (T, k) fp32, indices (T, k) int64)."""
    scores = torch.sigmoid(logits.float())
    _, idx = ordered_top_k(scores + bias.detach().float(), top_k)
    return _sigmoid_weights(scores, idx, scale), idx


def _sigmoid_weights(scores, idx, scale: float):
    w = torch.gather(scores, -1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def router_logits(xf: torch.Tensor, params, cfg) -> torch.Tensor:
    """The (T, E) router logits of ``moe_ffn``: in the activations' dtype
    under softmax scoring, in fp32 from fp32 operands under the sigmoid
    gate (as DeepSeek-V3's gate computes them)."""
    if cfg.moe.scoring == "sigmoid":
        return dense(xf.float(), params["moe.w_router"].float())
    return dense(xf, params["moe.w_router"])


def route_top_k(logits: torch.Tensor, params, cfg):
    """(weights (T, k) fp32, indices (T, k), load-balance loss) of the
    configured router; the expert-paging route stage picks with this
    too, so the host's fetch decision is ``moe_ffn``'s choice."""
    e = cfg.moe
    if e.scoring == "sigmoid":
        w, idx = router_sigmoid(logits, params["moe.router_bias"], e.top_k,
                                e.routed_scale)
        return w, idx, torch.zeros((), device=logits.device)
    return router_topk(logits, e.top_k)


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


def _route(logits, params, cfg, idx=None):
    """Routing from the (T, E) router logits: (weights (T, k) fp32, each
    (token, choice)'s expert (T*k,), its rank within that expert (T*k,),
    the load-balance loss).  ``idx`` pins the choice (:func:`moe_ffn`)."""
    t, k = logits.shape[0], cfg.moe.top_k
    if idx is None:
        w, idx, aux = route_top_k(logits, params, cfg)
    elif cfg.moe.scoring == "sigmoid":
        idx = torch.as_tensor(idx, device=logits.device).reshape(t, k).long()
        w = _sigmoid_weights(torch.sigmoid(logits.float()), idx,
                             cfg.moe.routed_scale)
        aux = torch.zeros((), device=logits.device)
    else:
        idx = torch.as_tensor(idx, device=logits.device).reshape(t, k).long()
        probs = torch.softmax(logits.float(), dim=-1)
        w = torch.gather(probs, -1, idx)
        w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)).float()
        aux = _aux_loss(probs, idx, k)
    flat_e = idx.reshape(-1)                                   # (T*k,)
    return w, flat_e, _positions_in_expert(flat_e, t * k), aux


def _capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens."""
    e = cfg.moe
    return int(max(e.top_k * t // e.n_experts * e.capacity_factor, 4))


def moe_ffn(params, x, cfg, idx=None):
    """Routed expert FFN (+ shared experts).  x: (B, S, D) -> (B, S, D).

    params: moe.w_router (D, E), moe.w_gate / moe.w_up (E_held, D, F)
    each, moe.w_down (E_held, F, D) — the experts ``MoEConfig.held``
    names, all E by default; the output is their part of the routed
    result (expert parallelism's share of one chip); optionally moe.shared_gate/up/down; the sigmoid
    gate's moe.router_bias (E,).  Returns
    (out, aux_loss).

    ``idx`` ((T, k) or (B, S, k) integers) pins the expert assignment
    instead of recomputing top-k: the expert-paging path passes the
    routing stage's choice, so the host's fetch decision and the expert
    compute agree by construction.  The weights are re-gathered from the
    softmax (or the sigmoid scores) at those indices, which equals the
    top-k values bit for bit when ``idx`` came from the same logits.

    On DTensors the routing runs on every token of the batch on each
    rank and each rank computes its own block of the expert slots
    (:func:`_moe_ffn_meshed`)."""
    if mesh_of(x) is not None:
        return _moe_ffn_meshed(params, x, cfg, idx)
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = e.top_k
    xf = x.reshape(t, d)

    w, flat_e, pos, aux = _route(router_logits(xf, params, cfg), params,
                                 cfg, idx)
    capacity = _capacity(cfg, t)
    # the held experts [lo, hi) are computed; pairs routed elsewhere are
    # another chip's, neither computed here nor dropped
    lo, hi = e.held_range
    keep = (pos < capacity) & (flat_e >= lo) & (flat_e < hi)
    # row of each (token, choice) in the flat (E_held*C, D) buffers;
    # dropped and unheld pairs go to the scratch row E_held*C, which
    # nothing reads
    scratch = e.n_held * capacity
    row = torch.where(keep, (flat_e - lo) * capacity + pos,
                      torch.full_like(pos, scratch))

    # dispatch: each token's activations repeated for its k choices (an
    # expand, whose backward sums over k without atomics), written into
    # the kept rows
    rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    dispatched = x.new_zeros((scratch + 1, d)).index_put(
        (row,), rep)[:scratch].reshape(e.n_held, capacity, d)

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


def _moe_ffn_meshed(params, x, cfg, idx=None):
    """:func:`moe_ffn` on a DTensor ``x``: expert parallel.

    The router logits are computed where the batch lies and gathered; the
    routing then runs on every token of the batch on each rank (the
    capacity, the ranks within an expert and the load-balance loss depend
    on all of them; the dispatch's ``searchsorted`` has no sharding
    strategy).  The (E, C) expert slots are split into blocks: experts
    where the expert stacks are split along their dim 0 (over "model",
    as ``param_specs`` places them), slots over the batch axes.

    * dispatch: each rank writes its own tokens routed to its experts
      into an (E_rank, C, D) buffer, every other row 0; the buffers meet in
      a reduce-scatter over the batch axes onto the slot blocks (each row
      written by one rank);
    * experts: each rank runs its experts' MLPs on its block with its
      shards of the stacks (gathered over the batch axes only, ZeRO-3's
      per-layer gather);
    * combine: the blocks are gathered back over the batch axes, each
      rank weights the rows of its tokens' choices of its experts (0
      elsewhere), and the (B, S, k, D) partial sums meet over "model";
      the k choices are then added in the one-card order.

    Each sum has one non-zero term, so on any mesh every value is the one
    the one-card step computes from the same products."""
    mesh = x.device_mesh
    e = cfg.moe
    if e.held is not None:
        raise NotImplementedError(f"{cfg.name}: the meshed MoE holds every "
                                  f"expert")
    if e.scoring != "softmax":
        raise NotImplementedError(f"{cfg.name}: the meshed MoE routes by "
                                  f"softmax only")
    b, s, d = x.shape
    t, k = b * s, e.top_k
    capacity = _capacity(cfg, t)
    w, flat_e, pos, aux = replicated(
        lambda lg: _route(lg.reshape(t, e.n_experts), params, cfg, idx),
        dense(x, params["moe.w_router"]))

    stacks = [weight(params[n]) for n in
              ("moe.w_gate", "moe.w_up", "moe.w_down")]
    names = mesh.mesh_dim_names
    # per mesh dim: the (E, C) dim it splits, or None
    split = [1 if names[i] in BATCH_AXES else
             0 if all(w_.placements[i] == Shard(0) for w_ in stacks)
             else None for i in range(mesh.ndim)]
    x_pl = _batch_placements(x)                # Shard(0) or Replicate
    rows = [p == Shard(0) for p in x_pl]       # dims whose ranks own rows

    def pl(expert, slot, other):
        return [expert if c == 0 else slot if c == 1 else other
                for c in split]

    def gl(expert, slot, other):
        """Like :func:`pl`, Partial where ranks own different rows."""
        return [Partial() if r and c != 0 else p for r, c, p in
                zip(rows, split, pl(expert, slot, other))]

    experts = pl(Shard(0), Replicate(), Replicate())
    gate_w, up_w, down_w = (
        w_.redistribute(mesh, experts).to_local(
            grad_placements=pl(Shard(0), Partial(), Replicate()))
        for w_ in stacks)
    tok_grad = [Shard(0) if r else Partial() if c == 0 else Replicate()
                for r, c in zip(rows, split)]
    xl = x.redistribute(mesh, x_pl).to_local(grad_placements=tok_grad)
    wl = w.to_local(grad_placements=[
        Partial() if r or c == 0 else Replicate()
        for r, c in zip(rows, split)])
    flat_e, pos = flat_e.to_local(), pos.to_local()

    # this rank's rows of the batch and experts of the stacks
    (bl, *_), (b0, *_) = compute_local_shape_and_global_offset(
        x.shape, mesh, x_pl)
    (ne, _), (e0, _) = compute_local_shape_and_global_offset(
        (e.n_experts, capacity), mesh, experts)
    tl = bl * s
    own = slice(b0 * s * k, (b0 * s + tl) * k)
    fe, ps, wl = flat_e[own], pos[own], wl[b0 * s:b0 * s + tl]
    el = fe - e0
    inside = (ps < capacity) & (el >= 0) & (el < ne)
    scratch = ne * capacity
    row = torch.where(inside, el * capacity + ps,
                      torch.full_like(ps, scratch))

    xf = xl.reshape(tl, d)
    rep = xf[:, None, :].expand(tl, k, d).reshape(tl * k, d)
    buf = xf.new_zeros((scratch + 1, d)).index_put(
        (row,), rep)[:scratch].reshape(ne, capacity, d)
    block = pl(Shard(0), Shard(1), Replicate())
    dispatched = _global(
        buf, mesh, gl(Shard(0), Replicate(), Replicate()),
        (e.n_experts, capacity, d)).redistribute(mesh, block).to_local()
    up = _bmm(dispatched, up_w)
    gate = _bmm(dispatched, gate_w)
    out_e = _bmm(F.silu(gate) * up, down_w)                 # (ne, nc, D)
    out_e = _global(out_e, mesh, block, (e.n_experts, capacity, d)) \
        .redistribute(mesh, experts).to_local(
            grad_placements=gl(Shard(0), Replicate(), Replicate()))

    out_rows = torch.cat([out_e.reshape(scratch, d), xf.new_zeros((1, d))])
    wk = (wl.reshape(-1) * inside).to(x.dtype)
    contrib = (out_rows[row] * wk[:, None]).reshape(bl, s, k, d)
    contrib = _global(contrib, mesh,
                      [Partial() if c == 0 else p
                       for c, p in zip(split, x_pl)],
                      (b, s, k, d)).redistribute(mesh, x_pl)
    y = x.new_zeros((b, s, d))
    for j in range(k):
        y = y + contrib[:, :, j]

    if "moe.shared_up" in params:
        u = dense(x, params["moe.shared_up"])
        g = dense(x, params["moe.shared_gate"])
        y = y + dense(F.silu(g) * u, params["moe.shared_down"])
    return y, aux * e.router_aux_weight
