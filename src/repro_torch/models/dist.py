"""Where the model code meets DTensor: the regions sharding propagation
does not carry.

On a mesh (:mod:`repro_torch.launch.sharding`) the parameters, the batch
and the cache are DTensors and most of the model runs through DTensor's
sharding propagation, which inserts the collectives.  A few regions it
cannot carry — ops with no sharding strategy (``searchsorted`` in the MoE
dispatch), indexing and views the recurrent mixers' scans trip over, the
einsums (decomposed, they flatten sharded dims), and the vocab-sharded
embedding lookup and cross-entropy gather, whose masked-partial
placement breaks once the result is resharded or on meta tensors — run
here on local tensors instead:

* :func:`weight` gathers a weight over the batch axes where a layer
  uses it (left to itself, DTensor's propagation may gather the batch
  instead);
* :func:`einsum` and :func:`matmul` contract two DTensors shard by
  shard, with the one-card op on the local shards;
* :func:`write_row` writes a decode step's K/V (or latent) into a
  sequence-sharded cache slice by slice;
* :func:`replicated` runs a function on the full (replicated) values of
  its DTensor arguments, or with ``batch=`` on this rank's batch rows
  and full values of the rest, and wraps its results back as DTensors;
* :func:`embed_rows` looks tokens up in a vocab-sharded table shard by
  shard (a vocab-parallel embedding), :func:`logsumexp_last` reduces
  vocab-sharded logits slice by slice, and :func:`gold_logits` gathers
  each label's logit shard by shard (a vocab-parallel cross-entropy's
  gather): an id outside this rank's slice contributes 0, and the
  partial sums meet in one all-reduce.

A result made from local pieces that still need summing over the vocab's
mesh dims is a ``Partial`` DTensor; its gradient comes back whole to each
piece (DTensor's backward keeps a replicated gradient as it is where the
forward placement was partial), which is the sum's derivative.

On plain tensors each runs the function as it is, so the one-card path
is unchanged bit for bit.  The regions compute what the unsharded model
does: the MoE routing sees every token of the batch (its capacity and
load-balance loss depend on the token count), and a recurrent mixer each
batch row whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._pytree import tree_leaves, tree_map

BATCH_AXES = ("pod", "data")


def mesh_of(*trees):
    """The mesh of the first DTensor among ``trees``, or None."""
    for x in tree_leaves(trees):
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def _plain(x: DTensor) -> tuple[DTensor, list]:
    """``x`` with its partial and strided placements made whole, and its
    placements: each what remains a plain ``Shard`` or ``Replicate``."""
    pl = [p if type(p) in (Shard, Replicate) else Replicate()
          for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x, pl


def weight(w):
    """A weight as a layer uses it: on a mesh, gathered over the batch
    axes (ZeRO-3's per-layer all-gather; its backward reduce-scatters the
    gradient) and left split over "model" as placed, so the product keeps
    the activations' batch sharding instead of gathering the batch."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if names[i] in BATCH_AXES else p
          for i, p in enumerate(w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def whole(x):
    """``x`` with its partial placements summed (or maxed) to whole
    values; anything else as it is.  Before an op that mixes a partial
    result with a sharded one, which DTensor cannot always reconcile."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


def whole_last(x):
    """``x`` gathered along its last dim where it is split there (before
    a ``split`` of that dim into parts of other sizes)."""
    if isinstance(x, DTensor):
        last = x.dim() - 1
        pl = [Replicate() if p.is_shard() and p.dim == last else p
              for p in x.placements]
        if pl != list(x.placements):
            return x.redistribute(x.device_mesh, pl)
    return x


def roll_seq(x, shift: int):
    """``torch.roll(x, shift, dims=1)``: on a DTensor each rank rolls its
    own batch rows whole (``roll`` has no sharding strategy)."""
    return replicated(lambda t: torch.roll(t, shift, dims=1), x, batch=(0,))


def _batch_placements(x: DTensor) -> list:
    """``x``'s Shard(0) on the batch mesh dims, Replicate elsewhere."""
    names = x.device_mesh.mesh_dim_names
    return [p if (names[i] in BATCH_AXES and p == Shard(0)) else Replicate()
            for i, p in enumerate(x.placements)]


def replicated(fn, *args, batch: tuple = ()):
    """``fn(*args)`` with every DTensor argument's local value made whole.

    The arguments at the indices in ``batch`` keep their batch sharding
    (dim 0 over the batch mesh dims) and every result then carries the
    first one's; all other DTensors are gathered to full values, and the
    results are replicated.  Gradients flow through both ways.  Plain
    arguments run ``fn`` unchanged."""
    mesh = mesh_of(args)
    if mesh is None:
        return fn(*args)
    full = [Replicate()] * mesh.ndim
    out_pl = full
    for i in batch:
        if isinstance(args[i], DTensor):
            out_pl = _batch_placements(args[i])
            break
    # a whole value used with this rank's batch rows only has a partial
    # gradient over the batch-sharded mesh dims
    whole_grad = [Partial() if p == Shard(0) else Replicate()
                  for p in out_pl]
    local_args = []
    for i, a in enumerate(args):
        pl, grad = (out_pl, out_pl) if i in batch else (full, whole_grad)

        def local(x, pl=pl, grad=grad):
            if not isinstance(x, DTensor):
                return x
            return x.redistribute(mesh, pl).to_local(grad_placements=grad)
        local_args.append(tree_map(local, a))
    out = fn(*local_args)

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        pl = out_pl if t.dim() else full
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return tree_map(wrap, out)


def split_heads(x, n: int, d: int):
    """``x`` (..., n * d) -> (..., n, d).  A DTensor whose last dim is
    split over more shards than ``n`` divides (8 KV heads over a 16-way
    model axis) is gathered along that dim first: a view cannot unflatten
    an uneven split."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        last = x.dim() - 1
        split = [isinstance(p, Shard) and p.dim == last for p in x.placements]
        if n % math.prod(mesh.size(i) for i, s in enumerate(split) if s):
            x = x.redistribute(mesh, [Replicate() if s else p
                                      for s, p in zip(split, x.placements)])
    return x.reshape(*x.shape[:-1], n, d)


def merge_heads(x):
    """``x`` (..., n, d) -> (..., n * d).  On a DTensor the gradient that
    comes back is first given the forward's placements, so the backward's
    unflatten never meets an uneven model-axis split of the merged dim,
    and the result is contiguous."""
    if isinstance(x, DTensor):
        # only the heads dim may stay split: the merged dim's major part
        last = x.dim() - 1
        pl = [Replicate() if p.is_shard() and (type(p) is not Shard
                                               or p.dim == last) else p
              for p in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    y = x.reshape(*x.shape[:-2], -1)
    if isinstance(y, DTensor):
        # contiguous, so a following matmul folds to one mm as it does on
        # a plain tensor
        y = _global(y.to_local().contiguous(), y.device_mesh,
                    y.placements, y.shape)
    return y


def write_row(cache, new, start):
    """``cache`` with ``new`` (size 1 along dim 1) written at index
    ``start`` (a 1-element int tensor) of dim 1, out of place.  On a
    DTensor cache whose dim 1 (the sequence) is sharded, each rank writes
    into its own slice when the index falls in it, so the cache is never
    gathered; ``new`` takes the cache's placements on the other dims."""
    if not isinstance(cache, DTensor):
        return cache.index_copy(1, start, new)
    mesh, pl = cache.device_mesh, list(cache.placements)
    new_pl = [Replicate() if p == Shard(1) else p for p in pl]
    local_new = _as_dtensor(new, mesh).redistribute(mesh, new_pl).to_local()
    local = cache.to_local()
    if isinstance(start, DTensor):
        start = start.full_tensor()
    rel = start - _offset(cache, pl, 1)
    n = local.shape[1]
    inside = (rel >= 0) & (rel < n)
    idx = rel.clamp(0, n - 1)
    row = torch.where(inside, local_new, local.index_select(1, idx))
    return _global(local.index_copy(1, idx, row), mesh, pl, cache.shape)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` of two operands; on DTensors, shard by
    shard (:func:`_contract`).  (A decomposed einsum flattens sharded
    dims, which DTensor refuses.)"""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.einsum(eq, a, b)
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    return _contract(la, lb, out, a, b,
                     lambda x, y: torch.einsum(eq, x, y))


def matmul(x, w):
    """``torch.matmul(x, w)`` of (..., k) by (k, n); on DTensors, shard by
    shard (:func:`_contract`) through the same local ``matmul``."""
    if not (isinstance(x, DTensor) or isinstance(w, DTensor)):
        return torch.matmul(x, w)
    lx = "abcdefgh"[:x.dim() - 1] + "k"
    return _contract(lx, "kn", lx[:-1] + "n", x, w, torch.matmul)


def _contract(la: str, lb: str, out: str, a, b, local_fn):
    """The product ``local_fn`` computes, letters ``la``, ``lb`` -> ``out``
    as in an einsum, run by each rank on its local shards.  On every mesh
    dim a letter one operand is split on splits the other operand too
    where it has that letter (a local chunk); two operands split on
    different letters gather the smaller one on that mesh dim first.  The
    result is split on the letter where the output keeps it, partial where
    it was summed over; an operand without the letter gets a partial
    gradient there."""
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    ops, pl = zip(*(_plain(_as_dtensor(x, mesh)) for x in (a, b)))
    letters = (la, lb)
    grads = [[], []]
    out_pl = []
    for i in range(mesh.ndim):
        split = [lt[p.dim] if isinstance(p, Shard) else None
                 for lt, p in zip(letters, (pl[0][i], pl[1][i]))]
        if split[0] and split[1] and split[0] != split[1]:
            small = min((0, 1), key=lambda j: ops[j].to_local().numel())
            pl[small][i], split[small] = Replicate(), None
        c = split[0] or split[1]
        for j, lt in enumerate(letters):
            if c is None:
                grads[j].append(Replicate())
            elif c in lt:
                pl[j][i] = Shard(lt.index(c))
                grads[j].append(pl[j][i])
            else:
                grads[j].append(Partial())
        out_pl.append(Replicate() if c is None else
                      Shard(out.index(c)) if c in out else Partial())
    local = [x.redistribute(mesh, p).to_local(grad_placements=g)
             for x, p, g in zip(ops, pl, grads)]
    size = {c: n for lt, x in zip(letters, ops) for c, n in zip(lt, x.shape)}
    return _global(local_fn(*local), mesh, out_pl, [size[c] for c in out])


def _offset(x: DTensor, placements, dim: int) -> int:
    """Where this rank's shard of ``x`` under ``placements`` starts along
    ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, placements)
    return offset[dim]


def _as_dtensor(x, mesh):
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def embed_rows(table, tokens):
    """``F.embedding(tokens, table)``.  On a DTensor table whose vocab dim
    is sharded, each rank looks up the tokens in its own rows (the rest
    count 0) with this rank's batch rows of the tokens and the table's
    columns gathered, and the partial sums meet over the vocab's mesh
    dims: a vocab-parallel embedding."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    tok_pl = _batch_placements(tokens)
    rows = [p == Shard(0) and t == Replicate()
            for p, t in zip(table.placements, tok_pl)]
    tab_pl = [Shard(0) if r else Replicate() for r in rows]
    tab_grad = [Shard(0) if r else Partial() if t == Shard(0) else Replicate()
                for r, t in zip(rows, tok_pl)]
    out_pl = [Partial() if r else t for r, t in zip(rows, tok_pl)]
    tok = tokens.redistribute(mesh, tok_pl).to_local()
    local = table.redistribute(mesh, tab_pl).to_local(
        grad_placements=tab_grad)
    rel = tok - _offset(table, tab_pl, 0)
    n = local.shape[0]
    inside = (rel >= 0) & (rel < n)
    out = F.embedding(rel.clamp(0, n - 1), local)
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    return whole(_global(out, mesh, out_pl, (*tokens.shape, table.shape[1])))


def _global(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` over ``local``, its global strides in
    the local tensor's memory order (a permuted result stays permuted, as
    the one-card op's does)."""
    order = sorted(range(local.dim()), key=lambda d: local.stride(d),
                   reverse=True)
    stride, acc = [0] * local.dim(), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def logsumexp_last(x):
    """``torch.logsumexp(x, -1)``.  On a DTensor whose last dim is
    sharded, each rank reduces its own slice and the per-slice results
    (one value a row and shard) meet in a second logsumexp: what moves is
    (..., shards), never the row.  One shard gives ``x``'s own
    ``logsumexp`` exactly."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, -1)
    mesh = x.device_mesh
    x, pl = _plain(x)
    last = x.dim() - 1
    split = [isinstance(p, Shard) and p.dim == last for p in pl]
    n = math.prod(mesh.size(i) for i, s in enumerate(split) if s)
    part = torch.logsumexp(x.to_local(), -1)[..., None]
    parts = _global(part, mesh, pl, (*x.shape[:-1], n))
    whole = [Replicate() if s else p for s, p in zip(split, pl)]
    return torch.logsumexp(parts.redistribute(mesh, whole), -1)


def gold_logits(logits, labels):
    """``logits[..., labels]``: (..., V) and (...) integer -> (...).  On a
    DTensor whose vocab dim is sharded, each rank gathers the labels in
    its own slice and the rest count 0, summed over the vocab's mesh
    dims."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None]).squeeze(-1)
    mesh = logits.device_mesh
    logits, pl = _plain(logits)
    last = logits.dim() - 1
    vocab = [isinstance(p, Shard) and p.dim == last for p in pl]
    lab_pl = [Replicate() if v else p for v, p in zip(vocab, pl)]
    out_pl = [Partial() if v else p for v, p in zip(vocab, pl)]
    labels = _as_dtensor(labels, mesh)
    lab = labels.redistribute(mesh, lab_pl).to_local()
    local = logits.to_local()
    n = local.shape[-1]
    rel = lab - _offset(logits, pl, last)
    inside = (rel >= 0) & (rel < n)
    g = torch.gather(local, -1, rel.clamp(0, n - 1)[..., None]).squeeze(-1)
    g = torch.where(inside, g, torch.zeros_like(g))
    return _global(g, mesh, out_pl, labels.shape)
