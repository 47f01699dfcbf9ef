"""The device-resident train step: loss, gradients and the overflow flag.

Port of ``src/repro/train/step.py``.  The step computes what a
ZeRO-Infinity-class system runs on the accelerator — the forward and
backward at bf16 compute with an fp32 loss, loss scaling (the scale is a
runtime value, so the host scaler adapts without a rebuild), and the
overflow screen over every gradient leaf — and leaves the update to the
caller (the launcher's SGD, or a host optimizer).

* :func:`grads_overflow_flag` ORs the screen over the gradient leaves:
  ``"fused"`` runs :func:`repro_torch.kernels.ops.overflow_flag_` into one
  device flag, the hand-written kernel on CUDA tensors and its plain
  version on CPU tensors (the same function as the reference's OR of
  ``fused_overflow_check_jnp``); ``"baseline"`` keeps the chained
  ``isinf(abs) | isnan`` formulation.  On DTensor gradients the screen
  runs on each leaf's local shard into one rank-local flag, and one MAX
  all-reduce over the process group makes it every rank's; no gradient is
  gathered for it.
* :func:`build_train_step` / :func:`build_prefill_step` take an optional
  ``mesh`` (:mod:`repro_torch.launch.mesh`): without one the step runs on
  plain tensors, one card; with one they also return the input and output
  placement trees (the reference's ``in_shardings`` / ``out_shardings``)
  and the step runs on DTensors placed by
  :mod:`repro_torch.launch.sharding` under
  ``implicit_replication()``, so the plain tensors the model builds
  inside (rope tables, masks, positions) join as replicated values.
* :func:`make_act_hint` is the activation-sharding re-assertion the
  model applies after every layer group (``build(..., hint=)``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.kernels import ops
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axis_size, batch_axes
from repro_torch.models.registry import ModelImpl


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def _baseline(g) -> torch.Tensor:
    return torch.isinf(torch.abs(g)).any() | torch.isnan(g).any()


def _mesh_max(flag: torch.Tensor) -> torch.Tensor:
    """MAX of a rank-local flag over the whole process group (the mesh's
    size is the group's: :mod:`repro_torch.launch.mesh` holds it so)."""
    return funcol.wait_tensor(funcol.all_reduce(flag, "max",
                                                dist.group.WORLD))


def grads_overflow_flag(grads, *, kind: str = "fused") -> torch.Tensor:
    """0-dim bool tensor: any Inf/NaN in any gradient leaf.  No sync on
    one card; on DTensor gradients each rank screens its local shards and
    the flags meet in one all-reduce."""
    leaves = tree_leaves(grads)
    meshed = isinstance(leaves[0], DTensor)
    if meshed:
        leaves = [g.to_local() for g in leaves]
    if kind == "fused":
        flag = torch.zeros(1, dtype=torch.int32, device=leaves[0].device)
        for g in leaves:
            ops.overflow_flag_(g.contiguous(), flag)
        if meshed:
            flag = _mesh_max(flag)
        return flag[0].bool()
    if kind == "baseline":
        out = _baseline(leaves[0])
        for g in leaves[1:]:
            out = out | _baseline(g)
        if meshed:
            out = _mesh_max(out.int().reshape(1))[0].bool()
        return out
    raise ValueError(f"overflow check kind must be 'fused' or 'baseline', "
                     f"got {kind!r}")


def make_act_hint(mesh):
    """Activation-sharding re-assertion: a 3-D DTensor activation whose
    batch divides the data-parallel size is redistributed to ``Shard(0)``
    over the batch axes ("pod", "data") and ``Replicate()`` elsewhere;
    anything else passes as it is.  Without it sharding propagation may
    leave full-batch or model-sharded activations between groups."""
    dp = batch_axes(mesh)
    dp_size = axis_size(mesh, *dp)
    target = tuple(Shard(0) if n in dp else Replicate()
                   for n in mesh.mesh_dim_names)

    def hint(x):
        if isinstance(x, DTensor) and x.dim() == 3 and \
                x.shape[0] % dp_size == 0 and x.placements != target:
            return x.redistribute(mesh, target)
        return x

    return hint


def build_train_step(impl: ModelImpl, mesh=None, *, batch_shape=None,
                     check_overflow: bool | str = True):
    """``step(params, batch, loss_scale) -> (loss, grads, overflow)``, or
    with a ``mesh`` ``(step, in_placements, out_placements)``.

    ``loss`` is the unscaled fp32 loss, ``grads`` the gradients of the
    scaled loss in the params' structure, ``overflow`` a 0-dim bool
    tensor.  ``check_overflow``: ``False`` skips the screen;
    ``True``/``"fused"`` runs the kernel's screen; ``"baseline"`` the
    chained formulation.

    With a mesh, ``batch_shape`` (the batch's TensorSpecs) is required;
    ``in_placements`` is ``(param placements, batch placements,
    replicated)`` and ``out_placements`` ``(replicated, param placements,
    replicated)``, one tuple of placements per leaf, from
    :func:`repro_torch.launch.sharding.param_specs` (ZeRO-3) and
    ``batch_specs``.  The meshed step places plain inputs by them, runs
    the model on DTensors (the hint of ``build(..., hint=)`` applies when
    the impl was built with one), returns every gradient in its
    parameter's placements and ``loss`` / ``overflow`` as plain tensors
    equal on every rank.  Without a mesh the step is the one-card step."""
    overflow_kind = "fused" if check_overflow is True else check_overflow

    def screen(grads, device):
        return grads_overflow_flag(grads, kind=overflow_kind) \
            if overflow_kind else torch.zeros((), dtype=torch.bool,
                                              device=device)

    def grad_step(params, batch, loss_scale):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        tracked = tree_map(lambda _p: next(it), params)
        with torch.enable_grad():
            sloss = impl.loss_fn(tracked, batch).float() * loss_scale
            grads = torch.autograd.grad(sloss, leaves, allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        return sloss.detach(), tree_map(lambda _p: next(it), params)

    def step(params, batch, loss_scale):
        sloss, grads = grad_step(params, batch, loss_scale)
        return sloss / loss_scale, grads, screen(grads, sloss.device)

    if mesh is None:
        return step
    if batch_shape is None:
        raise ValueError("batch_shape (TensorSpecs) required with a mesh")
    pplace = shd.param_placements(impl.cfg, mesh)
    bplace = shd.placements_tree(shd.batch_specs(impl.cfg, batch_shape,
                                                 mesh), mesh)
    scalar = shd.replicated(mesh)

    def meshed_step(params, batch, loss_scale):
        params = shd.place(params, pplace, mesh)
        batch = shd.place(batch, bplace, mesh)
        with implicit_replication():
            sloss, grads = grad_step(params, batch, loss_scale)
            # autograd may return a gradient partial (un-reduced) or whole
            # where its parameter is split: the screen reads each gradient
            # as the step returns it, in its parameter's placement
            grads = shd.spec_map(lambda pl, g: shd.as_placed(g, mesh, pl),
                                 pplace, grads)
            overflow = screen(grads, sloss.device)
            loss = shd.as_placed(sloss / loss_scale, mesh,
                                 scalar).to_local()
        return loss, grads, overflow

    return meshed_step, (pplace, bplace, scalar), (scalar, pplace, scalar)


def build_prefill_step(impl: ModelImpl, mesh=None, *, batch_shape=None):
    """``prefill(params, batch) -> logits``: the forward-only logits of
    ``impl.prefill_fn``, with no autograd graph.  With a ``mesh``:
    ``(prefill, (param placements, batch placements), logits
    placements)``, the logits a DTensor placed by
    :func:`repro_torch.launch.sharding.logits_spec`."""

    def prefill(params, batch):
        with torch.no_grad():
            return impl.prefill_fn(params, batch)

    if mesh is None:
        return prefill
    if batch_shape is None:
        raise ValueError("batch_shape (TensorSpecs) required with a mesh")
    pplace = shd.param_placements(impl.cfg, mesh)
    bplace = shd.placements_tree(shd.batch_specs(impl.cfg, batch_shape,
                                                 mesh), mesh)
    gb = tree_leaves(batch_shape)[0].shape[0]
    out = shd.to_placements(shd.logits_spec(impl.cfg, mesh, gb), mesh)

    def meshed_prefill(params, batch):
        params = shd.place(params, pplace, mesh)
        batch = shd.place(batch, bplace, mesh)
        with implicit_replication():
            return shd.as_placed(prefill(params, batch), mesh, out)

    return meshed_prefill, (pplace, bplace), out
