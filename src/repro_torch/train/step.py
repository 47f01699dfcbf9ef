"""The device-resident train step: loss, gradients and the overflow flag.

Port of ``src/repro/train/step.py`` for one card.  The step computes what
a ZeRO-Infinity-class system runs on the accelerator — the forward and
backward at bf16 compute with an fp32 loss, loss scaling (the scale is a
runtime value, so the host scaler adapts without a rebuild), and the
overflow screen over every gradient leaf — and leaves the update to the
caller (the launcher's SGD, or a host optimizer).

* :func:`grads_overflow_flag` ORs the screen over the gradient leaves:
  ``"fused"`` runs :func:`repro_torch.kernels.ops.overflow_flag_` into one
  device flag, the hand-written kernel on CUDA tensors and its plain
  version on CPU tensors (the same function as the reference's OR of
  ``fused_overflow_check_jnp``); ``"baseline"`` keeps the chained
  ``isinf(abs) | isnan`` formulation.
* :func:`build_prefill_step` is the forward-only logits step (inference
  prefill) over ``ModelImpl.prefill_fn``, which the dry run
  (:mod:`repro_torch.launch.dryrun`) counts at the prefill shapes.
* No counterpart, by decision: ``make_act_hint`` and the shardings the
  reference's builders return: one card has no mesh, as
  ``launch/{mesh,sharding}.py`` have none.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
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


def grads_overflow_flag(grads, *, kind: str = "fused") -> torch.Tensor:
    """0-dim bool tensor: any Inf/NaN in any gradient leaf.  No sync."""
    leaves = tree_leaves(grads)
    if kind == "fused":
        flag = torch.zeros(1, dtype=torch.int32, device=leaves[0].device)
        for g in leaves:
            ops.overflow_flag_(g.contiguous(), flag)
        return flag[0].bool()
    if kind == "baseline":
        out = _baseline(leaves[0])
        for g in leaves[1:]:
            out = out | _baseline(g)
        return out
    raise ValueError(f"overflow check kind must be 'fused' or 'baseline', "
                     f"got {kind!r}")


def build_train_step(impl: ModelImpl, *, check_overflow: bool | str = True):
    """``step(params, batch, loss_scale) -> (loss, grads, overflow)``.

    ``loss`` is the unscaled fp32 loss, ``grads`` the gradients of the
    scaled loss in the params' structure, ``overflow`` a 0-dim bool
    tensor.  ``check_overflow``: ``False`` skips the screen;
    ``True``/``"fused"`` runs the kernel's screen; ``"baseline"`` the
    chained formulation."""
    overflow_kind = "fused" if check_overflow is True else check_overflow

    def step(params, batch, loss_scale):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        tracked = tree_map(lambda _p: next(it), params)
        with torch.enable_grad():
            sloss = impl.loss_fn(tracked, batch).float() * loss_scale
            grads = torch.autograd.grad(sloss, leaves, allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        grads = tree_map(lambda _p: next(it), params)
        overflow = grads_overflow_flag(grads, kind=overflow_kind) \
            if overflow_kind else torch.zeros((), dtype=torch.bool,
                                              device=sloss.device)
        return sloss.detach() / loss_scale, grads, overflow

    return step


def build_prefill_step(impl: ModelImpl):
    """``prefill(params, batch) -> logits``: the forward-only logits of
    ``impl.prefill_fn``, with no autograd graph."""

    def prefill(params, batch):
        with torch.no_grad():
            return impl.prefill_fn(params, batch)

    return prefill
