"""The numbers that decide ``correct``: the port's outputs against the
plain reference's.

Training, over the first steps the set-up drives through the window's own
call (the reference replays them from the same weights and batches):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_norm_gap``: the worst leaf's gap between the norm of the first
  step's gradient as the port's optimizer got it (its first moment after
  one step, over ``1 - beta1``) and the reference's, against the larger
  of the reference's norm of that leaf and of the median leaf;
* ``change_norm_gap``: the same for the norm of each leaf's change over
  the steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off
  alone);
* where the model has expert pages, both gaps again over the leaves
  outside the experts (``dense_grad_gap``, ``dense_change_gap``) and as
  the median over the expert leaves (``expert_grad_gap_median``,
  ``expert_change_gap_median``): a token whose bf16 router logits tie
  with another expert's changes a few experts' gradients outright, so
  the worst expert leaf is a widest gap of the routing, not of the
  arithmetic.

A cell compares the numbers its limits file names; the others are
printed to the log only.

Serving: ``served_logit_gap``, the widest gap by which a served (greedy)
token's reference logit lies below the reference's best at its position.
"""

from __future__ import annotations

import statistics

import torch

QUIET_LEAF = 1e-3


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def loss_gap(got: list[float], want: list[float]) -> float:
    if len(got) != len(want):
        raise ValueError(f"{len(got)} losses against {len(want)}")
    return max(abs(g - w) / abs(w) for g, w in zip(got, want, strict=True))


def leaf_gaps(got: dict, want: dict, leaves=None) -> dict:
    """Each leaf's ``|got - want| / max(want, median want)``."""
    names = list(want) if leaves is None else list(leaves)
    floor = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], floor) for n in names}


def worst(gaps: dict) -> tuple[str, float]:
    name = max(gaps, key=gaps.get)
    return name, gaps[name]


def moving_leaves(ref_grad_norms: dict) -> list[str]:
    median = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items() if g >= QUIET_LEAF * median]


def train_numbers(prog: dict, ref: dict, experts=()) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` and, by leaf name,
    ``grad_norms`` and ``change_norms``; ``experts`` names the expert
    leaves."""
    moving = moving_leaves(ref["grad_norms"])
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moving)
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "grad_norm_gap": max(grad.values()),
           "change_norm_gap": max(change.values())}
    experts = set(experts)
    if experts:
        for name, gaps in (("grad", grad), ("change", change)):
            out[f"dense_{name}_gap"] = max(
                g for n, g in gaps.items() if n not in experts)
            out[f"expert_{name}_gap_median"] = statistics.median(
                g for n, g in gaps.items() if n in experts)
    return out


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf behind each norm gap, for the log."""
    moving = moving_leaves(ref["grad_norms"])
    return {"grad": worst(leaf_gaps(prog["grad_norms"], ref["grad_norms"])),
            "change": worst(leaf_gaps(prog["change_norms"],
                                      ref["change_norms"], moving))}


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
    """(…, vocab) reference logits and (…) served tokens -> the gap of
    each token below its position's best."""
    best = ref_logits.max(dim=-1).values
    chosen = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return best - chosen
