"""The reference's ``tests/test_stream_plan.py`` on the port: its ``repro``
imports read ``repro_torch``.

StreamPlan IR: compilers produce lifecycle-valid schedules; the
validator rejects anything violating checkout→compute→release (§IV-A).
"""

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (ComputeOp, FetchOp, GradWriteOp, OptimStepOp,
                        OverflowCheckOp, PlanError, ReleaseOp,
                        StreamPlan, compile_decode, compile_eval,
                        compile_train)
from repro_torch.core.model_adapter import make_offloadable_lm

torch.set_num_threads(2)

CFG = ModelConfig(name="tiny", family="dense", n_layers=3, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)


@pytest.fixture(scope="module")
def model():
    return make_offloadable_lm(CFG, 0, device="cpu")


def test_train_plan_structure(model):
    plan = compile_train(model)
    blocks = [f"block_{i:03d}" for i in range(CFG.n_layers)]
    # forward fetch order, then head, then reverse blocks, then embed again
    assert plan.fetch_order == tuple(
        ["embed"] + blocks + ["head"] + blocks[::-1] + ["embed"])
    # every unit's grads are written exactly once
    writes = [op.unit for op in plan.ops if isinstance(op, GradWriteOp)]
    assert sorted(writes) == sorted(["embed", "head"] + blocks)
    # forward blocks checkpoint their inputs; backward blocks restore them
    fwd = [op for op in plan.ops
           if isinstance(op, ComputeOp) and op.kind == "block"]
    bwd = [op for op in plan.ops
           if isinstance(op, ComputeOp) and op.kind == "block_bwd"]
    assert all(op.save_input for op in fwd)
    assert len(fwd) == len(bwd) == CFG.n_layers


def test_eval_and_decode_plans(model):
    ev = compile_eval(model)
    assert ev.fetch_order[0] == "embed" and ev.fetch_order[-1] == "head"
    assert not any(isinstance(op, GradWriteOp) for op in ev.ops)
    assert not any(isinstance(op, ComputeOp) and op.save_input
                   for op in ev.ops)
    dec = compile_decode(model)
    assert dec.fetch_order == ev.fetch_order
    kinds = [op.kind for op in dec.ops if isinstance(op, ComputeOp)]
    assert kinds[-1] == "head_logits"


def test_decode_requires_head_logits(model):
    import dataclasses
    headless = dataclasses.replace(model, head_logits=None)
    with pytest.raises(PlanError, match="head_logits"):
        compile_decode(headless)


def test_validator_compute_before_fetch():
    with pytest.raises(PlanError, match="non-resident"):
        StreamPlan("bad", (ComputeOp("u", "block"),))


def test_validator_double_fetch():
    with pytest.raises(PlanError, match="already-resident"):
        StreamPlan("bad", (FetchOp("u"), FetchOp("u")))


def test_validator_leaked_fetch():
    with pytest.raises(PlanError, match="never released"):
        StreamPlan("bad", (FetchOp("u"),))


def test_validator_release_non_resident():
    with pytest.raises(PlanError, match="release of non-resident"):
        StreamPlan("bad", (ReleaseOp("u"),))


def test_validator_grad_write_without_grads():
    with pytest.raises(PlanError, match="no grads produced"):
        StreamPlan("bad", (FetchOp("u"), ComputeOp("u", "block"),
                           ReleaseOp("u"), GradWriteOp("u")))


def test_validator_bwd_without_checkpoint():
    with pytest.raises(PlanError, match="no saved checkpoint"):
        StreamPlan("bad", (FetchOp("u"), ComputeOp("u", "block_bwd"),
                           ReleaseOp("u"), GradWriteOp("u")))


def test_validator_leaked_checkpoint():
    with pytest.raises(PlanError, match="never restored"):
        StreamPlan("bad", (FetchOp("u"),
                           ComputeOp("u", "block", save_input=True),
                           ReleaseOp("u")))


def test_validator_double_checkpoint():
    with pytest.raises(PlanError, match="already has a saved checkpoint"):
        StreamPlan("bad", (FetchOp("u"),
                           ComputeOp("u", "block", save_input=True),
                           ComputeOp("u", "block", save_input=True),
                           ReleaseOp("u")))


def test_validator_unknown_kind():
    with pytest.raises(PlanError, match="unknown compute kind"):
        StreamPlan("bad", (FetchOp("u"), ComputeOp("u", "frobnicate"),
                           ReleaseOp("u")))


# -- overflow + optimizer ops (the in-plan training tail) --------------------

def _graded_unit(unit="u"):
    """fetch → block_bwd-style grad producer → release → grad write."""
    return (FetchOp(unit), ComputeOp(unit, "head_loss_grad"),
            ReleaseOp(unit), GradWriteOp(unit))


def test_train_plan_has_overflow_then_optim_in_next_fetch_order(model):
    plan = compile_train(model)
    blocks = [f"block_{i:03d}" for i in range(CFG.n_layers)]
    kinds = [type(op).__name__ for op in plan.ops]
    # exactly one overflow check, after every grad write
    assert kinds.count("OverflowCheckOp") == 1
    check_at = kinds.index("OverflowCheckOp")
    assert all(i < check_at for i, op in enumerate(plan.ops)
               if isinstance(op, GradWriteOp))
    # optimizer steps trail it, ordered by the NEXT step's fetch order so
    # cross-step pipelining unblocks the earliest-needed weights first
    optim = [op.unit for op in plan.ops if isinstance(op, OptimStepOp)]
    assert optim == ["embed"] + blocks + ["head"]
    assert all(isinstance(op, OptimStepOp) for op in plan.ops[check_at + 1:])


def test_validator_duplicate_overflow_check():
    with pytest.raises(PlanError, match="duplicate overflow check"):
        StreamPlan("bad", _graded_unit() + (OverflowCheckOp(),
                                            OverflowCheckOp()))


def test_validator_overflow_check_needs_written_grads():
    with pytest.raises(PlanError, match="no grads written"):
        StreamPlan("bad", (OverflowCheckOp(),))


def test_validator_overflow_check_with_unwritten_grads():
    with pytest.raises(PlanError, match="unwritten grads"):
        StreamPlan("bad", _graded_unit("u") + (
            FetchOp("v"), ComputeOp("v", "head_loss_grad"), ReleaseOp("v"),
            OverflowCheckOp(), GradWriteOp("v")))


def test_validator_grad_write_after_overflow_check():
    # (same shape as above but the message for the *write* must also fire
    # when the producer wrote before the check and a second unit after it)
    with pytest.raises(PlanError, match="unwritten grads|after the overflow"):
        StreamPlan("bad", _graded_unit("u")
                   + (FetchOp("v"), ComputeOp("v", "head_loss_grad"),
                      ReleaseOp("v"))
                   + (OverflowCheckOp(), GradWriteOp("v")))


def test_validator_optim_before_overflow_check():
    with pytest.raises(PlanError, match="before the overflow check"):
        StreamPlan("bad", _graded_unit() + (OptimStepOp("u"),))


def test_validator_optim_needs_written_grads():
    with pytest.raises(PlanError, match="no written grads"):
        StreamPlan("bad", _graded_unit("u") + (OverflowCheckOp(),
                                               OptimStepOp("v")))


def test_validator_duplicate_optim_step():
    with pytest.raises(PlanError, match="duplicate optimizer step"):
        StreamPlan("bad", _graded_unit() + (OverflowCheckOp(),
                                            OptimStepOp("u"),
                                            OptimStepOp("u")))


def test_validator_optim_while_resident():
    with pytest.raises(PlanError, match="resident"):
        StreamPlan("bad", _graded_unit("u") + (
            OverflowCheckOp(), FetchOp("u"), OptimStepOp("u"),
            ReleaseOp("u")))


# -- per-region overflow screen (OverflowCheckOp.regions) --------------------

def test_train_plan_screens_every_written_region_in_write_order(model):
    plan = compile_train(model)
    check = next(op for op in plan.ops if isinstance(op, OverflowCheckOp))
    writes = [op.unit for op in plan.ops if isinstance(op, GradWriteOp)]
    assert list(check.regions) == writes
    blocks = [f"block_{i:03d}" for i in range(CFG.n_layers)]
    assert list(check.regions) == ["head"] + blocks[::-1] + ["embed"]


def test_validator_regions_must_match_write_order():
    with pytest.raises(PlanError, match="per-region screen order"):
        StreamPlan("bad", _graded_unit("u") + _graded_unit("v")
                   + (OverflowCheckOp(regions=("v", "u")),))


def test_validator_regions_must_cover_every_written_unit():
    with pytest.raises(PlanError, match="per-region screen order"):
        StreamPlan("bad", _graded_unit("u") + _graded_unit("v")
                   + (OverflowCheckOp(regions=("u",)),))


def test_validator_regions_reject_unwritten_unit():
    with pytest.raises(PlanError, match="per-region screen order"):
        StreamPlan("bad", _graded_unit("u")
                   + (OverflowCheckOp(regions=("u", "ghost")),))


def test_validator_regions_reject_duplicates():
    with pytest.raises(PlanError, match="per-region screen order"):
        StreamPlan("bad", _graded_unit("u") + _graded_unit("v")
                   + (OverflowCheckOp(regions=("u", "u", "v")),))


def test_validator_empty_regions_keep_whole_buffer_scan_valid():
    # the chained-baseline policy's legacy barrier scan: still a valid plan
    plan = StreamPlan("ok", _graded_unit("u") + (OverflowCheckOp(),))
    check = plan.ops[-1]
    assert check.regions == ()
