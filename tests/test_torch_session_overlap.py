"""The reference's ``tests/test_overlap_executor.py`` on the port (models
from the port's ``make_offloadable_lm`` on the CPU). The reference's
``_jit_block`` fault hook is the port's ``_block_forward``;
``_h2d_copy`` takes the dtype too.

Full-overlap executor: async H2D staging, async gradient write-back,
in-plan optimizer with cross-step pipelining — equivalence, error paths,
and resource hygiene across the overlap ablation levels."""

import threading

import numpy as np
import pytest

from repro_torch.configs.base import ModelConfig
from repro_torch.core import OffloadPolicy, OffloadSession
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.data import DataLoader, SyntheticTextDataset

CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)


def _model(seed=0):
    return make_offloadable_lm(CFG, seed, device="cpu")


def _batches(n, batch=4, seq=32, seed=1):
    dl = DataLoader(SyntheticTextDataset(vocab=256, seed=seed), batch=batch,
                    seq_len=seq)
    return [dl.next_batch() for _ in range(n)]


def _policy(root, overlap, **adam):
    adam.setdefault("lr", 3e-3)
    return (OffloadPolicy.preset("memascend").with_store(root)
            .with_adam(**adam).with_overlap(overlap).build())


# -- equivalence -------------------------------------------------------------

def test_overlap_modes_loss_bit_identical(tmp_store_root):
    """The same float ops run in the same order in every mode — only the
    thread paying the wait changes.  Losses AND post-run master weights
    must match bit for bit, including across a loss-scale growth step
    (fp16 exercises real unscaling)."""
    bs = _batches(4)
    losses, masters = {}, {}
    for mode in ("sync", "h2d", "full"):
        pol = _policy(tmp_store_root + mode, mode, compute_dtype="float16")
        with OffloadSession(_model(), pol) as s:
            s.scaler.scale = 1024.0
            s.scaler.growth_interval = 2   # growth mid-run: 2x scale jump
            losses[mode] = [s.train_step(b["tokens"], b["labels"])["loss"]
                            for b in bs]
            masters[mode] = s.master_param("embed", "embed")  # synchronizes
        s.tracker.assert_quiescent()
    assert losses["sync"] == losses["h2d"] == losses["full"]
    for mode in ("h2d", "full"):
        np.testing.assert_array_equal(
            masters["sync"].view(np.uint8), masters[mode].view(np.uint8))


def test_full_overlap_runs_pipeline_legs_off_thread(tmp_store_root):
    """The point of the PR: under "full", Adam subgroups and gradient
    scatters execute on their workers, H2D staging serves every FetchOp,
    and no read ever degrades to a synchronous fallback."""
    b = _batches(1)[0]
    with OffloadSession(_model(), _policy(tmp_store_root, "full")) as s:
        optim_threads, writer_threads = set(), set()
        issue_threads, commit_threads = set(), set()
        real_compute = s.optimizer.compute_subgroup
        real_issue = s.optimizer.issue_subgroup
        real_commit = s.optimizer.commit_subgroup_async
        real_write = s._write_grads

        def compute(staged, grad):
            optim_threads.add(threading.current_thread().name)
            return real_compute(staged, grad)

        def issue(key):
            issue_threads.add(threading.current_thread().name)
            return real_issue(key)

        def commit(staged, **kw):
            commit_threads.add(threading.current_thread().name)
            return real_commit(staged, **kw)

        def write(unit, grads, gate=None):
            writer_threads.add(threading.current_thread().name)
            return real_write(unit, grads, gate)

        s.optimizer.compute_subgroup = compute
        s.optimizer.issue_subgroup = issue
        s.optimizer.commit_subgroup_async = commit
        s._write_grads = write
        m = s.train_step(b["tokens"], b["labels"])
        s.synchronize()
        plan = s.plan("train")
        n_fetches = len(plan.fetch_order)
        assert s._ostats.h2d_gets == n_fetches   # every FetchOp was staged
        assert s.swapper.stats.sync_fallbacks == 0
        assert optim_threads == {"offload-optim"}
        # state reads stream on the prefetch worker; write-back batches are
        # submitted by the optimizer worker and drain on the store's pool
        assert issue_threads == {"offload-optim-prefetch"}
        assert commit_threads == {"offload-optim"}
        assert writer_threads == {"offload-gradwrite"}
        assert s.optimizer.staging_idle()
        assert m["applied"]
        # the completed-step I/O ledger lands with synchronize()
        assert s.optimizer.completed_io_bytes > 0
    s.tracker.assert_quiescent()


def test_sync_mode_has_no_pipeline_threads(tmp_store_root):
    b = _batches(1)[0]
    with OffloadSession(_model(), _policy(tmp_store_root, "sync")) as s:
        assert s._h2d is None and s._grad_writer is None \
            and s._optim_worker is None
        m = s.train_step(b["tokens"], b["labels"])
        assert m["optimizer_io_bytes"] > 0   # inline Adam: exact immediately
        assert m["h2d_wait_s"] == 0.0


def test_metrics_report_overlap_counters(tmp_store_root):
    b = _batches(1)[0]
    with OffloadSession(_model(), _policy(tmp_store_root, "full")) as s:
        m = s.train_step(b["tokens"], b["labels"])
    for key in ("fetch_wait_s", "ssd_wait_s", "h2d_wait_s",
                "gradwrite_drain_s", "optim_gate_s"):
        assert m[key] >= 0.0
    assert m["prefetch_hits"] > 0


def test_eval_after_step_sees_updated_weights_under_full_overlap(
        tmp_store_root):
    """The per-unit readiness gate: an eval issued while step k's Adam may
    still be streaming must fetch post-update weights (identical to a
    fully-synchronized session)."""
    bs = _batches(2)
    with OffloadSession(_model(), _policy(tmp_store_root + "f", "full")) as s:
        s.train_step(bs[0]["tokens"], bs[0]["labels"])
        e_full = s.eval_loss(bs[1]["tokens"], bs[1]["labels"])  # no sync
    with OffloadSession(_model(), _policy(tmp_store_root + "s", "sync")) as s:
        s.train_step(bs[0]["tokens"], bs[0]["labels"])
        e_sync = s.eval_loss(bs[1]["tokens"], bs[1]["labels"])
    assert e_full == e_sync


# -- error paths: nothing may leak ------------------------------------------

def test_failed_h2d_releases_every_slot(tmp_store_root):
    """A device_put failure on the staging worker must propagate out of
    the FetchOp wait and leave no pool slot, device slot, or in-flight
    read behind."""
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root, "full"))
    calls = {"n": 0}
    real_copy = s._h2d_copy

    def flaky_copy(view, dtype=None):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected H2D failure")
        return real_copy(view, dtype)

    s._h2d_copy = flaky_copy
    with pytest.raises(RuntimeError, match="injected H2D"):
        s.train_step(b["tokens"], b["labels"])
    assert s.pool.in_use_payload == 0
    assert len(s.swapper._inflight) == 0
    assert s._device_slots.idle()
    s.close()
    s.tracker.assert_quiescent()


def test_writer_thread_exception_surfaces_and_releases(tmp_store_root):
    """A failed D2H scatter on the writer thread surfaces at the overflow
    barrier (the first point the step depends on it) and the abort path
    returns every resource."""
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root, "full"))

    def failing_write(unit, grads, gate=None):
        raise RuntimeError("injected writer failure")

    s._write_grads = failing_write
    with pytest.raises(RuntimeError, match="injected writer"):
        s.train_step(b["tokens"], b["labels"])
    assert s.pool.in_use_payload == 0
    assert len(s.swapper._inflight) == 0
    assert s._device_slots.idle()
    assert s.tracker.component("activation_checkpoints").live_allocated == 0
    s.close()
    s.tracker.assert_quiescent()


def test_optimizer_worker_failure_surfaces_at_synchronize(tmp_store_root):
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root, "full"))

    def failing_compute(staged, grad):
        raise IOError("injected optimizer-store failure")

    s.optimizer.compute_subgroup = failing_compute
    s.train_step(b["tokens"], b["labels"])   # enqueues the doomed stage
    with pytest.raises(IOError, match="injected optimizer"):
        s.synchronize()
    s.close()    # still closes cleanly after the pipeline failure
    s.tracker.assert_quiescent()


def test_optimizer_worker_failure_blocks_next_step_fetch(tmp_store_root):
    """Without an explicit synchronize(), the failure must still surface —
    at the next step's readiness gate, before stale weights are read."""
    bs = _batches(2)
    s = OffloadSession(_model(), _policy(tmp_store_root, "full"))
    real_compute = s.optimizer.compute_subgroup
    fail = {"on": True}

    def flaky_compute(staged, grad):
        if fail["on"]:
            raise IOError("injected optimizer-store failure")
        return real_compute(staged, grad)

    s.optimizer.compute_subgroup = flaky_compute
    s.train_step(bs[0]["tokens"], bs[0]["labels"])
    with pytest.raises(IOError, match="injected optimizer"):
        s.train_step(bs[1]["tokens"], bs[1]["labels"])
    assert s.pool.in_use_payload == 0
    s.close()
    s.tracker.assert_quiescent()


def test_failed_optim_for_late_unit_never_serves_stale_weights(
        tmp_store_root):
    """A failed Adam stage for a unit reached only at an ahead-of-need
    window position must STALL that position (done-with-exception is not
    ready) and surface at the unit's own fetch — not silently serve
    pre-update weights to the next plan (regression: the gate treated any
    done() future as ready)."""
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root, "full"))
    real_compute = s.optimizer.compute_subgroup

    def flaky_compute(staged, grad):
        if staged.key.startswith("head/"):
            raise IOError("injected head-Adam failure")
        return real_compute(staged, grad)

    s.optimizer.compute_subgroup = flaky_compute
    s.train_step(b["tokens"], b["labels"])
    with pytest.raises(IOError, match="injected head-Adam"):
        s.eval_loss(b["tokens"], b["labels"])   # head fetch must deliver it
    assert s.pool.in_use_payload == 0
    s.close()
    s.tracker.assert_quiescent()


def test_failed_claim_mid_unit_releases_earlier_claims(tmp_store_root):
    """A claim that raises partway through a unit's parameters (pool
    timeout, store shutdown) must release the tickets already claimed —
    they left the swapper's in-flight map, so nothing else can."""
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root, "full"))
    calls = {"n": 0}
    real_claim = s.swapper.claim

    def flaky_claim(key, dtype, shape, **kw):
        calls["n"] += 1
        if calls["n"] == 4:      # partway through block_000's params
            raise RuntimeError("injected claim failure")
        return real_claim(key, dtype, shape, **kw)

    s.swapper.claim = flaky_claim
    with pytest.raises(RuntimeError, match="injected claim"):
        s.train_step(b["tokens"], b["labels"])
    assert s.pool.in_use_payload == 0
    assert len(s.swapper._inflight) == 0
    assert s._device_slots.idle()
    s.close()
    s.tracker.assert_quiescent()


def test_error_path_drains_staged_fetches(tmp_store_root):
    """A compute failure with H2D jobs still queued/staged must wait them
    out and return their device slots (regression probe for the abort
    path's FIFO settle)."""
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root, "full"))
    calls = {"n": 0}
    real_block = s._block_forward

    def flaky_block(params, h):
        calls["n"] += 1
        if calls["n"] == 1:      # fail on the first block: embed staged,
            raise RuntimeError("injected block failure")  # blocks in flight
        return real_block(params, h)

    s._block_forward = flaky_block
    with pytest.raises(RuntimeError, match="injected block"):
        s.train_step(b["tokens"], b["labels"])
    assert s.pool.in_use_payload == 0
    assert len(s.swapper._inflight) == 0
    assert s._device_slots.idle()
    s.close()
    s.tracker.assert_quiescent()


# -- thread hygiene ----------------------------------------------------------
# The census assertions live in conftest.py's autouse worker_thread_leak_guard
# fixture now: these tests only need to *exercise* the open/close cycles —
# any leftover "offload-*" / "direct-nvme" / "*-aio" thread fails the guard.

def test_session_cycles_leak_no_threads(tmp_store_root):
    """Open/train/close cycles must return the thread census to baseline:
    the session workers AND the store's I/O pools (the TensorStore
    -aio executor used to outlive close(), 4 threads per cycle)."""
    b = _batches(1)[0]
    for i in range(3):
        with OffloadSession(
                _model(), _policy(f"{tmp_store_root}{i}", "full")) as s:
            s.train_step(b["tokens"], b["labels"])


def test_filesystem_store_session_leaks_no_aio_threads(tmp_store_root):
    """FilesystemEngine-backed sessions exercise the base-class close():
    every read_async spins the lazy -aio pool up; close must take it down."""
    from repro_torch.core import zero_infinity_policy
    b = _batches(1)[0]
    for i in range(2):
        pol = zero_infinity_policy(f"{tmp_store_root}{i}", lr=1e-3)
        with OffloadSession(_model(), pol) as s:
            s.train_step(b["tokens"], b["labels"])
