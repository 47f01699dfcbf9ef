"""The reference's ``tests/test_optim_pipeline.py`` on the port (models
from the port's ``make_offloadable_lm`` on the CPU). The screen hook is
the port's ``_screen_unit_region(unit_name, grads)``.

The pipelined Adam stage: state-prefetch worker, double-buffered staging
arena, per-subgroup overflow screen — fault injection and resource hygiene.

Every failure mode asserted here follows the same contract: the error
surfaces exactly once (at the failed unit's next readiness gate, with
close() clean afterwards), stale compute weights are never served, and
every staged buffer goes back to the arena (tracker balance zero)."""

import threading
import time

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


def _policy(root, overlap="full", **adam):
    adam.setdefault("lr", 3e-3)
    return (OffloadPolicy.preset("memascend").with_store(root)
            .with_adam(**adam).with_overlap(overlap).build())


# -- pipeline topology -------------------------------------------------------

def test_state_prefetch_worker_only_under_full(tmp_store_root):
    with OffloadSession(_model(), _policy(tmp_store_root + "f")) as s:
        assert s.optimizer._prefetch is not None
        assert any(t.name == "offload-optim-prefetch"
                   for t in threading.enumerate())
    with OffloadSession(_model(), _policy(tmp_store_root + "s",
                                          overlap="sync")) as s:
        assert s.optimizer._prefetch is None


@pytest.mark.parametrize("overlap, window", [("full", 2), ("sync", 1)])
def test_pipeline_prefetches_next_subgroup_under_compute(tmp_store_root,
                                                         overlap, window):
    """The point of the stage: while subgroup k computes, subgroup k+1's
    issue is already queued — observed as issues submitted ahead of the
    computes that consume them.  Inline (sync) the stage keeps subgroups
    in series instead: none is issued before the previous one's
    write-backs have landed."""
    b = _batches(1)[0]
    with OffloadSession(_model(), _policy(tmp_store_root, overlap)) as s:
        issues, computes, commits = [], [], []
        real_issue = s.optimizer.issue_subgroup
        real_compute = s.optimizer.compute_subgroup
        real_commit = s.optimizer.commit_subgroup_async

        def issue(key):
            # runs FIFO on the prefetch worker (full) or the executor
            issues.append((key, all(c.done() for c in commits)))
            return real_issue(key)

        def compute(staged, grad):
            # the issue count is the stage thread's state, read here on
            # that same thread: a deterministic probe of the window depth
            computes.append((staged.key, s.optimizer._issued))
            return real_compute(staged, grad)

        def commit(staged, **kw):
            commits.append(real_commit(staged, **kw))
            return commits[-1]

        def slow_write(key, data):
            time.sleep(0.002)         # a write-back still in flight shows
            return real_write(key, data)

        real_write = s.store.write
        s.store.write = slow_write
        s.optimizer.issue_subgroup = issue
        s.optimizer.compute_subgroup = compute
        s.optimizer.commit_subgroup_async = commit
        s.train_step(b["tokens"], b["labels"])
        s.synchronize()
        n_sub = len(s.optimizer.subgroups)
        assert [k for k, _ in issues] == [k for k, _ in computes]
        assert len(issues) == n_sub
        # double buffering: when subgroup k computes, subgroup k+1's issue
        # has already been submitted to the state-prefetch worker; inline
        # only subgroup k has been issued
        for k, (_key, issued_then) in enumerate(computes):
            assert issued_then == min(k + window, n_sub)
        if overlap == "sync":
            assert all(landed for _key, landed in issues)
        assert s.optimizer.staging_idle()
    s.tracker.assert_quiescent()


def test_staging_arena_accounted_and_freed(tmp_store_root):
    """The arena (2 x (3 fp32 + truncation scratch) of the largest
    subgroup) is tracker-charged once, reused across steps, and freed at
    close — no per-step astype transients remain unaccounted."""
    bs = _batches(2)
    s = OffloadSession(_model(), _policy(tmp_store_root))
    for b in bs:
        s.train_step(b["tokens"], b["labels"])
    s.synchronize()
    comp = s.tracker.component("optimizer_stream")
    max_elems = max(m.size for m in s.optimizer.subgroups.values())
    scratch = max_elems * 2        # bf16 compute-weight truncation scratch
    assert comp.peak_allocated == 2 * (3 * max_elems * 4 + scratch)
    assert comp.n_allocs == 1      # one arena, not per-subgroup charges
    assert comp.live_allocated > 0
    s.close()
    assert s.tracker.component("optimizer_stream").live_allocated == 0
    s.tracker.assert_quiescent()


# -- fault injection: state-prefetch reads -----------------------------------

def test_read_failure_mid_prefetch_surfaces_once_and_frees_staging(
        tmp_store_root):
    """A store read that fails mid-prefetch: the failed unit's readiness
    future carries the error, it surfaces at that unit's next fetch gate
    (exactly once — close() stays clean afterwards), and every staged
    buffer returns to the arena."""
    bs = _batches(2)
    s = OffloadSession(_model(), _policy(tmp_store_root))
    real_read = s.store.read

    def flaky_read(key, out):
        if key == "block_001/attn.w_v.m":  # first moment, mid-unit
            raise IOError("injected state-read failure")
        return real_read(key, out)

    s.store.read = flaky_read
    s.train_step(bs[0]["tokens"], bs[0]["labels"])   # enqueues doomed stage
    with pytest.raises(IOError, match="injected state-read"):
        s.train_step(bs[1]["tokens"], bs[1]["labels"])
    assert s.optimizer.staging_idle()      # every fp32 buffer returned
    assert s.pool.in_use_payload == 0
    s.close()                              # error already delivered: clean
    s.tracker.assert_quiescent()


def test_read_failure_never_serves_stale_compute_weights(tmp_store_root):
    """After a failed prefetch the unit's weights on the store are
    pre-update; every later fetch of that unit must keep raising rather
    than silently serving them."""
    bs = _batches(2)
    s = OffloadSession(_model(), _policy(tmp_store_root))
    real_read = s.store.read
    def flaky_read(key, out):
        if key.startswith("head/") and key.endswith(".master"):
            raise IOError("injected state-read failure")
        return real_read(key, out)

    s.store.read = flaky_read
    s.train_step(bs[0]["tokens"], bs[0]["labels"])
    with pytest.raises(IOError, match="injected state-read"):
        s.eval_loss(bs[1]["tokens"], bs[1]["labels"])   # head fetch gates
    with pytest.raises(IOError, match="injected state-read"):
        s.eval_loss(bs[1]["tokens"], bs[1]["labels"])   # still poisoned
    assert s.optimizer.staging_idle()
    s.close()
    s.tracker.assert_quiescent()


# -- fault injection: write-back at commit -----------------------------------

def test_commit_write_failure_surfaces_once_and_frees_staging(
        tmp_store_root):
    """Same contract for the other half: a write-back that fails at commit
    fails the unit's readiness future (which resolves at commit, not at
    compute), surfaces at the unit's next fetch, and releases the buffer."""
    bs = _batches(2)
    s = OffloadSession(_model(), _policy(tmp_store_root))
    real_write = s.store.write

    def flaky_write(key, data):
        if key == "block_000/attn.w_o.v":
            raise IOError("injected write-back failure")
        return real_write(key, data)

    s.store.write = flaky_write
    s.train_step(bs[0]["tokens"], bs[0]["labels"])
    with pytest.raises(IOError, match="injected write-back"):
        s.train_step(bs[1]["tokens"], bs[1]["labels"])
    assert s.optimizer.staging_idle()
    assert s.pool.in_use_payload == 0
    s.close()
    s.tracker.assert_quiescent()


def test_commit_failure_poisons_step_but_not_session_teardown(
        tmp_store_root):
    """Delivery via synchronize() consumes the latched failure; the
    session then closes cleanly with the arena whole."""
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root))
    real_write = s.store.write

    def flaky_write(key, data):
        if key.endswith(".compute") and key.startswith("embed/"):
            raise IOError("injected compute-write failure")
        return real_write(key, data)

    s.store.write = flaky_write
    s.train_step(b["tokens"], b["labels"])
    with pytest.raises(IOError, match="injected compute-write"):
        s.synchronize()
    assert s.optimizer.staging_idle()
    s.close()
    s.tracker.assert_quiescent()


# -- per-subgroup overflow screen --------------------------------------------

def test_overflow_skips_adam_issues_and_leaves_state_untouched(
        tmp_store_root):
    """An overflow verdict (OR of the per-region screens) must skip the
    step before anything reaches the Adam pipeline: zero issues, zero
    staged buffers, masters bit-identical — nothing in flight to corrupt."""
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root,
                                         compute_dtype="float16"))
    before = s.master_param("embed", "embed").copy()
    issues = {"n": 0}
    real_issue = s.optimizer.issue_subgroup

    def counting_issue(key):
        issues["n"] += 1
        return real_issue(key)

    s.optimizer.issue_subgroup = counting_issue
    s.scaler.scale = 2.0 ** 40      # guarantees fp16 grad overflow
    m = s.train_step(b["tokens"], b["labels"])
    s.synchronize()
    assert m["overflowed"] and not m["applied"]
    assert issues["n"] == 0
    assert s.optimizer.staging_idle()
    after = s.master_param("embed", "embed")
    np.testing.assert_array_equal(before.view(np.uint8),
                                  after.view(np.uint8))
    s.close()
    s.tracker.assert_quiescent()


@pytest.mark.parametrize("overlap", ["sync", "full"])
def test_per_region_screen_verdict_matches_scaled_run(tmp_store_root,
                                                      overlap):
    """The per-region screen (inline under sync, writer-thread under full)
    reaches the same verdict in both modes, and a clean step reports no
    overflow."""
    b = _batches(1)[0]
    with OffloadSession(_model(), _policy(tmp_store_root + overlap, overlap,
                                          compute_dtype="float16")) as s:
        s.scaler.scale = 256.0          # modest: no overflow on this model
        m = s.train_step(b["tokens"], b["labels"])
        assert not m["overflowed"] and m["applied"]
        assert m["overflow_screen_s"] >= 0.0
        assert m["optim_prefetch_wait_s"] >= 0.0


def test_screen_runs_on_writer_thread_under_full(tmp_store_root):
    b = _batches(1)[0]
    with OffloadSession(_model(), _policy(tmp_store_root)) as s:
        screen_threads = set()
        real_screen = s._screen_unit_region

        def screen(unit, grads):
            screen_threads.add(threading.current_thread().name)
            return real_screen(unit, grads)

        s._screen_unit_region = screen
        s.train_step(b["tokens"], b["labels"])
        s.synchronize()
        assert screen_threads == {"offload-gradwrite"}


# -- the compute-weight write guard ------------------------------------------

def test_commit_guard_rejects_write_over_inflight_prefetch(tmp_store_root):
    """The stale-read guard on the Adam commit's compute-weight write
    path: refreshing weights whose prefetched read is still outstanding
    must fail loudly instead of racing the pread."""
    b = _batches(1)[0]
    s = OffloadSession(_model(), _policy(tmp_store_root, overlap="sync"))
    s.train_step(b["tokens"], b["labels"])       # materialize grads + state
    cd = s.policy.adam.compute_np_dtype
    shape = s._units["embed"][1]["embed"][0]
    s.swapper.prefetch("embed/embed.compute", cd, shape)
    grad = np.zeros(shape, np.float32)
    s.optimizer.begin_step()
    with pytest.raises(RuntimeError, match="in flight"):
        s.optimizer.step_subgroup("embed/embed", grad)
    assert s.optimizer.staging_idle()            # commit released its buffer
    s.swapper.drain()
    s.close()
    s.tracker.assert_quiescent()
