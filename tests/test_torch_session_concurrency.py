"""The reference's ``tests/test_concurrency_fixes.py`` on the port (models
from the port's ``make_offloadable_lm`` on the CPU).

Regression tests for the true positives the concurrency analyzer
(:mod:`tools.analyze`) surfaced in the offload pipeline.

Each test pins one fixed defect: pool-slot leaks on failed read issues
(swapper prefetch, KV window prefetch, KV ensure-page), unguarded
counter/metadata reads torn by worker threads (pool stats, store keys,
I/O ledger, memory tracker), and the optimizer's write-back executor
resurrecting after close.
"""

import threading

import numpy as np
import pytest

from repro_torch.core import (AdamConfig, AdaptiveBufferPool,
                        AlignmentFreeAllocator, DirectNVMeEngine,
                        MemoryTracker, OffloadedAdam, ParameterSwapper,
                        PoolCensus, ShapeClass)
from repro_torch.core.buffer_pool import PoolBuffer
from repro_torch.core.kv_cache import SpillableKVCache
from repro_torch.core.nvme import FilesystemEngine, IOStats


# -- swapper: failed prefetch issue must return the pool slot -----------------

def test_prefetch_releases_slot_when_issue_fails(tmp_store_root, rng):
    """A read_async that raises at issue time leaves nothing owning the
    just-acquired slot; prefetch() must release it (regression: the slot
    was checked out of the pool for the rest of the session) and undo the
    _reading guard count so store writers are not blocked forever."""
    store = DirectNVMeEngine(tmp_store_root, n_devices=1,
                             device_capacity=1 << 22)
    census = PoolCensus((ShapeClass("w", 256 * 4, 2),), inflight_blocks=2)
    alloc = AlignmentFreeAllocator(tracker=MemoryTracker(), component="pool",
                                   backing="numpy")
    pool = AdaptiveBufferPool(census, alloc)
    store.write("t0", rng.standard_normal(256).astype(np.float32))
    swapper = ParameterSwapper(store, pool, class_of={"t0": "w"})

    def broken_read_async(key, out):
        raise IOError("issue failed")

    store.read_async, real = broken_read_async, store.read_async
    try:
        with pytest.raises(IOError, match="issue failed"):
            swapper.prefetch("t0", np.float32, (256,))
    finally:
        store.read_async = real

    # every slot is still acquirable (nothing leaked)...
    bufs = [pool.acquire("w", 256 * 4, timeout=1.0) for _ in range(4)]
    for b in bufs:
        b.release()
    # ...and the stale-read write guard sees no phantom in-flight read
    swapper.assert_not_in_flight("t0")
    ticket = swapper.get("t0", np.float32, (256,))  # retry works
    ticket.release()
    swapper.drain()
    pool.close()
    store.close()


# -- KV cache: failed refill issues must return their slots -------------------

def _kv_fixture(root, resident=2, page_shape=(2, 1, 2, 1, 2), max_seq=4):
    nbytes = int(np.prod(page_shape)) * 4
    census = PoolCensus((ShapeClass("w", 64, per_block=1),),
                        inflight_blocks=1).with_kv(nbytes, resident)
    alloc = AlignmentFreeAllocator(tracker=MemoryTracker(),
                                   component="pinned", backing="numpy")
    pool = AdaptiveBufferPool(census, alloc)
    store = FilesystemEngine(root)
    kv = SpillableKVCache(["a", "b", "c"], page_shape, max_seq, np.float32,
                          pool, store, resident_limit=resident)
    return kv, pool, store


def test_kv_prefetch_window_releases_slot_on_failed_issue(tmp_store_root):
    """prefetch_window's async refill: a read_async raising at issue must
    release the acquired slot and keep the page in _spilled so a later
    sync gather still refills it from SSD (regression: the slot leaked
    and the page was forgotten as spilled)."""
    kv, pool, store = _kv_fixture(tmp_store_root)
    rng = np.random.default_rng(0)
    k = rng.standard_normal((1, 3, 1, 2), dtype=np.float32)
    v = rng.standard_normal((1, 3, 1, 2), dtype=np.float32)
    try:
        kv.write_prefill("a", k, v)      # 2 pages through a 2-slot budget
        kv.write_prefill("b", k, v)      # evicts a's dirty pages to SSD
        assert kv.stats.spills >= 1

        def broken_read_async(key, out):
            raise IOError("refill issue failed")

        store.read_async, real = broken_read_async, store.read_async
        try:
            with pytest.raises(IOError, match="refill issue failed"):
                kv.prefetch_window("a", 3)
        finally:
            store.read_async = real

        # the page survived as spilled: a sync gather refills it exactly
        kg, vg = kv.gather_window("a", 3)
        np.testing.assert_array_equal(kg, k)
        np.testing.assert_array_equal(vg, v)
    finally:
        kv.close()
        pool.close()
        store.close()


def test_kv_ensure_page_releases_slot_when_view_fails(tmp_store_root,
                                                      monkeypatch):
    """ensure_page acquires a slot, then views it; a failure in the view
    itself must release the slot like a failed read does (regression: the
    view ran outside the try, leaking the slot and the _in_transit count,
    which eventually wedged every later ensure in the capacity wait)."""
    kv, pool, store = _kv_fixture(tmp_store_root)
    try:
        real_view = PoolBuffer.view

        def broken_view(self, dtype, shape):
            raise RuntimeError("view blew up")

        monkeypatch.setattr(PoolBuffer, "view", broken_view)
        with pytest.raises(RuntimeError, match="view blew up"):
            kv.ensure_page("a", 0)
        monkeypatch.setattr(PoolBuffer, "view", real_view)

        # slot + transit count came back: the retry and a full-budget
        # walk across other units both succeed without a capacity wait
        kv.ensure_page("a", 0)
        kv.ensure_page("b", 0)
        kv.ensure_page("c", 0)
    finally:
        kv.close()
        pool.close()
        store.close()


# -- pool stats: coherent under concurrent churn ------------------------------

def test_pool_stats_consistent_under_concurrent_churn():
    """stats()/fragmentation() read the peak counters under the pool lock
    (regression: a mid-acquire read paired a bumped in_use with a
    not-yet-bumped peak, reporting peak < live)."""
    census = PoolCensus((ShapeClass("w", 1024, 4),), inflight_blocks=2)
    pool = AdaptiveBufferPool(
        census, AlignmentFreeAllocator(tracker=MemoryTracker(),
                                       component="pool"))
    stop = threading.Event()
    bad: list[dict] = []

    def churn():
        while not stop.is_set():
            bufs = [pool.acquire("w", 1024, timeout=5.0) for _ in range(8)]
            for b in bufs:
                b.release()

    def sample():
        while not stop.is_set():
            s = pool.stats()
            if not (0 <= s["peak_in_use_payload"] <= s["pool_bytes"]
                    and s["peak_in_use_reserved"] >= s["peak_in_use_payload"]
                    and 0.0 <= s["fragmentation"] <= 1.0):
                bad.append(s)

    threads = [threading.Thread(target=churn),
               threading.Thread(target=sample)]
    for t in threads:
        t.start()
    stop_timer = threading.Timer(0.5, stop.set)
    stop_timer.start()
    for t in threads:
        t.join()
    stop_timer.cancel()
    assert not bad, f"torn stats snapshots: {bad[:3]}"
    pool.close()


# -- store metadata: keys() vs concurrent async writes ------------------------

def test_filesystem_keys_during_concurrent_async_writes(tmp_store_root):
    """keys() snapshots _meta under the store lock (regression: dict
    iteration raised 'dictionary changed size during iteration' when a
    checkpoint enumerated keys while write_async completions landed)."""
    store = FilesystemEngine(tmp_store_root, fsync=False)
    data = np.zeros(64, np.float32)
    futures = [store.write_async(f"k{i:04d}", data) for i in range(200)]
    seen = 0
    while any(not f.done() for f in futures):
        seen = max(seen, len(store.keys()))   # must never raise
    for f in futures:
        f.result()
    assert len(store.keys()) == 200
    store.close()


# -- I/O ledger: exact totals from concurrent recorders -----------------------

def test_io_stats_exact_under_concurrent_record():
    """IOStats.record is a lock-guarded read-modify-write (regression:
    concurrent store workers tore the unguarded counters and the ledger
    drifted from the true transferred volume)."""
    stats = IOStats()

    def hammer():
        for _ in range(2000):
            stats.record("w", 3, 0.0)
            stats.record("r", 5, 0.0)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = stats.snapshot()
    assert snap["n_writes"] == 4 * 2000
    assert snap["n_reads"] == 4 * 2000
    assert snap["bytes_written"] == 4 * 2000 * 3
    assert snap["bytes_read"] == 4 * 2000 * 5


# -- optimizer: no write-back executor resurrection after close ---------------

def test_optimizer_close_does_not_resurrect_io_pool(tmp_store_root, rng):
    """After close(), both the arena and the write-back executor must stay
    down: a late commit fails loudly instead of silently recreating a
    thread nobody will ever join (regression: _pool() rebuilt the
    executor after close had shut it down and returned)."""
    eng = DirectNVMeEngine(tmp_store_root, n_devices=1,
                           device_capacity=1 << 22)
    opt = OffloadedAdam(eng, AdamConfig(), tracker=MemoryTracker())
    opt.register("w", rng.standard_normal(64).astype(np.float32))
    opt.begin_step()
    opt.step_subgroup("w", np.zeros(64, np.float32))
    opt.close()
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="closed"):
        opt.issue_subgroup("w")          # arena path refuses
    with pytest.raises(RuntimeError, match="closed"):
        opt._pool()                      # executor path refuses too
    after = {t.name for t in threading.enumerate()}
    assert not [n for n in after - before if n.startswith("offload-optim-io")]
    opt.close()                          # idempotent
    eng.close()


# -- memory tracker: coherent queries under concurrent alloc/free -------------

def test_tracker_queries_consistent_under_concurrent_alloc_free():
    """The tracker's query properties lock (regression: a benchmark
    thread sampling peaks mid-alloc paired one side of the
    requested/allocated update; peak_waste went transiently negative)."""
    t = MemoryTracker()
    stop = threading.Event()
    bad: list[tuple] = []

    def churn():
        while not stop.is_set():
            hs = [t.alloc("c", 100, 160) for _ in range(50)]
            for h in hs:
                t.free(h)

    def sample():
        # peak_waste subtracts two peaks inside ONE lock hold — unlocked
        # it read them apart and went transiently negative.  (Distinct
        # properties are separate lock holds, so only per-read coherence
        # is promised, not cross-property invariants.)
        while not stop.is_set():
            waste = t.peak_waste
            live_r, live_a = t.live_requested, t.live_allocated
            if waste < 0 or live_r < 0 or live_a < 0:
                bad.append((waste, live_r, live_a))

    threads = [threading.Thread(target=churn),
               threading.Thread(target=sample)]
    for th in threads:
        th.start()
    timer = threading.Timer(0.5, stop.set)
    timer.start()
    for th in threads:
        th.join()
    timer.cancel()
    assert not bad, f"torn tracker reads: {bad[:3]}"
    t.assert_quiescent()
