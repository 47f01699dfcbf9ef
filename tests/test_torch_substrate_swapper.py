"""The reference's ``tests/test_swapper.py`` on the port: its ``repro``
imports read ``repro_torch``.

Parameter swapper: prefetch pipeline over the buffer pool.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (AdaptiveBufferPool, AlignmentFreeAllocator,
                        DirectNVMeEngine, MemoryTracker, ParameterSwapper,
                        PoolCensus, ShapeClass)

torch.set_num_threads(2)


@pytest.fixture
def setup(tmp_store_root, rng):
    store = DirectNVMeEngine(tmp_store_root, n_devices=2,
                             device_capacity=1 << 24)
    census = PoolCensus((ShapeClass("w", 4096 * 4, 2),), inflight_blocks=2)
    alloc = AlignmentFreeAllocator(tracker=MemoryTracker(), component="pool",
                                   backing="numpy")
    pool = AdaptiveBufferPool(census, alloc)
    tensors = {f"t{i}": rng.standard_normal(4096).astype(np.float32)
               for i in range(6)}
    for k, v in tensors.items():
        store.write(k, v)
    swapper = ParameterSwapper(store, pool,
                               class_of={k: "w" for k in tensors})
    yield store, pool, swapper, tensors
    swapper.drain()
    pool.close()
    store.close()


def test_prefetch_then_get(setup):
    store, pool, swapper, tensors = setup
    swapper.prefetch("t0", np.float32, (4096,))
    ticket = swapper.get("t0", np.float32, (4096,))
    np.testing.assert_array_equal(ticket.buf.view(np.float32, (4096,)),
                                  tensors["t0"])
    ticket.release()


def test_get_without_prefetch(setup):
    store, pool, swapper, tensors = setup
    ticket = swapper.get("t3", np.float32, (4096,))
    np.testing.assert_array_equal(ticket.buf.view(np.float32, (4096,)),
                                  tensors["t3"])
    ticket.release()


def test_prefetch_idempotent(setup):
    store, pool, swapper, tensors = setup
    a = swapper.prefetch("t1", np.float32, (4096,))
    b = swapper.prefetch("t1", np.float32, (4096,))
    assert a is b
    t = swapper.get("t1", np.float32, (4096,))
    t.release()


def test_get_releases_slot_when_read_fails(setup):
    """A read that fails after get() popped the ticket is invisible to
    drain(); get() itself must return the pool slot (regression: the slot
    leaked for the session lifetime)."""
    store, pool, swapper, tensors = setup
    with pytest.raises(KeyError, match="not in location"):
        swapper.get("nope", np.float32, (4096,), class_name="w")
    assert pool.in_use_payload == 0


def test_stats_hit_fallback_discrimination(setup):
    """prefetch_hits counts reads already complete at get() time; a get
    with nothing in flight is a sync_fallback — the two must discriminate
    pipelined from synchronous access."""
    store, pool, swapper, tensors = setup
    t = swapper.prefetch("t0", np.float32, (4096,))
    t.future.result()                      # read fully landed before get
    swapper.get("t0", np.float32, (4096,)).release()
    assert swapper.stats.prefetch_hits == 1
    assert swapper.stats.sync_fallbacks == 0
    swapper.get("t1", np.float32, (4096,)).release()   # never prefetched
    assert swapper.stats.prefetch_hits == 1
    assert swapper.stats.sync_fallbacks == 1


def test_claim_split_get_records_stats_from_waiter(setup):
    """The H2D worker's split get: claim() takes ticket ownership without
    blocking; the waiter reports through record_get() and the ledger ends
    identical to a plain get()."""
    store, pool, swapper, tensors = setup
    swapper.prefetch("t2", np.float32, (4096,))
    ticket, hit, fallback = swapper.claim("t2", np.float32, (4096,))
    assert not fallback
    assert not swapper.in_flight("t2")       # ownership moved to the caller
    view = ticket.wait()
    np.testing.assert_array_equal(view, tensors["t2"])
    swapper.record_get(hit=hit, fallback=fallback, wait_seconds=0.25)
    ticket.release()
    st = swapper.stats
    assert st.n_gets == 1 and st.sync_fallbacks == 0
    assert st.wait_seconds == 0.25
    # claim with nothing in flight = the sync-fallback path, same as get()
    ticket, hit, fallback = swapper.claim("t4", np.float32, (4096,))
    assert fallback and not hit
    ticket.wait()
    swapper.record_get(hit=hit, fallback=fallback, wait_seconds=0.0)
    ticket.release()
    assert swapper.stats.sync_fallbacks == 1


def test_drain_releases_all_slots_despite_failed_read(setup):
    """drain() must return every in-flight slot even when one read failed —
    it runs on error paths where stopping early would leak the rest."""
    store, pool, swapper, tensors = setup
    swapper.prefetch("nope", np.float32, (4096,), class_name="w")
    swapper.prefetch("t0", np.float32, (4096,))
    swapper.drain()      # must not raise, must not stop at the failed read
    assert pool.in_use_payload == 0


def test_pipeline_over_all_tensors(setup):
    """Stream 6 tensors through a 4-slot pool with prefetch depth 2."""
    store, pool, swapper, tensors = setup
    keys = list(tensors)
    swapper.prefetch(keys[0], np.float32, (4096,))
    for i, k in enumerate(keys):
        if i + 1 < len(keys):
            swapper.prefetch(keys[i + 1], np.float32, (4096,))
        ticket = swapper.get(k, np.float32, (4096,))
        np.testing.assert_array_equal(
            ticket.buf.view(np.float32, (4096,)), tensors[k])
        ticket.release()
    assert pool.in_use_payload == 0


def test_assert_not_in_flight_guards_store_writers(tmp_store_root, rng):
    """The Adam commit's compute-weight write path uses this guard: a
    write over a key with an unconsumed prefetched read must be refused
    (the pread could race the pwrite and serve half-old bytes)."""
    store = DirectNVMeEngine(tmp_store_root, n_devices=1,
                             device_capacity=1 << 24)
    alloc = AlignmentFreeAllocator(tracker=MemoryTracker(),
                                   component="pool", backing="numpy")
    census = PoolCensus((ShapeClass("w", 1024 * 4, 2),), inflight_blocks=2)
    pool = AdaptiveBufferPool(census, alloc)
    x = rng.standard_normal(1024).astype(np.float32)
    store.write("k", x)
    sw = ParameterSwapper(store, pool, class_of={"k": "w"})
    sw.assert_not_in_flight("k")          # nothing issued: fine
    sw.prefetch("k", np.float32, (1024,))
    with pytest.raises(RuntimeError, match="in flight"):
        sw.assert_not_in_flight("k")
    t = sw.get("k", np.float32, (1024,))  # consume the read
    t.release()
    sw.assert_not_in_flight("k")          # consumed: fine again
    sw.drain()
    pool.close()
    store.close()


def test_write_guard_covers_claimed_but_still_reading_window(
        tmp_store_root, rng):
    """claim() pops the ticket out of _inflight while the pread may still
    be copying — the guard must keep firing until the read future
    completes (it follows the future, not the ticket)."""
    import threading
    store = DirectNVMeEngine(tmp_store_root, n_devices=1,
                             device_capacity=1 << 24)
    alloc = AlignmentFreeAllocator(tracker=MemoryTracker(),
                                   component="pool", backing="numpy")
    census = PoolCensus((ShapeClass("w", 1024 * 4, 2),), inflight_blocks=2)
    pool = AdaptiveBufferPool(census, alloc)
    x = rng.standard_normal(1024).astype(np.float32)
    store.write("k", x)
    sw = ParameterSwapper(store, pool, class_of={"k": "w"})
    release_read = threading.Event()
    real_read = store.read

    def gated_read(key, out):
        release_read.wait(timeout=30)
        return real_read(key, out)

    store.read = gated_read
    ticket, _hit, _fb = sw.claim("k", np.float32, (1024,))
    assert len(sw._inflight) == 0          # claimed: ticket popped
    with pytest.raises(RuntimeError, match="in flight"):
        sw.assert_not_in_flight("k")       # ...but the pread still runs
    release_read.set()
    ticket.wait()
    sw.record_get(hit=False, fallback=True, wait_seconds=0.0)
    sw.assert_not_in_flight("k")           # read complete: write is safe
    ticket.release()
    sw.drain()
    pool.close()
    store.close()
