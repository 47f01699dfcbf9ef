"""The port's lock-order witness (:mod:`repro_torch.core.lock_witness`,
a copy of the reference's): the reference's eight cases — the acquisition
graph, cycle detection, Condition compatibility, the install/uninstall
swap — the last over the port's own offload stack."""

import threading

import numpy as np
import pytest

from repro_torch.core import lock_witness
from repro_torch.core.lock_witness import LockOrderError, WitnessLock


@pytest.fixture(autouse=True)
def fresh_graph():
    """The witness graph is process-global; isolate each test."""
    lock_witness.reset()
    yield
    lock_witness.reset()


def test_ab_ba_inversion_is_a_cycle():
    """The classic deadlock shape MUST be flagged: path 1 takes A then B,
    path 2 takes B then A.  Each path alone ran fine — the witness exists
    precisely because the unlucky interleaving may never occur in CI."""
    a = WitnessLock("siteA")
    b = WitnessLock("siteB")
    with a, b:
        pass
    lock_witness.check()          # A -> B alone is acyclic
    with b, a:
        pass
    with pytest.raises(LockOrderError, match="siteA|siteB"):
        lock_witness.check()


def test_consistent_nesting_across_threads_is_clean():
    a = WitnessLock("outer")
    b = WitnessLock("inner")

    def worker():
        for _ in range(10):
            with a, b:
                pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert lock_witness.edges() == {"outer": {"inner"}}
    lock_witness.check()


def test_three_lock_cycle_detected():
    """Inversions need not be pairwise: A->B, B->C, C->A deadlocks three
    threads with no two of them in direct opposition."""
    a, b, c = WitnessLock("sA"), WitnessLock("sB"), WitnessLock("sC")
    for first, second in ((a, b), (b, c), (c, a)):
        with first, second:
            pass
    with pytest.raises(LockOrderError):
        lock_witness.check()


def test_same_site_nesting_is_ignored():
    """Two locks from one creation site (a per-instance lock of the same
    class, or ``[Lock() for ...]``) are one node: ordering inside a
    homogeneous group is an instance-level protocol the site-keyed graph
    cannot judge, so it must not false-positive."""
    a = WitnessLock("same")
    b = WitnessLock("same")
    with a, b:
        pass
    with b, a:
        pass
    assert lock_witness.edges() == {}
    lock_witness.check()


def test_non_lifo_release_keeps_stack_straight():
    """The pipeline drops locks mid-scope (kv_cache._spill releases the
    cache lock around its store write): release order is not LIFO, and
    the held-stack bookkeeping must still attribute later acquires to
    the locks actually held."""
    a, b, c = WitnessLock("nlA"), WitnessLock("nlB"), WitnessLock("nlC")
    a.acquire()
    b.acquire()
    a.release()          # out of order: b remains the only held lock
    c.acquire()          # edge must be b -> c, NOT a -> c
    c.release()
    b.release()
    assert lock_witness.edges() == {"nlA": {"nlB"}, "nlB": {"nlC"}}
    lock_witness.check()


def test_condition_over_witness_lock_works():
    """threading.Condition accepts a WitnessLock as its underlying lock
    (the install() swap wraps every Condition this way): wait/notify
    across threads must behave normally and record the cv's site."""
    cv = threading.Condition(WitnessLock("cv-site"))
    ready = []

    def waiter():
        with cv:
            while not ready:
                cv.wait(timeout=5.0)

    t = threading.Thread(target=waiter)
    t.start()
    with cv:
        ready.append(1)
        cv.notify_all()
    t.join(timeout=5.0)
    assert not t.is_alive()
    lock_witness.check()


def test_install_swaps_and_uninstall_restores():
    # under --lock-witness the conftest installed session-wide; start
    # from the uninstalled state either way and restore on the way out
    was_installed = lock_witness.installed()
    if was_installed:
        lock_witness.uninstall()
    try:
        real_lock = threading.Lock
        assert not lock_witness.installed()
        lock_witness.install()
        try:
            assert lock_witness.installed()
            assert isinstance(threading.Lock(), WitnessLock)
            cv = threading.Condition()
            with cv:        # the swapped Condition wraps a WitnessLock
                pass
        finally:
            lock_witness.uninstall()
        assert threading.Lock is real_lock
        assert not isinstance(threading.Lock(), WitnessLock)
    finally:
        if was_installed:
            lock_witness.install()


def test_witnessed_offload_stack_is_cycle_free(tmp_store_root, rng):
    """Run a real slice of the pipeline — pool + swapper + paged KV cache
    with spills — under the witness and require a cycle-free graph.  This
    is the dynamic complement of the static no-blocking-under-lock
    checker, over the port's pool, swapper and KV cache."""
    was_installed = lock_witness.installed()  # no-op under --lock-witness
    lock_witness.install()
    try:
        from repro_torch.core import (AdaptiveBufferPool,
                                      AlignmentFreeAllocator, MemoryTracker,
                                      ParameterSwapper, PoolCensus,
                                      ShapeClass)
        from repro_torch.core.kv_cache import SpillableKVCache
        from repro_torch.core.nvme import FilesystemEngine

        page_shape = (2, 1, 2, 1, 2)
        nbytes = int(np.prod(page_shape)) * 4
        census = PoolCensus((ShapeClass("w", 256 * 4, 2),),
                            inflight_blocks=2).with_kv(nbytes, 2)
        pool = AdaptiveBufferPool(
            census, AlignmentFreeAllocator(tracker=MemoryTracker(),
                                           component="pinned",
                                           backing="numpy"))
        store = FilesystemEngine(tmp_store_root)
        swapper = ParameterSwapper(store, pool, class_of={"t0": "w"})
        store.write("t0", rng.standard_normal(256).astype(np.float32))
        kv = SpillableKVCache(["a", "b", "c"], page_shape, 4, np.float32,
                              pool, store, resident_limit=2)
        try:
            k = rng.standard_normal((1, 3, 1, 2), dtype=np.float32)
            swapper.prefetch("t0", np.float32, (256,))
            kv.write_prefill("a", k, k)       # spills through the budget
            kv.write_prefill("b", k, k)
            kv.prefetch_window("a", 3)        # async refill
            kv.gather_window("a", 3)          # waits it out under pins
            swapper.get("t0", np.float32, (256,)).release()
        finally:
            kv.close()
            swapper.drain()
            pool.close()
            store.close()
        assert lock_witness.edges()           # the run recorded something
        lock_witness.check()
    finally:
        if not was_installed:
            lock_witness.uninstall()
