"""The reference's ``tests/test_nvme.py`` on the port: its ``repro``
imports read ``repro_torch``.

Tensor stores: per-tensor-file baseline vs direct-LBA engine (§III-D/IV-E).
"""

import threading

import numpy as np
import ml_dtypes
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st
import torch

from repro_torch.core import DirectNVMeEngine, FilesystemEngine

torch.set_num_threads(2)


def make_engines(root):
    return [
        FilesystemEngine(root + "/fs", fsync=False),
        DirectNVMeEngine(root + "/raw", n_devices=3,
                         device_capacity=1 << 26, min_stripe=1 << 12),
    ]


@pytest.mark.parametrize("engine_idx", [0, 1])
def test_roundtrip_and_update(engine_idx, tmp_store_root, rng):
    st_ = make_engines(tmp_store_root)[engine_idx]
    x = rng.standard_normal((333, 57)).astype(np.float32)
    st_.write("w/a", x)
    assert st_.contains("w/a")
    np.testing.assert_array_equal(st_.read_new("w/a", np.float32, x.shape), x)
    x2 = x * -1
    st_.write("w/a", x2)   # in-place update (same LBA extents)
    np.testing.assert_array_equal(st_.read_new("w/a", np.float32, x.shape), x2)
    st_.close()


@pytest.mark.parametrize("engine_idx", [0, 1])
def test_bfloat16_roundtrip(engine_idx, tmp_store_root, rng):
    st_ = make_engines(tmp_store_root)[engine_idx]
    x = rng.standard_normal(1000).astype(ml_dtypes.bfloat16)
    st_.write("bf", x)
    got = st_.read_new("bf", ml_dtypes.bfloat16, x.shape)
    np.testing.assert_array_equal(got.view(np.uint16), x.view(np.uint16))
    st_.close()


def test_striping_extents_disjoint(tmp_store_root, rng):
    eng = DirectNVMeEngine(tmp_store_root, n_devices=2,
                           device_capacity=1 << 24, min_stripe=1 << 12)
    big = rng.integers(0, 255, size=1 << 20, dtype=np.uint8)
    eng.write("big", big)
    _, _, extents = eng._locations["big"]
    assert len(extents) == 2                      # striped across devices
    assert {e.device for e in extents} == {0, 1}
    # write a second tensor; no overlap on any device
    eng.write("big2", big)
    _, _, e2 = eng._locations["big2"]
    for a in extents:
        for b in e2:
            if a.device == b.device:
                assert a.offset + a.length <= b.offset or \
                    b.offset + b.length <= a.offset
    np.testing.assert_array_equal(eng.read_new("big", np.uint8, big.shape),
                                  big)
    eng.close()


def test_capacity_exhaustion(tmp_store_root):
    eng = DirectNVMeEngine(tmp_store_root, n_devices=1,
                           device_capacity=1 << 16)
    eng.write("a", np.zeros(1 << 14, np.uint8))
    with pytest.raises(IOError, match="full"):
        for i in range(10):
            eng.write(f"b{i}", np.zeros(1 << 14, np.uint8))
    eng.close()


def test_size_change_rejected(tmp_store_root):
    eng = DirectNVMeEngine(tmp_store_root, n_devices=1,
                           device_capacity=1 << 24)
    eng.write("a", np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="size change"):
        eng.write("a", np.zeros(200, np.float32))
    eng.close()


def test_concurrent_distinct_tensors(tmp_store_root, rng):
    eng = DirectNVMeEngine(tmp_store_root, n_devices=2,
                           device_capacity=1 << 26)
    data = {f"t{i}": rng.standard_normal(10_000).astype(np.float32)
            for i in range(8)}
    threads = [threading.Thread(target=eng.write, args=(k, v))
               for k, v in data.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for k, v in data.items():
        np.testing.assert_array_equal(eng.read_new(k, np.float32, v.shape), v)
    eng.close()


def test_async_api(tmp_store_root, rng):
    eng = DirectNVMeEngine(tmp_store_root, n_devices=2,
                           device_capacity=1 << 24)
    x = rng.standard_normal(5000).astype(np.float32)
    eng.write_async("x", x).result()
    out = np.empty_like(x)
    eng.read_async("x", out).result()
    np.testing.assert_array_equal(out, x)
    eng.close()


def test_io_stats_volume(tmp_store_root):
    eng = DirectNVMeEngine(tmp_store_root, n_devices=1,
                           device_capacity=1 << 24)
    x = np.zeros(1000, np.float32)
    eng.write("x", x)
    eng.read_new("x", np.float32, x.shape)
    assert eng.stats.bytes_written == 4000
    assert eng.stats.bytes_read == 4000
    eng.close()


def test_close_shuts_down_async_pool_threads(tmp_store_root, rng):
    """Every engine's lazily-created async executor must die with close():
    the base class owns the shutdown, so a FilesystemEngine (which adds no
    close() of its own) no longer leaks up to 4 '-aio' threads per
    open/close cycle.  (The census itself is conftest.py's autouse
    worker_thread_leak_guard; this test just exercises the cycles.)"""
    x = rng.standard_normal(1000).astype(np.float32)
    for cycle in range(3):
        for eng in make_engines(tmp_store_root + f"/c{cycle}"):
            eng.write_async("t", x).result()     # spin the lazy pool up
            out = np.empty_like(x)
            eng.read_async("t", out).result()
            np.testing.assert_array_equal(out, x)
            eng.close()


def test_async_pool_not_shared_across_instances(tmp_store_root, rng):
    """The executor must be per-instance state, not a mutated class
    attribute: closing one store cannot tear down another's I/O threads."""
    a = FilesystemEngine(tmp_store_root + "/a", fsync=False)
    b = FilesystemEngine(tmp_store_root + "/b", fsync=False)
    x = rng.standard_normal(100).astype(np.float32)
    a.write_async("t", x).result()
    b.write_async("t", x).result()
    assert a._async_pool is not b._async_pool
    a.close()
    out = np.empty_like(x)
    b.read_async("t", out).result()       # b's pool survived a.close()
    np.testing.assert_array_equal(out, x)
    b.close()


def test_concurrent_small_writes_round_robin_no_lost_updates(
        tmp_store_root, rng):
    """Small (sub-min_stripe) tensors placed from concurrent write_async
    workers: the round-robin bump is a read-modify-write that must be
    atomic (lost updates skewed device balance), and every extent must
    stay disjoint per device."""
    eng = DirectNVMeEngine(tmp_store_root, n_devices=3,
                           device_capacity=1 << 24, min_stripe=1 << 20)
    n = 48
    data = {f"t{i}": rng.standard_normal(256).astype(np.float32)
            for i in range(n)}
    futures = [eng.write_async(k, v) for k, v in data.items()]
    for f in futures:
        f.result()
    assert eng._rr == n                  # no lost round-robin increments
    by_dev: dict[int, list] = {}
    for key in data:
        (_, _, extents) = eng._locations[key]
        assert len(extents) == 1         # small tensors never stripe
        by_dev.setdefault(extents[0].device, []).append(extents[0])
    for extents in by_dev.values():
        extents.sort(key=lambda e: e.offset)
        for a, b in zip(extents, extents[1:], strict=False):
            assert a.offset + a.length <= b.offset
    for k, v in data.items():
        np.testing.assert_array_equal(eng.read_new(k, np.float32, v.shape), v)
    eng.close()


def test_short_read_raises_descriptive_ioerror(tmp_store_root):
    """A truncated region read must fail as IOError naming the device and
    offset, not as an opaque ValueError from the stripe-buffer assignment."""
    cap = 1 << 16
    eng = DirectNVMeEngine(tmp_store_root, n_devices=1, device_capacity=cap)
    x = np.zeros(1000, np.float32)
    eng.write("t", x)
    dtype, shape, extents = eng._locations["t"]
    from repro_torch.core.nvme import Extent
    # point the extent at the very end of the preallocated region: pread
    # comes back short instead of failing outright
    eng._locations["t"] = (dtype, shape,
                           [Extent(0, cap - 64, extents[0].length)])
    with pytest.raises(IOError, match="short pread on device 0"):
        eng.read_new("t", np.float32, x.shape)
    eng.close()


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(shape=st.lists(st.integers(min_value=1, max_value=64), min_size=1,
                      max_size=3),
       dtype=st.sampled_from([np.float32, np.float16, np.int32, np.uint8]),
       seed=st.integers(min_value=0, max_value=2**31))
def test_roundtrip_property(tmp_path_factory, shape, dtype, seed):
    root = str(tmp_path_factory.mktemp("prop"))
    eng = DirectNVMeEngine(root, n_devices=2, device_capacity=1 << 22)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 100).astype(dtype)
    eng.write("t", x)
    np.testing.assert_array_equal(eng.read_new("t", dtype, tuple(shape)), x)
    eng.close()


# -- reads land in the caller's buffer (os.preadv, no temporary bytes) --------

@pytest.mark.parametrize("n_devices", [1, 2])
def test_striped_read_fills_out_in_place(tmp_store_root, rng, n_devices):
    """An odd-sized tensor over ``min_stripe`` reads into ``out`` itself:
    the engine returns the caller's array, not a copy, with every byte."""
    eng = DirectNVMeEngine(tmp_store_root, n_devices=n_devices,
                           device_capacity=1 << 24, min_stripe=1 << 20)
    x = rng.integers(0, 256, size=(3 << 20) + 5, dtype=np.uint8)
    eng.write("t", x)
    assert len(eng._locations["t"][2]) == n_devices
    out = np.zeros_like(x)
    assert eng.read("t", out) is out
    np.testing.assert_array_equal(out, x)
    eng.close()


def test_read_allocates_no_stripe_sized_temporary(tmp_store_root, rng):
    """Reading 16 MiB traces under 1 MiB of Python allocations: no stripe
    is read into a fresh ``bytes`` and copied over."""
    import tracemalloc
    eng = DirectNVMeEngine(tmp_store_root, n_devices=2,
                           device_capacity=1 << 25, min_stripe=1 << 20)
    x = rng.integers(0, 256, size=16 << 20, dtype=np.uint8)
    eng.write("t", x)
    out = np.empty_like(x)
    eng.read("t", out)                 # the worker threads are up
    out[:] = 0
    tracemalloc.start()
    try:
        eng.read("t", out)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(out, x)
    assert peak < 1 << 20, peak
    eng.close()


def test_read_resumes_after_partial_preadv(tmp_store_root, rng, monkeypatch):
    """A call that returns fewer bytes than asked is followed by another at
    the advanced offset, so every byte lands however the kernel splits the
    read."""
    import os
    real = os.preadv
    calls = []

    def at_most_4k(fd, buffers, offset):
        calls.append(offset)
        return real(fd, [memoryview(buffers[0])[:4096]], offset)

    eng = DirectNVMeEngine(tmp_store_root, n_devices=2,
                           device_capacity=1 << 22, min_stripe=1 << 12)
    x = rng.integers(0, 256, size=(1 << 16) + 7, dtype=np.uint8)
    eng.write("t", x)
    monkeypatch.setattr(os, "preadv", at_most_4k)
    out = np.zeros_like(x)
    eng.read("t", out)
    np.testing.assert_array_equal(out, x)
    assert len(calls) >= x.nbytes // 4096
    eng.close()


def test_read_into_non_contiguous_out_raises(tmp_store_root, rng):
    """A strided ``out`` would be filled through a copy and come back
    stale, so the engine refuses it."""
    eng = DirectNVMeEngine(tmp_store_root, n_devices=2,
                           device_capacity=1 << 22, min_stripe=1 << 12)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    eng.write("t", x)
    out = np.empty((32, 64), np.float32).T
    assert out.shape == x.shape and not out.flags.c_contiguous
    with pytest.raises(ValueError, match="non-contiguous"):
        eng.read("t", out)
    eng.close()


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(shape=st.lists(st.integers(min_value=1, max_value=64), min_size=1,
                      max_size=3),
       dtype=st.sampled_from([np.float32, np.float16, np.int32, np.uint8,
                              "bf16"]),
       seed=st.integers(min_value=0, max_value=2**31))
def test_port_writes_read_back_by_the_reference_engine(
        tmp_path_factory, shape, dtype, seed):
    """What the port's engine writes, the reference's engine reads back
    byte for byte from the same regions and extents, and so does the
    port's own read.  bf16 is ``uint16`` bits in the port and
    ``ml_dtypes.bfloat16`` in the reference."""
    from repro.core.nvme import DirectNVMeEngine as RefEngine, Extent
    root = str(tmp_path_factory.mktemp("parity"))
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 100).astype(
        ml_dtypes.bfloat16 if dtype == "bf16" else dtype)
    port_x = x.view(np.uint16) if dtype == "bf16" else x
    port = DirectNVMeEngine(root, n_devices=2, device_capacity=1 << 22,
                            min_stripe=1 << 8)
    port.write("t", port_x)
    ref = RefEngine(root, n_devices=2, device_capacity=1 << 22,
                    min_stripe=1 << 8)
    try:
        d, s, extents = port._locations["t"]
        ref._locations["t"] = (d, s, [Extent(e.device, e.offset, e.length)
                                      for e in extents])
        theirs = ref.read_new("t", x.dtype, x.shape)
        ours = port.read_new("t", port_x.dtype, port_x.shape)
        np.testing.assert_array_equal(theirs.view(np.uint8).reshape(-1),
                                      x.view(np.uint8).reshape(-1))
        np.testing.assert_array_equal(ours.view(np.uint8).reshape(-1),
                                      theirs.view(np.uint8).reshape(-1))
    finally:
        ref.close()
        port.close()
