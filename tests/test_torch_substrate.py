"""The offload substrate, run against both packages' copies.

Each case takes the package under test as a parameter: ``repro`` (the
JAX package's numpy modules) and ``repro_torch`` (the port's copies, with
bf16 host data as uint16 bits).  The same assertions hold for both, so a
drift in a copied module shows up as a failing ``repro_torch`` case.  The
pinned (page-locked) backing of the port's allocators runs on the card:
``tests/test_torch_cuda.py``.
"""

import importlib
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro_torch.configs.base import ModelConfig
from repro_torch.core.model_adapter import from_numpy_units

torch.set_num_threads(2)

PKGS = ["repro", "repro_torch"]
BF16 = {"repro": np.dtype(ml_dtypes.bfloat16), "repro_torch": np.dtype(np.uint16)}


@pytest.fixture(params=PKGS)
def pkg(request):
    """(package name, its ``core`` module)."""
    return request.param, importlib.import_module(f"{request.param}.core")


# -- pinned allocators ----------------------------------------------------------

def test_pow2_rounding_doubles_large_requests(pkg):
    _, core = pkg
    a = core.PowerOfTwoCachingAllocator(tracker=core.MemoryTracker(),
                                        component="p")
    buf = a.alloc(int(2.1 * 2**30))     # the paper's 2.1 GiB -> 4 GiB example
    assert buf.capacity == 4 * 2**30
    buf.free()


def test_alignment_free_wastes_at_most_one_page(pkg):
    _, core = pkg
    a = core.AlignmentFreeAllocator(tracker=core.MemoryTracker(),
                                    component="p")
    for req in (1, 4095, 4096, 4097, int(2.1 * 2**30)):
        buf = a.alloc(req)
        assert buf.capacity - buf.size < core.DMA_ALIGNMENT
        assert buf.capacity % core.DMA_ALIGNMENT == 0
        buf.free()


def test_tracker_accounting_and_double_free(pkg):
    _, core = pkg
    t = core.MemoryTracker()
    a = core.PowerOfTwoCachingAllocator(tracker=t, component="x",
                                        caching=False)
    b1, b2 = a.alloc(1000), a.alloc(3000)
    assert t.live_requested == 4000 and t.live_allocated == 1024 + 4096
    b1.free()
    b2.free()
    t.assert_quiescent()
    with pytest.raises(ValueError, match="double free"):
        b2.free()


@pytest.mark.parametrize("cls", ["PowerOfTwoCachingAllocator",
                                 "AlignmentFreeAllocator"])
def test_numpy_backing_view_roundtrip(pkg, cls):
    _, core = pkg
    a = getattr(core, cls)(tracker=core.MemoryTracker(), component="p",
                           backing="numpy")
    buf = a.alloc(64 * 4)
    v = buf.view(np.float32, (8, 8))
    v[:] = np.arange(64).reshape(8, 8)
    assert v[3, 4] == 28
    buf.free()


def test_port_cuda_backing_needs_a_card():
    from repro_torch.core import AlignmentFreeAllocator, MemoryTracker
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        AlignmentFreeAllocator(tracker=MemoryTracker(), backing="cuda")


# -- buffer pools -----------------------------------------------------------------

def _census(core):
    return core.PoolCensus((
        core.ShapeClass("embed", 1_000_000, 0, 2),
        core.ShapeClass("ffn", 100_000, 3),
        core.ShapeClass("kv", 4_000, 2),
        core.ShapeClass("qo", 40_000, 2),
    ), inflight_blocks=2)


def test_fixed_vs_adaptive_pool_sizing(pkg):
    _, core = pkg
    alloc = core.AlignmentFreeAllocator(tracker=core.MemoryTracker(),
                                        component="pool")
    census = _census(core)
    fixed = core.FixedBufferPool(census, alloc)
    assert fixed.pool_bytes == 1_000_000 * census.total_slots
    assert fixed.acquire("kv", 4_000).capacity == 1_000_000
    adaptive = core.AdaptiveBufferPool(census, alloc)
    assert adaptive.pool_bytes == (2 * 1_000_000 + 6 * 100_000 + 4 * 4_000
                                   + 4 * 40_000)
    buf = adaptive.acquire("kv", 4_000)
    assert buf.capacity == 4_000
    buf.release()
    fixed.close()
    adaptive.close()


def test_blocking_acquire_backpressure(pkg):
    _, core = pkg
    census = core.PoolCensus((core.ShapeClass("ffn", 100, 1),),
                             inflight_blocks=1)
    pool = core.AdaptiveBufferPool(census, core.AlignmentFreeAllocator(
        tracker=core.MemoryTracker(), component="pool"))
    b1 = pool.acquire("ffn", 100)
    releaser = threading.Thread(target=lambda: (time.sleep(0.1),
                                                b1.release()))
    releaser.start()
    b2 = pool.acquire("ffn", 50, timeout=5.0)   # blocks until release
    releaser.join(timeout=5.0)
    assert not releaser.is_alive() and b2.capacity == 100
    b2.release()
    pool.close()


def test_numpy_backed_slots_are_disjoint(pkg):
    _, core = pkg
    alloc = core.AlignmentFreeAllocator(tracker=core.MemoryTracker(),
                                        component="pool", backing="numpy")
    pool = core.AdaptiveBufferPool(_census(core), alloc)
    b1, b2 = pool.acquire("ffn", 64), pool.acquire("ffn", 64)
    v1, v2 = b1.view(np.uint8, (64,)), b2.view(np.uint8, (64,))
    v1[:] = 1
    v2[:] = 2
    assert v1[0] == 1 and v2[0] == 2
    b1.release()
    b2.release()
    pool.close()


# -- tensor stores ----------------------------------------------------------------

def _engines(core, root):
    return [core.FilesystemEngine(root + "/fs", fsync=False),
            core.DirectNVMeEngine(root + "/raw", n_devices=3,
                                  device_capacity=1 << 26,
                                  min_stripe=1 << 12)]


@pytest.mark.parametrize("engine_idx", [0, 1])
def test_store_roundtrip_update_and_bf16(pkg, engine_idx, tmp_store_root,
                                         rng):
    name, core = pkg
    st_ = _engines(core, tmp_store_root)[engine_idx]
    x = rng.standard_normal((333, 57)).astype(np.float32)
    st_.write("w/a", x)
    st_.write("w/a", -x)     # in-place update
    np.testing.assert_array_equal(st_.read_new("w/a", np.float32, x.shape),
                                  -x)
    # host bf16: ml_dtypes in the reference, uint16 bits in the port —
    # the same bytes either way
    bits = rng.standard_normal(1000).astype(ml_dtypes.bfloat16).view(
        np.uint16)
    st_.write("bf", bits.view(BF16[name]))
    got = st_.read_new("bf", BF16[name], bits.shape)
    np.testing.assert_array_equal(got.view(np.uint16), bits)
    st_.close()


def test_store_async_api_and_io_stats(pkg, tmp_store_root, rng):
    _, core = pkg
    eng = core.DirectNVMeEngine(tmp_store_root, n_devices=2,
                                device_capacity=1 << 24)
    x = rng.standard_normal(5000).astype(np.float32)
    eng.write_async("x", x).result()
    out = np.empty_like(x)
    eng.read_async("x", out).result()
    np.testing.assert_array_equal(out, x)
    assert eng.stats.bytes_written == eng.stats.bytes_read == x.nbytes
    eng.close()


# -- swapper ----------------------------------------------------------------------

@pytest.fixture
def swap_setup(pkg, tmp_store_root, rng):
    _, core = pkg
    store = core.DirectNVMeEngine(tmp_store_root, n_devices=2,
                                  device_capacity=1 << 24)
    census = core.PoolCensus((core.ShapeClass("w", 4096 * 4, 2),),
                             inflight_blocks=2)
    pool = core.AdaptiveBufferPool(census, core.AlignmentFreeAllocator(
        tracker=core.MemoryTracker(), component="pool", backing="numpy"))
    tensors = {f"t{i}": rng.standard_normal(4096).astype(np.float32)
               for i in range(6)}
    for k, v in tensors.items():
        store.write(k, v)
    swapper = core.ParameterSwapper(store, pool,
                                    class_of={k: "w" for k in tensors})
    yield pool, swapper, tensors
    swapper.drain()
    pool.close()
    store.close()


def test_swapper_pipeline_over_all_tensors(swap_setup):
    """Stream 6 tensors through a 4-slot pool with prefetch depth 2."""
    pool, swapper, tensors = swap_setup
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


def test_swapper_drain_releases_slots_despite_failed_read(swap_setup):
    pool, swapper, _tensors = swap_setup
    swapper.prefetch("nope", np.float32, (4096,), class_name="w")
    swapper.prefetch("t0", np.float32, (4096,))
    swapper.drain()
    assert pool.in_use_payload == 0


# -- paged KV cache ---------------------------------------------------------------

def test_kv_cache_spill_refill_bytes_match(pkg, tmp_store_root, rng):
    """Prefill, spill under a 2-page budget, append, gather: the window
    holds exactly the bytes written, in both packages."""
    name, core = pkg
    spec = core.DecodeSpec(batch=2, max_seq=16, bucket=4, resident_pages=2)
    page_shape = (2, 1, spec.page_size, 2, 8)
    nbytes = 2 * int(np.prod(page_shape))
    census = core.PoolCensus((core.ShapeClass(core.KV_CLASS, nbytes,
                                              standalone=4),))
    pool = core.AdaptiveBufferPool(census, core.AlignmentFreeAllocator(
        tracker=core.MemoryTracker(), component="pool", backing="numpy"))
    store = core.DirectNVMeEngine(tmp_store_root, n_devices=1,
                                  device_capacity=1 << 22)
    kv = core.SpillableKVCache(["b0", "b1"], page_shape, spec.max_seq,
                               BF16[name], pool, store, resident_limit=4,
                               slots=2)
    bits = lambda *s: rng.integers(0, 1 << 15, size=s).astype(np.uint16)
    k = {u: bits(2, 8, 2, 8) for u in ("b0", "b1")}
    v = {u: bits(2, 8, 2, 8) for u in ("b0", "b1")}
    for u in ("b0", "b1"):
        kv.write_prefill(u, k[u].view(BF16[name]), v[u].view(BF16[name]))
    kv.set_length(6)
    k6, v6 = bits(2, 1, 2, 8), bits(2, 1, 2, 8)
    kv.append("b0", k6.view(BF16[name]), v6.view(BF16[name]))
    k_win, v_win = kv.gather_window("b0", spec.bucket_len(7))
    np.testing.assert_array_equal(k_win[:, :6].view(np.uint16), k["b0"][:, :6])
    np.testing.assert_array_equal(k_win[:, 6:7].view(np.uint16), k6)
    np.testing.assert_array_equal(v_win[:, 6:7].view(np.uint16), v6)
    assert kv.stats.snapshot()["spills"] > 0
    kv.close()
    pool.close()
    store.close()


# -- stream plans -----------------------------------------------------------------

KW = dict(name="tiny", family="dense", n_layers=3, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256)


@pytest.fixture(scope="module")
def both_models():
    jm = jax_lm(JConfig(**KW), jax.random.PRNGKey(0))
    tm = from_numpy_units(ModelConfig(**KW), jm.units, device="cpu")
    return jm, tm


@pytest.mark.parametrize("plan", ["compile_prefill", "compile_decode_cached"])
def test_port_plans_match_reference_op_sequence(plan, both_models):
    from repro.core import stream_plan as jsp
    from repro_torch.core import stream_plan as tsp
    jm, tm = both_models
    ref, got = getattr(jsp, plan)(jm), getattr(tsp, plan)(tm)
    assert got.name == ref.name and got.fetch_order == ref.fetch_order
    assert [(type(o).__name__, vars(o)) for o in got.ops] == \
        [(type(o).__name__, vars(o)) for o in ref.ops]


@pytest.mark.parametrize("ops", [
    lambda c: [c.ComputeOp("u", "embed")],                       # no fetch
    lambda c: [c.FetchOp("u"), c.FetchOp("u")],                  # double
    lambda c: [c.FetchOp("u")],                                  # leaked
], ids=["compute_before_fetch", "double_fetch", "leaked_fetch"])
def test_plan_validator_rejects_lifecycle_faults(pkg, ops):
    _, core = pkg
    with pytest.raises(core.PlanError):
        core.StreamPlan("bad", tuple(ops(core)))
