"""The overflow screen: the port's plain kernel version and its host module
against the reference package, on the same numpy inputs.

* ``overflow_check_plain`` (the torch version of the Hopper kernel, which
  CPU sessions use) against the reference's Pallas kernel run in interpret
  mode through ``repro.kernels.ops.overflow_check`` (as
  ``tests/test_kernels.py`` runs it) and against its oracle
  ``ref.ref_overflow_check``: the kernel sweeps, nd shapes, regions whose
  edges fall mid-vector, dtypes it refuses, and a property test.
* the ported numpy module (``repro_torch.core.overflow``) and the
  reference's, parametrised over both packages: the partition-OR invariant
  of ``check_region`` that the per-unit screen relies on, and the chained
  baseline's agreement.

The kernel itself runs on the card only: ``tests/test_torch_cuda.py``.
"""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops, ref
from repro_torch.core.dtypes import to_torch
from repro_torch.kernels import ops
from repro_torch.kernels.overflow_check import (overflow_check_plain,
                                                overflow_flag_cuda_)

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16", "float16"]
PAYLOADS = {"inf": np.inf, "-inf": -np.inf, "nan": np.nan}
PKGS = ["repro", "repro_torch"]
BF16 = {"repro": np.dtype(ml_dtypes.bfloat16),
        "repro_torch": np.dtype(np.uint16)}


def _both(x32: np.ndarray, dtype: str):
    """The same values as a jnp array (reference) and a torch tensor."""
    if dtype == "bfloat16":
        jx = jnp.asarray(x32, jnp.bfloat16)
        bits = np.asarray(jx).view(np.uint16)
        return jx, to_torch(bits.copy(), torch.bfloat16)
    jx = jnp.asarray(x32, getattr(jnp, dtype))
    return jx, torch.from_numpy(np.asarray(jx).copy())


def _verdicts(x32, dtype):
    jx, tx = _both(x32, dtype)
    return (bool(overflow_check_plain(tx)), bool(jops.overflow_check(jx)),
            bool(ref.ref_overflow_check(jx)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 127, 128, 129, 65_536, 100_001])
def test_plain_matches_reference_sweep(dtype, n, rng):
    """Clean, finfo.max (must not trigger), and +Inf/-Inf/NaN at the
    first, middle and last index: the plain version, the Pallas kernel
    and the oracle agree on every case."""
    base = rng.standard_normal(n).astype(np.float32)
    assert _verdicts(base, dtype) == (False, False, False)
    big = base.copy()
    big[n // 2] = float(jnp.finfo(getattr(jnp, dtype)).max)
    big[0] = -0.0
    assert _verdicts(big, dtype) == (False, False, False)
    for payload in PAYLOADS.values():
        for pos in sorted({0, n // 2, n - 1}):
            x = base.copy()
            x[pos] = payload
            assert _verdicts(x, dtype) == (True, True, True)


@pytest.mark.parametrize("shape", [(4, 4), (3, 5, 7), (2, 2, 2, 2)])
def test_plain_nd_shapes(shape, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    assert _verdicts(x, "float32") == (False, False, False)
    x.reshape(-1)[0] = -np.inf
    assert _verdicts(x, "float32") == (True, True, True)
    assert ops.overflow_check(torch.from_numpy(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lo,hi", [(3, 61), (1, 2), (5, 5), (0, 64),
                                   (7, 40)])
def test_plain_regions_edges_mid_vector(dtype, lo, hi):
    """[lo, hi) regions whose edges fall inside a 16-byte vector: a payload
    just inside the region trips it, one just outside does not."""
    n = 64
    for pos, inside in ((lo, True), (hi - 1, True), (lo - 1, False),
                        (hi, False)):
        if not 0 <= pos < n or (inside and hi == lo):
            continue
        x = np.zeros(n, np.float32)
        x[pos] = np.inf
        jx, tx = _both(x, dtype)
        flag = torch.zeros(1, dtype=torch.int32)
        ops.overflow_flag_(tx, flag, lo, hi)
        assert bool(overflow_check_plain(tx, lo, hi)) == inside
        assert bool(flag.item()) == inside
        assert bool(ref.ref_overflow_check(jx[lo:hi])) == inside


def test_flag_accumulates_across_regions():
    """OR semantics: a set flag stays set, a clean region leaves it."""
    x = torch.zeros(100)
    x[90] = float("nan")
    flag = torch.zeros(1, dtype=torch.int32)
    ops.overflow_flag_(x, flag, 0, 50)
    assert flag.item() == 0
    ops.overflow_flag_(x, flag, 50, 100)
    ops.overflow_flag_(x, flag, 0, 50)
    assert flag.item() == 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64, torch.uint8,
                                   torch.int16])
def test_other_dtypes_raise_type_error(dtype):
    """Any dtype but fp32/bf16/fp16 raises TypeError, before a launch —
    also in the CUDA wrapper, which checks before it touches the device."""
    x = torch.zeros(8, dtype=dtype)
    with pytest.raises(TypeError):
        overflow_check_plain(x)
    with pytest.raises(TypeError):
        ops.overflow_check(x)
    before = overflow_flag_cuda_.launches
    with pytest.raises(TypeError):
        overflow_flag_cuda_(x, torch.zeros(1, dtype=torch.int32))
    assert overflow_flag_cuda_.launches == before
    with pytest.raises(TypeError):
        jops.overflow_check(jnp.zeros(8, jnp.int32))


def test_region_bounds_are_checked():
    with pytest.raises(ValueError, match="region"):
        overflow_check_plain(torch.zeros(8), 3, 9)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(min_value=1, max_value=20_000),
       pos=st.floats(min_value=0, max_value=1),
       kind=st.sampled_from(["none", "inf", "-inf", "nan", "max"]),
       dtype=st.sampled_from(DTYPES))
def test_plain_property(n, pos, kind, dtype):
    x = np.random.default_rng(42).standard_normal(n).astype(np.float32)
    i = int(pos * (n - 1))
    if kind in PAYLOADS:
        x[i] = PAYLOADS[kind]
    elif kind == "max":
        x[i] = float(jnp.finfo(getattr(jnp, dtype)).max)   # must NOT trigger
    _jx, tx = _both(x, dtype)
    assert bool(overflow_check_plain(tx)) == (kind in PAYLOADS)


# -- the host module, both packages --------------------------------------------

def _payload_array(n, dtype, kind, where, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 100).astype(np.float32)
    if kind != "none":
        pos = {"first": 0, "last": n - 1,
               "random": int(rng.integers(0, n))}[where]
        g[pos] = PAYLOADS[kind]
    return g


def _host(pkg, g32, dtype):
    """``g32`` in the package's host form of ``dtype``."""
    if dtype == "bfloat16":
        return g32.astype(ml_dtypes.bfloat16).view(BF16[pkg])
    return g32.astype(dtype)


@pytest.mark.parametrize("pkg", PKGS)
@settings(max_examples=30, deadline=None)
@given(n=st.integers(min_value=1, max_value=259),
       dtype=st.sampled_from(DTYPES),
       kind=st.sampled_from(["none", "inf", "-inf", "nan"]),
       where=st.sampled_from(["first", "last", "random"]),
       fracs=st.lists(st.floats(min_value=0.0, max_value=1.0), min_size=0,
                      max_size=6),
       seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_partition_or_equals_whole_buffer(pkg, n, dtype, kind, where, fracs,
                                          seed):
    """For ANY partition of the buffer into regions, the OR of the
    per-region verdicts equals the whole-buffer verdict, for the fused and
    the chained check alike."""
    overflow = importlib.import_module(f"{pkg}.core.overflow")
    core = importlib.import_module(f"{pkg}.core")
    g = _host(pkg, _payload_array(n, dtype, kind, where, seed), dtype)
    expected = kind != "none"
    t = core.MemoryTracker()
    cuts = sorted({0, n, *(int(f * n) for f in fracs)})
    for fused in (True, False):
        whole = overflow.flat_overflow_check(g, fused=fused, tracker=t)
        regions = [overflow.check_region(g, lo, hi, fused=fused, tracker=t)
                   for lo, hi in zip(cuts, cuts[1:], strict=False)]
        assert any(regions) == whole == expected
    t.assert_quiescent()


@pytest.mark.parametrize("pkg", PKGS)
def test_region_screen_sees_only_its_region_and_chunk_edges(pkg):
    overflow = importlib.import_module(f"{pkg}.core.overflow")
    g = np.zeros(256, np.float32)
    g[0], g[-1] = np.inf, np.nan
    assert not overflow.check_region(g, 1, g.size - 1, fused=True)
    assert overflow.check_region(g, 0, 1, fused=True)
    assert overflow.check_region(g, g.size - 1, g.size, fused=True)
    chunk = overflow.FUSED_CHUNK
    for n in (chunk - 1, chunk, chunk + 1):
        x = np.zeros(n, np.float32)
        x[-1] = np.inf
        assert overflow.fused_overflow_check(x)
        x[-1] = 1.0
        assert not overflow.fused_overflow_check(x)


@pytest.mark.parametrize("pkg", PKGS)
def test_baseline_charges_two_and_a_quarter_x(pkg):
    """The chained check's tracked peak is 2.25x an fp32 payload in both
    packages (the zero-infinity preset's measured cost)."""
    core = importlib.import_module(f"{pkg}.core")
    overflow = importlib.import_module(f"{pkg}.core.overflow")
    t = core.MemoryTracker()
    g = np.ones(4096, np.float32)
    assert not overflow.baseline_overflow_check(g, tracker=t,
                                                component="ov")
    assert t.component("ov").peak_requested == int(1.25 * g.nbytes)
    t.assert_quiescent()
