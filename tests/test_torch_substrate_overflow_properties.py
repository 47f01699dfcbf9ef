"""The reference's ``tests/test_overflow_properties.py`` on the port: its ``repro``
imports read ``repro_torch``.

Property-based lockdown of the overflow screen (fused bitwise pass).

Three families of invariants, run under real ``hypothesis`` when installed
(requirements-dev.txt; CI's ``property-tests`` job) and under the
deterministic in-repo stub otherwise (tests/_hypothesis_stub.py — the
default tier-1 job exercises that path):

* **agreement** — the fused check matches numpy Inf/NaN semantics (and the
  chained baseline) for fp32/fp16/bf16, over array sizes straddling chunk
  boundaries, with ±Inf/NaN payloads at the first element, the last
  element, and arbitrary positions;
* **partition invariant** — the OR of per-region verdicts over *any*
  partition of the flat buffer equals the whole-buffer verdict.  This is
  what lets the executor screen each unit's region as its gradient
  write-back lands and only OR verdicts at the barrier;
* **hygiene** — every check returns its tracker charges (balance zero).
"""

import numpy as np
import ml_dtypes
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st
import torch

from repro_torch.core import (MemoryTracker, baseline_overflow_check,
                        fused_overflow_check)
from repro_torch.core.overflow import FUSED_CHUNK, check_region, flat_overflow_check

torch.set_num_threads(2)

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float16), BF16]
PAYLOADS = {"inf": np.inf, "-inf": -np.inf, "nan": np.nan}
# a small chunk so property-sized arrays straddle many chunk boundaries
# (the deterministic tests below cover the real FUSED_CHUNK)
CHUNK = 64


def _numpy_verdict(g: np.ndarray) -> bool:
    """Ground truth; the fp32 upcast is exact for fp16/bf16."""
    f = g.astype(np.float32)
    return bool(np.isinf(f).any() or np.isnan(f).any())


def _payload_array(n, dtype, kind, where, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 100).astype(dtype)
    if kind != "none":
        pos = {"first": 0, "last": n - 1,
               "random": int(rng.integers(0, n))}[where]
        g[pos] = PAYLOADS[kind]
    return g


@settings(max_examples=80, deadline=None)
@given(n=st.integers(min_value=1, max_value=4 * CHUNK + 3),
       dtype=st.sampled_from(DTYPES),
       kind=st.sampled_from(["none", "inf", "-inf", "nan"]),
       where=st.sampled_from(["first", "last", "random"]),
       seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_fused_agrees_with_numpy_and_baseline(n, dtype, kind, where, seed):
    g = _payload_array(n, dtype, kind, where, seed)
    expected = _numpy_verdict(g)
    assert expected == (kind != "none")
    t = MemoryTracker()
    assert fused_overflow_check(g, tracker=t, chunk=CHUNK) == expected
    assert baseline_overflow_check(g, tracker=t) == expected
    t.assert_quiescent()          # every temporary charge was returned


@settings(max_examples=60, deadline=None)
@given(n=st.integers(min_value=1, max_value=4 * CHUNK + 3),
       dtype=st.sampled_from(DTYPES),
       kind=st.sampled_from(["none", "inf", "-inf", "nan"]),
       where=st.sampled_from(["first", "last", "random"]),
       fracs=st.lists(st.floats(min_value=0.0, max_value=1.0), min_size=0,
                      max_size=6),
       seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_partition_or_equals_whole_buffer(n, dtype, kind, where, fracs,
                                          seed):
    """The per-subgroup screen's correctness argument: for ANY partition
    of the flat buffer into regions (including empty ones), the OR of the
    per-region verdicts equals the whole-buffer verdict."""
    g = _payload_array(n, dtype, kind, where, seed)
    t = MemoryTracker()
    whole = flat_overflow_check(g, fused=True, tracker=t)
    cuts = sorted({0, n, *(int(f * n) for f in fracs)})
    or_of_regions = False
    for lo, hi in zip(cuts, cuts[1:], strict=False):
        or_of_regions = or_of_regions or check_region(
            g, lo, hi, fused=True, tracker=t)
    assert or_of_regions == whole == _numpy_verdict(g)
    t.assert_quiescent()


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(n=st.integers(min_value=1, max_value=2 * CHUNK),
       kind=st.sampled_from(["none", "inf", "nan"]),
       seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_partition_matches_for_baseline_check_too(n, kind, seed):
    """The invariant is a property of Inf/NaN detection, not of the fused
    formulation: the chained baseline ORs over partitions identically
    (fp32 — the gradient flat buffer's dtype)."""
    g = _payload_array(n, np.float32, kind, "random", seed)
    t = MemoryTracker()
    whole = flat_overflow_check(g, fused=False, tracker=t)
    mid = n // 2
    split = (check_region(g, 0, mid, fused=False, tracker=t)
             or check_region(g, mid, n, fused=False, tracker=t))
    assert split == whole
    t.assert_quiescent()


@pytest.mark.parametrize("n", [FUSED_CHUNK - 1, FUSED_CHUNK,
                               FUSED_CHUNK + 1])
@pytest.mark.parametrize("kind", ["inf", "-inf", "nan"])
@pytest.mark.parametrize("where", ["first", "last"])
def test_real_chunk_boundary_payloads(n, kind, where):
    """Deterministic straddle of the real FUSED_CHUNK: a payload at the
    first or last element of an array one-off either side of the chunk
    size must be found (the boundary slicing loses no element)."""
    g = np.zeros(n, np.float32)
    g[0 if where == "first" else n - 1] = PAYLOADS[kind]
    assert fused_overflow_check(g)
    g[0 if where == "first" else n - 1] = 1.0
    assert not fused_overflow_check(g)


def test_region_screen_sees_only_its_region():
    """A payload OUTSIDE the screened region must not trip it — region
    boundaries are exact (the per-unit screen depends on it)."""
    g = np.zeros(4 * CHUNK, np.float32)
    g[0] = np.inf
    g[-1] = np.nan
    assert not check_region(g, 1, g.size - 1, fused=True)
    assert check_region(g, 0, 1, fused=True)
    assert check_region(g, g.size - 1, g.size, fused=True)
    assert check_region(g, 0, 0, fused=True) is False   # empty region
