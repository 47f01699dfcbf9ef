"""The reference's ``tests/test_buffer_pool.py`` on the port: its ``repro``
imports read ``repro_torch``.

Parameter buffer pools: fragmentation of fixed vs adaptive (§III-A/IV-B).

Two of its cases, ``test_blocking_acquire_backpressure`` and
``test_numpy_backed_slots_are_disjoint``, are cases of the parametrised
functions of those names in ``tests/test_torch_substrate.py``, which run
them on both packages.
"""

import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
import torch

from repro_torch.core import (AdaptiveBufferPool, AlignmentFreeAllocator,
                        FixedBufferPool, MemoryTracker, PoolCensus,
                        ShapeClass)
from repro_torch.configs import ARCHS, PAPER_MODELS

torch.set_num_threads(2)


def _alloc(t=None):
    return AlignmentFreeAllocator(tracker=t or MemoryTracker(),
                                  component="pool")


CENSUS = PoolCensus((
    ShapeClass("embed", 1_000_000, 0, 2),
    ShapeClass("ffn", 100_000, 3),
    ShapeClass("kv", 4_000, 2),
    ShapeClass("qo", 40_000, 2),
), inflight_blocks=2)


def test_fixed_pool_sized_by_largest_tensor():
    pool = FixedBufferPool(CENSUS, _alloc())
    assert pool.pool_bytes == 1_000_000 * CENSUS.total_slots
    buf = pool.acquire("kv", 4_000)
    assert buf.capacity == 1_000_000      # the fragmentation mechanism
    buf.release()
    pool.close()


def test_adaptive_pool_sized_by_class():
    pool = AdaptiveBufferPool(CENSUS, _alloc())
    expected = (2 * 1_000_000 + 6 * 100_000 + 4 * 4_000 + 4 * 40_000)
    assert pool.pool_bytes == expected
    buf = pool.acquire("kv", 4_000)
    assert buf.capacity == 4_000
    buf.release()
    pool.close()


def test_adaptive_rejects_unknown_class_and_oversize():
    pool = AdaptiveBufferPool(CENSUS, _alloc())
    with pytest.raises(KeyError):
        pool.acquire("nope", 10)
    with pytest.raises(ValueError, match="exceeds slot"):
        pool.acquire("kv", 5_000)
    pool.close()


def test_fragmentation_metric():
    pool = FixedBufferPool(CENSUS, _alloc())
    bufs = [pool.acquire("ffn", 100_000) for _ in range(3)]
    for b in bufs:
        b.release()
    # peak payload 300k vs pool 10M
    assert pool.fragmentation() > 0.9
    pool.close()


def test_same_tag_double_checkout_keeps_both_records():
    """Two concurrent checkouts under one tag (a unit's forward ticket
    still staging while its backward re-fetch is issued inside a deep
    lookahead window): the live-metadata hashtable must track both, and
    releasing the first must drop *that* buffer's record, not the tag
    (regression: a plain {tag: buf} map lost the first record and the
    first release popped the wrong one)."""
    pool = AdaptiveBufferPool(CENSUS, _alloc())
    a = pool.acquire("ffn", 90_000, tag="block_0/w")
    b = pool.acquire("ffn", 80_000, tag="block_0/w")
    assert pool._live["block_0/w"] == [a, b]
    a.release()
    assert pool._live["block_0/w"] == [b]     # b's record survived
    assert pool.in_use_payload == 80_000      # accounting tracked per-buf
    b.release()
    assert "block_0/w" not in pool._live
    assert pool.in_use_payload == 0
    # all slots back: a third acquire of every slot succeeds immediately
    bufs = [pool.acquire("ffn", 100_000, timeout=0.5) for _ in range(6)]
    for buf in bufs:
        buf.release()
    pool.close()


def test_exhaustion_times_out():
    census = PoolCensus((ShapeClass("ffn", 100, 1),), inflight_blocks=1)
    pool = AdaptiveBufferPool(census, _alloc())
    b1 = pool.acquire("ffn", 100)
    with pytest.raises(TimeoutError):
        pool.acquire("ffn", 100, timeout=0.05)
    b1.release()
    pool.close()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_arch_census_adaptive_saves(arch):
    """Adaptive pool never exceeds fixed pool; big win on real censuses."""
    census = ARCHS[arch].pool_census()
    fixed = FixedBufferPool(census, _alloc())
    adaptive = AdaptiveBufferPool(census, _alloc())
    assert adaptive.pool_bytes <= fixed.pool_bytes
    fixed.close(); adaptive.close()


def test_paper_fragmentation_magnitude():
    """Order-of-magnitude check against the paper: ~70% fragmentation for a
    Llama-3-8B-class census under the fixed pool."""
    census = PAPER_MODELS["llama3.1-8b"].pool_census()
    fixed = FixedBufferPool(census, _alloc())
    adaptive = AdaptiveBufferPool(census, _alloc())
    saving = 1 - adaptive.pool_bytes / fixed.pool_bytes
    assert saving > 0.5, f"expected >50% pool saving, got {saving:.1%}"
    fixed.close(); adaptive.close()


@settings(max_examples=25, deadline=None)
@given(st.lists(
    st.tuples(st.integers(min_value=1, max_value=1 << 20),   # nbytes
              st.integers(min_value=0, max_value=4),          # per_block
              st.integers(min_value=0, max_value=2)),         # standalone
    min_size=1, max_size=6))
def test_pool_size_property(classes):
    if not any(pb + sa > 0 for _, pb, sa in classes):
        classes = classes + [(64, 1, 0)]
    census = PoolCensus(tuple(
        ShapeClass(f"c{i}", n, pb, sa)
        for i, (n, pb, sa) in enumerate(classes)), inflight_blocks=2)
    fixed = FixedBufferPool(census, _alloc())
    adaptive = AdaptiveBufferPool(census, _alloc())
    # invariant: adaptive <= fixed; both hold every slot
    assert adaptive.pool_bytes <= fixed.pool_bytes
    assert sum(adaptive._total_slots.values()) == census.total_slots
    fixed.close(); adaptive.close()
