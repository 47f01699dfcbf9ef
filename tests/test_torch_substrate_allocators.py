"""The reference's ``tests/test_allocators.py`` on the port: its ``repro``
imports read ``repro_torch``.

Pinned allocators: pow2 baseline vs alignment-free (paper §III-B/§IV-C).

Three of its cases, ``test_pow2_rounding_doubles_large_requests``,
``test_alignment_free_wastes_at_most_one_page`` and
``test_numpy_backing_view_roundtrip``, are cases of the parametrised
functions of those names in ``tests/test_torch_substrate.py``, which run
them on both packages.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
import torch

from repro_torch.core import (AlignmentFreeAllocator, MemoryTracker,
                        PowerOfTwoCachingAllocator, next_power_of_two,
                        align_up, DMA_ALIGNMENT)

torch.set_num_threads(2)


def test_tracker_accounting_and_peak():
    t = MemoryTracker()
    a = PowerOfTwoCachingAllocator(tracker=t, component="x", caching=False)
    b1 = a.alloc(1000)
    b2 = a.alloc(3000)
    assert t.live_requested == 4000
    assert t.live_allocated == 1024 + 4096
    b1.free()
    assert t.live_requested == 3000
    assert t.peak_allocated == 1024 + 4096
    b2.free()
    t.assert_quiescent()


def test_double_free_raises():
    a = AlignmentFreeAllocator(tracker=MemoryTracker(), component="p")
    buf = a.alloc(100)
    buf.free()
    with pytest.raises(ValueError, match="double free"):
        buf.free()


def test_caching_reuses_numpy_backing():
    a = PowerOfTwoCachingAllocator(tracker=MemoryTracker(), component="p",
                                   backing="numpy")
    b1 = a.alloc(1000)
    base1 = b1._full_array
    b1.free()
    b2 = a.alloc(900)   # same pow2 class (1024) -> reuses the cached block
    assert b2._full_array is base1
    b2.free()


@given(st.integers(min_value=1, max_value=2**40))
def test_pow2_props(n):
    p = next_power_of_two(n)
    assert p >= n and p < 2 * n + 1 and (p & (p - 1)) == 0


@given(st.integers(min_value=1, max_value=2**40))
def test_align_props(n):
    a = align_up(n, DMA_ALIGNMENT)
    assert a >= n and a - n < DMA_ALIGNMENT and a % DMA_ALIGNMENT == 0


@settings(max_examples=30)
@given(st.lists(st.integers(min_value=DMA_ALIGNMENT, max_value=1 << 28),
                min_size=1, max_size=30))
def test_waste_ordering_property(sizes):
    """Alignment-free never reserves more than pow2 for page-sized-or-larger
    requests (the offloading workload: the paper's §III-B buffers are
    hundreds of MiB; sub-page allocations stay on the default allocator)."""
    t1, t2 = MemoryTracker(), MemoryTracker()
    a1 = PowerOfTwoCachingAllocator(tracker=t1, component="x", caching=False)
    a2 = AlignmentFreeAllocator(tracker=t2, component="x")
    for s in sizes:
        a1.alloc(s)
        a2.alloc(s)
    assert t2.live_allocated <= t1.live_allocated
    assert t2.live_allocated - t2.live_requested < DMA_ALIGNMENT * len(sizes)
