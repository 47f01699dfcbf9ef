"""Pinned host-memory allocators: the paper's §III-B / §IV-C.

Two policies, identical interface:

* :class:`PowerOfTwoCachingAllocator` — the ZeRO-Infinity baseline: every
  request is rounded up to the next power of two, PyTorch's
  ``CachingHostAllocator`` policy.  Good for highly dynamic workloads,
  catastrophic for the large, long-lived, exactly-sized buffers of SSD
  offloading (a 2.1 GiB request reserves 4 GiB *forever*).  On CUDA it IS
  that allocator: ``torch.empty(n, dtype=uint8, pin_memory=True)``.

* :class:`AlignmentFreeAllocator` — MemAscend's fix: requests are padded only
  to the DMA alignment (4096 B, the ``posix_memalign`` alignment the paper
  uses), so long-lived buffers occupy requested-plus-one-page at most.  On
  CUDA the 4096-aligned host arena is page-locked in place with
  ``cudaHostRegister`` at its exact size and unregistered on free.

Three backings:

* ``backing="accounting"`` (default): no real memory is touched — the
  allocator tracks bytes through a :class:`MemoryTracker`.  This is how
  benchmarks evaluate the policies at 8B–32B-model scale.
* ``backing="numpy"``: allocations are backed by real ``np.zeros`` buffers
  in pageable memory (the CPU-only stand-in for pinned memory).
* ``backing="cuda"``: real page-locked memory as above.  Every buffer still
  exposes a uint8 numpy view, so pool slots, SSD reads and KV pages work on
  it unchanged; ``torch.from_numpy`` of such a view is a pinned tensor, so
  ``non_blocking`` H2D copies from it are true DMA.  The caller picks the
  backing from its device; nothing falls back silently.

The caching behaviour of the baseline matters too: freed blocks go to a
size-keyed free list and are reused, which is exactly why pow2 rounding was
chosen upstream — and why it backfires here (the paper's point: these buffers
are allocated once and never churn, so the cache buys nothing and the
rounding is pure waste).
"""

from __future__ import annotations

import numpy as np
import torch

from .memory_tracker import MemoryTracker, GLOBAL_TRACKER

DMA_ALIGNMENT = 4096  # posix_memalign alignment used by MemAscend


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def align_up(n: int, align: int) -> int:
    return ((n + align - 1) // align) * align


class PinnedBuffer:
    """A handle to one pinned allocation.

    ``array`` is a uint8 view of the payload region (numpy backing only).
    """

    __slots__ = ("size", "capacity", "array", "_handle", "_allocator", "freed",
                 "tag", "_full_array")

    def __init__(self, size: int, capacity: int, array: np.ndarray | None,
                 handle: int, allocator: "PinnedAllocatorBase", tag: str) -> None:
        self.size = size              # requested payload bytes
        self.capacity = capacity      # reserved bytes (>= size)
        self.array = array            # np.uint8[size] or None (accounting mode)
        self._handle = handle
        self._allocator = allocator
        self.freed = False
        self.tag = tag

    def view(self, dtype, shape) -> np.ndarray:
        """Typed view of the payload (numpy backing only)."""
        if self.array is None:
            raise RuntimeError("accounting-mode buffer has no storage")
        nbytes = int(np.dtype(dtype).itemsize * np.prod(shape, dtype=np.int64))
        if nbytes > self.size:
            raise ValueError(f"view of {nbytes} B exceeds buffer payload {self.size} B")
        return self.array[:nbytes].view(dtype).reshape(shape)

    def free(self) -> None:
        self._allocator.free(self)


class PinnedAllocatorBase:
    """Common bookkeeping for both policies."""

    #: subclasses: bytes actually reserved for a request
    def _rounded(self, nbytes: int) -> int:
        raise NotImplementedError

    def __init__(self, *, tracker: MemoryTracker | None = None,
                 component: str = "pinned", backing: str = "accounting",
                 caching: bool = True) -> None:
        if backing not in ("accounting", "numpy", "cuda"):
            raise ValueError(f"unknown backing {backing!r}")
        if backing == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("backing='cuda' needs a CUDA device")
        self.tracker = tracker or GLOBAL_TRACKER
        self.component = component
        self.backing = backing
        self.caching = caching
        # free-list: reserved-size -> list of (capacity, array|None)
        self._free_list: dict[int, list[np.ndarray | None]] = {}
        self.total_requested = 0      # cumulative
        self.total_reserved = 0       # cumulative

    def alloc(self, nbytes: int, *, tag: str = "") -> PinnedBuffer:
        if nbytes <= 0:
            raise ValueError(f"allocation must be positive, got {nbytes}")
        capacity = self._rounded(nbytes)
        array = None
        cached = self._free_list.get(capacity)
        if self.caching and cached:
            array = cached.pop()
            # cached block: tracker already released it on free(); re-account.
        if array is None and self.backing == "numpy":
            array = np.zeros(capacity, dtype=np.uint8)
        elif array is None and self.backing == "cuda":
            array = self._alloc_pinned(capacity)
        handle = self.tracker.alloc(self.component, nbytes, capacity, tag=tag)
        self.total_requested += nbytes
        self.total_reserved += capacity
        payload = array[:nbytes] if array is not None else None
        buf = PinnedBuffer(nbytes, capacity, payload, handle, self, tag)
        buf._full_array = array  # keep the capacity-sized base alive (or None)
        return buf

    def free(self, buf: PinnedBuffer) -> None:
        if buf.freed:
            raise ValueError(f"double free of pinned buffer {buf.tag!r}")
        buf.freed = True
        self.tracker.free(buf._handle)
        base = getattr(buf, "_full_array", None)
        if self.caching:
            self._free_list.setdefault(buf.capacity, []).append(base)
        elif base is not None and self.backing == "cuda":
            self._free_pinned(base)
        buf.array = None
        buf._full_array = None

    # -- page-locked backing (backing="cuda") --------------------------------

    def _alloc_pinned(self, capacity: int) -> np.ndarray:
        """A zeroed, page-locked uint8 array of ``capacity`` bytes."""
        raise NotImplementedError

    def _free_pinned(self, array: np.ndarray) -> None:
        """Return one :meth:`_alloc_pinned` array (non-caching frees)."""

    # -- reporting ---------------------------------------------------------

    @property
    def live_waste(self) -> int:
        stats = self.tracker.component(self.component)
        return stats.live_allocated - stats.live_requested

    def waste_fraction(self) -> float:
        """Fraction of reserved bytes that is rounding overhead (cumulative)."""
        if self.total_reserved == 0:
            return 0.0
        return 1.0 - self.total_requested / self.total_reserved


class PowerOfTwoCachingAllocator(PinnedAllocatorBase):
    """Baseline: PyTorch CachingHostAllocator policy (round to next pow2)."""

    def _rounded(self, nbytes: int) -> int:
        return next_power_of_two(nbytes)

    def _alloc_pinned(self, capacity: int) -> np.ndarray:
        # torch's caching host allocator: the numpy view keeps the pinned
        # tensor (and so the cached block) alive through ``.base``
        return torch.zeros(capacity, dtype=torch.uint8,
                           pin_memory=True).numpy()

    def _free_pinned(self, array: np.ndarray) -> None:
        pass    # dropping the last view returns the block to torch's cache


class AlignmentFreeAllocator(PinnedAllocatorBase):
    """MemAscend: exact-size allocation at DMA (4096 B) alignment.

    Models the custom C++ extension: ``posix_memalign(4096)`` +
    ``cudaHostRegister`` — capacity is the request padded to one page.
    Caching is disabled by default: these buffers are allocated once at
    initialization and live until training ends (paper §IV-C), so a free-list
    would only hide leaks.
    """

    def __init__(self, **kw) -> None:
        kw.setdefault("caching", False)
        super().__init__(**kw)

    def _rounded(self, nbytes: int) -> int:
        return align_up(nbytes, DMA_ALIGNMENT)

    def _alloc_pinned(self, capacity: int) -> np.ndarray:
        # posix_memalign(4096) analogue: over-allocate one page and slice
        # at the first 4096-aligned address; then page-lock exactly the
        # capacity the tracker charged
        raw = np.zeros(capacity + DMA_ALIGNMENT, dtype=np.uint8)
        lead = -raw.ctypes.data % DMA_ALIGNMENT
        array = raw[lead:lead + capacity]
        err = torch.cuda.cudart().cudaHostRegister(array.ctypes.data,
                                                   capacity, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {capacity} B failed "
                               f"with CUDA error {int(err)}")
        return array

    def _free_pinned(self, array: np.ndarray) -> None:
        err = torch.cuda.cudart().cudaHostUnregister(array.ctypes.data)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostUnregister failed with CUDA error "
                               f"{int(err)}")
