"""Byte-exact host ("system") memory accounting.

MemAscend's claims are about *peak system memory*: the paper instruments the
host DRAM consumed by the offloading runtime (pinned staging buffers, the
gradient flat buffer, optimizer-state pools, overflow-check temporaries) and
shows that >55% of the peak is allocator/policy waste rather than payload.

This module is the measurement backbone for the whole repo.  Every allocator,
pool, and engine routes its allocations through a :class:`MemoryTracker`,
which records, per *component* (a free-form label such as
``"param_buffer_pool"`` or ``"overflow_tmp"``):

* live bytes *requested* (payload) and live bytes *allocated* (payload +
  policy overhead such as power-of-two rounding),
* global and per-component peaks,
* an event timeline for post-hoc analysis (benchmarks replay it to produce
  the paper's figures).

The tracker is deliberately dumb and deterministic: it never talks to the
OS.  That lets the benchmarks run the *policies* at paper scale (tens of GiB
of bookkeeping, zero actual buffers) while small-scale integration tests back
real numpy buffers with the same accounting.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class AllocEvent:
    """One allocation/free event in the timeline."""

    op: str                 # "alloc" | "free"
    component: str          # logical owner, e.g. "param_buffer_pool"
    requested: int          # payload bytes the caller asked for
    allocated: int          # bytes actually reserved (>= requested)
    live_allocated: int     # total live allocated bytes after this event
    tag: str = ""           # optional sub-label (tensor name, ...)


@dataclass
class ComponentStats:
    live_requested: int = 0
    live_allocated: int = 0
    peak_requested: int = 0
    peak_allocated: int = 0
    n_allocs: int = 0
    n_frees: int = 0

    def snapshot(self) -> dict:
        return {
            "live_requested": self.live_requested,
            "live_allocated": self.live_allocated,
            "peak_requested": self.peak_requested,
            "peak_allocated": self.peak_allocated,
            "n_allocs": self.n_allocs,
            "n_frees": self.n_frees,
        }


class MemoryTracker:
    """Tracks live/peak host-memory bytes per component.

    Thread-safe: the Direct NVMe engine and the prefetch swapper allocate from
    worker threads.
    """

    def __init__(self, *, keep_timeline: bool = False) -> None:
        self._lock = threading.Lock()
        self._components: dict[str, ComponentStats] = {}  # guarded-by: _lock
        self._live_requested = 0   # guarded-by: _lock
        self._live_allocated = 0   # guarded-by: _lock
        self._peak_requested = 0   # guarded-by: _lock
        self._peak_allocated = 0   # guarded-by: _lock
        self._keep_timeline = keep_timeline
        self.timeline: list[AllocEvent] = []  # guarded-by: _lock
        # Monotonic id for handles so double-free is detectable.
        self._next_handle = 1      # guarded-by: _lock
        self._live_handles: dict[int, tuple[str, int, int]] = {}  # guarded-by: _lock

    # ------------------------------------------------------------------ API

    def alloc(self, component: str, requested: int, allocated: int | None = None,
              *, tag: str = "") -> int:  # thread: any
        """Record an allocation; returns an opaque handle for :meth:`free`."""
        if requested < 0:
            raise ValueError(f"negative allocation: {requested}")
        allocated = requested if allocated is None else allocated
        if allocated < requested:
            raise ValueError(
                f"allocated ({allocated}) < requested ({requested}) for {component}")
        with self._lock:
            stats = self._components.setdefault(component, ComponentStats())
            stats.live_requested += requested
            stats.live_allocated += allocated
            stats.n_allocs += 1
            stats.peak_requested = max(stats.peak_requested, stats.live_requested)
            stats.peak_allocated = max(stats.peak_allocated, stats.live_allocated)
            self._live_requested += requested
            self._live_allocated += allocated
            self._peak_requested = max(self._peak_requested, self._live_requested)
            self._peak_allocated = max(self._peak_allocated, self._live_allocated)
            handle = self._next_handle
            self._next_handle += 1
            self._live_handles[handle] = (component, requested, allocated)
            if self._keep_timeline:
                self.timeline.append(AllocEvent(
                    "alloc", component, requested, allocated,
                    self._live_allocated, tag))
            return handle

    def free(self, handle: int) -> None:  # thread: any
        with self._lock:
            try:
                component, requested, allocated = self._live_handles.pop(handle)
            except KeyError:
                raise ValueError(f"double free or unknown handle: {handle}") from None
            stats = self._components[component]
            stats.live_requested -= requested
            stats.live_allocated -= allocated
            stats.n_frees += 1
            self._live_requested -= requested
            self._live_allocated -= allocated
            if self._keep_timeline:
                self.timeline.append(AllocEvent(
                    "free", component, requested, allocated, self._live_allocated))

    # ------------------------------------------------------------- queries

    # The query properties lock: worker threads (store aio pools, the
    # H2D stager, the Adam stage) allocate concurrently with a benchmark
    # thread sampling peaks, and an unlocked read could pair one side of
    # an in-progress alloc's requested/allocated update.

    @property
    def live_requested(self) -> int:  # thread: any
        with self._lock:
            return self._live_requested

    @property
    def live_allocated(self) -> int:  # thread: any
        with self._lock:
            return self._live_allocated

    @property
    def peak_requested(self) -> int:  # thread: any
        with self._lock:
            return self._peak_requested

    @property
    def peak_allocated(self) -> int:  # thread: any
        with self._lock:
            return self._peak_allocated

    @property
    def peak_waste(self) -> int:  # thread: any
        """Policy overhead at peak: allocated − requested (both at peak)."""
        with self._lock:
            return self._peak_allocated - self._peak_requested

    def component(self, name: str) -> ComponentStats:  # thread: any
        with self._lock:
            return self._components.setdefault(name, ComponentStats())

    def breakdown(self) -> dict[str, dict]:  # thread: any
        """Per-component snapshot (for the paper's Fig. 8-style breakdowns)."""
        with self._lock:
            return {k: v.snapshot() for k, v in self._components.items()}

    def assert_quiescent(self) -> None:  # thread: any
        """Raise if anything is still live (leak detector for tests)."""
        with self._lock:
            handles = list(self._live_handles.values())
        if handles:
            live: dict[str, int] = {}
            for comp, req, _ in handles:
                live[comp] = live.get(comp, 0) + req
            raise AssertionError(f"leaked allocations: {live}")


# A process-global default tracker; components accept an explicit tracker so
# tests/benchmarks can isolate, but the training engine uses this by default.
GLOBAL_TRACKER = MemoryTracker()


def fmt_bytes(n: float) -> str:
    """Human-readable bytes, GiB-biased like the paper's tables."""
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    raise AssertionError
