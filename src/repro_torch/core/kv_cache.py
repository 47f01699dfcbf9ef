"""Paged spill-able KV cache: decode state streamed through the offload
machinery at time-axis page granularity.

Uncached offloaded decode re-runs the full prefix per emitted token because
a per-layer KV cache would pin ``n_layers × (2, B, S, KH, D)`` of host memory
— exactly the "pin it all" design the paper exists to break.  This cache
applies MemAscend's core move to *decode state*: KV lives in a bounded number of
pool slots inside the same pinned arena the weights stream through (shape
class :data:`~repro_torch.core.buffer_pool.KV_CLASS`), spilling to the SSD tensor
store past the budget.  It pages the **time axis** (vLLM-style
block tables, 10Cache-style sub-tensor migration units): the spill/refill
unit is one fixed-size *page* of ``page_tokens`` positions, not a layer's
whole ``max_seq`` slot, so

* eviction writes only **dirty** pages (a decode step dirties one tail page
  per layer; the read-only pages of older tokens spill once and are then
  dropped for free — ``clean_drops``),
* refills read only the pages covering the attended window, not the fixed
  ``max_seq`` extent,
* pages materialize lazily, so one slot budget backs several short
  sequences' layers before anything spills at all.

Residency policy: decode touches layers cyclically (0, 1, …, L−1, 0, …), so
the pages just used are the ones whose next use is farthest away — Belady's
choice is to evict *most-recently-used*, now applied over pages rather than
layers.  A budget of ``R`` page slots keeps the coldest-by-MRU pages
resident and cycles the rest through spill/refill, with prefetched refills
riding the executor's lookahead window.

:class:`DecodeSpec` carries the serving shape (batch, max sequence, time
bucket, page size, residency budget); the session sizes the pool census
from it and buckets the decode stages' time axis so shapes repeat per bucket.

Thread contract (who may call what)
-----------------------------------

* **compute/executor thread** — :meth:`~SpillableKVCache.append`,
  :meth:`~SpillableKVCache.append_window`,
  :meth:`~SpillableKVCache.write_prefill`,
  :meth:`~SpillableKVCache.set_length` / :meth:`~SpillableKVCache.advance`,
  :meth:`~SpillableKVCache.prefetch_window`, and (sync overlap mode only)
  :meth:`~SpillableKVCache.gather_window`.
* **H2D staging worker** — :meth:`~SpillableKVCache.gather_window` for the
  *next* unit's window while the compute thread runs the current unit (the
  split KVReadOp's issue half; see :mod:`repro_torch.core.session`).
* **store worker threads** — only complete the refill futures that
  :meth:`prefetch_window` issued; they never touch cache state directly.

All page/slot bookkeeping lives under one lock.  Because two threads may
now ensure/evict concurrently, a page view is only written or copied while
**pinned** (:meth:`ensure_page` ``pin=True`` → :meth:`unpin`): eviction
skips pinned pages, so a spill on one thread can never release the pool
slot another thread is mid-copy on.  :meth:`close` must only run after the
staging worker has drained (the session's abort path guarantees it).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from .buffer_pool import KV_CLASS, BufferPoolBase
from .nvme import TensorStore
from .paged import PagedResidency, PageStats


@dataclass(frozen=True)
class DecodeSpec:
    """Serving shape for cached offloaded decode.

    ``batch``            requests decoded together (jit shapes are fixed).
    ``max_seq``          prompt + generated tokens capacity per request.
    ``bucket``           time-bucket granularity: device-side cache slices
                         are padded to the next multiple, so each bucket
                         traces/compiles once and steps within it reuse it.
    ``resident_blocks``  host KV budget in layer-equivalents: the page-slot
                         budget is ``resident_blocks × pages_per_seq``;
                         ``None`` keeps every page resident (no spill I/O).
    ``page_tokens``      KV spill/refill page size in tokens (the paged
                         cache's block-table granularity).  Must align with
                         ``bucket`` (one must divide the other).  ``None``
                         uses ``bucket``.  ``page_tokens == max_seq``
                         degenerates to a whole-layer spill unit — the
                         bench ablation baseline.
    ``resident_pages``   host KV budget directly in page slots (overrides
                         ``resident_blocks``; the two are mutually
                         exclusive).  Must be >= 2 — the paged gather
                         copies page-by-page, so two slots (one pinned for
                         the copy, one turning over) already stream any
                         window length.
    """

    batch: int
    max_seq: int
    bucket: int = 64
    resident_blocks: int | None = None
    page_tokens: int | None = None
    resident_pages: int | None = None

    def __post_init__(self) -> None:
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if not 1 <= self.bucket <= self.max_seq:
            raise ValueError(f"bucket must be in [1, max_seq={self.max_seq}]"
                             f", got {self.bucket}")
        if self.resident_blocks is not None and self.resident_blocks < 2:
            raise ValueError(
                f"resident_blocks must be >= 2 (one slot computing, one "
                f"prefetching), got {self.resident_blocks}")
        if self.page_tokens is not None:
            if not 1 <= self.page_tokens <= self.max_seq:
                raise ValueError(
                    f"page_tokens must be in [1, max_seq={self.max_seq}], "
                    f"got {self.page_tokens}")
            if (self.bucket % self.page_tokens != 0
                    and self.page_tokens % self.bucket != 0):
                raise ValueError(
                    f"page_tokens ({self.page_tokens}) must align with the "
                    f"time bucket ({self.bucket}): one must divide the "
                    f"other, so gathered windows cover whole pages")
        if self.resident_pages is not None:
            if self.resident_blocks is not None:
                raise ValueError(
                    "pass resident_blocks or resident_pages, not both "
                    "(they size the same page-slot budget)")
            if self.resident_pages < 2:
                raise ValueError(
                    f"resident_pages must be >= 2 (one page pinned for a "
                    f"copy, one turning over), got {self.resident_pages}")

    @property
    def page_size(self) -> int:
        """Tokens per KV page (the spill/refill granularity)."""
        return self.bucket if self.page_tokens is None else self.page_tokens

    @property
    def pages_per_seq(self) -> int:
        """Pages covering one request's full ``max_seq`` extent."""
        return -(-self.max_seq // self.page_size)

    def page_budget(self, n_blocks: int) -> int:
        """Resolved page-slot budget for ``n_blocks`` cached layers."""
        total = n_blocks * self.pages_per_seq
        if self.resident_pages is not None:
            return min(self.resident_pages, total)
        if self.resident_blocks is not None:
            return min(self.resident_blocks * self.pages_per_seq, total)
        return total

    def bucket_len(self, length: int) -> int:
        """Device-cache time extent covering ``length`` positions."""
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        if length > self.max_seq:
            raise ValueError(f"length {length} exceeds max_seq {self.max_seq}")
        return min(self.max_seq, -(-length // self.bucket) * self.bucket)


@dataclass
class KVStats(PageStats):
    """Spill-pipeline effectiveness counters (mirrors SwapStats for KV).

    The generic page counters live in :class:`~repro_torch.core.paged.PageStats`;
    the fields below are KV-only lifecycle events (slot retirement,
    spec-decode rollback)."""

    reclaims: int = 0          # pages dropped by slot retirement (no write)
    reclaim_bytes: int = 0     # bytes those reclaimed pages did NOT spill
    rollbacks: int = 0         # spec-decode rollback/commit calls
    rollback_pages: int = 0    # pages dropped past a rolled-back tail

    _FIELDS = PageStats._FIELDS + ("reclaims", "reclaim_bytes",
                                   "rollbacks", "rollback_pages")


class SpillableKVCache(PagedResidency):
    """Per-layer KV state in page-granular pool slots, spilled to SSD on
    budget.

    One instance covers one generate() call-sequence or serving session.
    The batch dimension is carved into ``slots`` independent *batch slots*
    (``slots == 1`` keeps the whole batch as one joint slot — the
    generate() path).  A (unit, slot)'s state is a sequence of *pages*,
    each one pool slot holding a
    ``(2, rows, page_tokens, kv_heads, head_dim)`` array (``[0]`` is K,
    ``[1]`` is V; ``rows`` is the whole batch for a joint cache and 1 per
    batch slot otherwise); page *p* covers absolute positions
    ``[p·page_tokens, (p+1)·page_tokens)``.  Pages materialize lazily on
    first write and are zero-filled (slot memory is recycled — stale bytes
    from a previous sequence would poison the masked softmax through
    ``0 × NaN``).

    Continuous batching (``slots > 1``): each batch slot independently
    :meth:`join`\\ s (drawn from a FIFO free list), prefills + decodes at
    its own per-slot length, and :meth:`retire`\\ s — page reclaim drops
    its dirty pages *without* a spill write, forgets its SSD keys (a
    reused slot reads zeros, never a previous request's bytes), and
    returns the slot to the free list.  :meth:`admissible` is the
    scheduler's KV-page admission check.

    The session writes via :meth:`append` / :meth:`write_prefill`, reads
    whole attended windows via :meth:`gather_window`, and hints upcoming
    units via :meth:`prefetch_window`.  See the module docstring for the
    thread contract (pinning protocol included); :meth:`join` /
    :meth:`retire` belong to the drive thread, *between* plan runs.
    """

    def __init__(self, units: list[str], page_shape: tuple, max_seq: int,
                 dtype, pool: BufferPoolBase, store: TensorStore, *,
                 resident_limit: int | None = None, slots: int = 1) -> None:
        self.units = list(units)
        self.page_shape = tuple(page_shape)
        self.page_tokens = int(self.page_shape[2])
        self.max_seq = int(max_seq)
        self.pages_per_unit = -(-self.max_seq // self.page_tokens)
        self.dtype = np.dtype(dtype)
        self.page_nbytes = int(self.dtype.itemsize *
                               np.prod(self.page_shape, dtype=np.int64))
        self.pool = pool
        self.store = store
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if slots > 1 and self.page_shape[1] != 1:
            raise ValueError(
                f"per-slot paging (slots={slots}) needs single-row pages, "
                f"got page batch dim {self.page_shape[1]} (pass the "
                f"model's kv_shape(1, page_tokens))")
        self.slots = int(slots)
        # rows in a gathered window: whole batch for a joint cache, one
        # row per batch slot otherwise
        self.batch = self.page_shape[1] if self.slots == 1 else self.slots
        total = len(self.units) * self.pages_per_unit * self.slots
        # the block table / eviction / pin / capacity machinery lives in
        # the shared paged-residency base; page key = (unit, batch_slot,
        # page_index)
        super().__init__(pool, store, pool_class=KV_CLASS,
                         total_pages=total, resident_limit=resident_limit,
                         stats=KVStats())
        # Per-slot cached-token counts.  All slots start active (the joint
        # generate() path drives them in lockstep); a serving engine
        # retires them into the free list first, then join/retire churns
        # them per request.
        # lengths/active are drive-thread state (executor-only between
        # worker quiesce points), not lock-guarded — see thread contract
        self.lengths = np.zeros(self.slots, dtype=np.int64)
        self.active: set[int] = set(range(self.slots))
        self._free: deque[int] = deque()   # guarded-by: _lock

    # -- internals -----------------------------------------------------------

    def _store_key(self, unit: str, slot: int, page: int) -> str:
        # joint caches keep the key format without a slot segment, the same
        # on-SSD layout as the reference package's joint cache
        if self.slots == 1:
            return f"kv/{unit}/p{page:04d}"
        return f"kv/{unit}/s{slot:02d}/p{page:04d}"

    # page-naming hooks for the shared residency engine: every KV page
    # shares one shape/dtype/size; the store key carries unit/slot/page
    def _store_key_of(self, key: tuple) -> str:
        return self._store_key(*key)

    def _page_shape_of(self, key: tuple) -> tuple:
        return self.page_shape

    def _page_dtype_of(self, key: tuple) -> np.dtype:
        return self.dtype

    def _page_nbytes_of(self, key: tuple) -> int:
        return self.page_nbytes

    # -- the session-facing API ----------------------------------------------

    def pages_for(self, extent: int) -> int:
        """Pages covering ``extent`` positions (capped at the per-unit
        page count)."""
        return min(-(-extent // self.page_tokens), self.pages_per_unit)

    def prefetch_window(self, unit: str,
                        extent: int) -> None:  # thread: executor
        """Hint that ``unit``'s window of ``extent`` positions is needed
        soon: issue async SSD refills for its spilled pages into free
        slots.  No-op for unknown units, non-spilled pages, or when fewer
        than two slots are free (one is kept in reserve so a concurrent
        fresh-page write can always evict its way to a slot)."""
        if unit not in self.units or extent < 1:
            return
        with self._lock:
            if self.closed:
                return
            for slot in range(self.slots):
                for p in range(self.pages_for(extent)):
                    if not self._prefetch_one((unit, slot, p)):
                        return

    def ensure_page(self, unit: str, page: int, *, slot: int = 0,
                    pin: bool = False) -> np.ndarray:  # thread: executor, h2d-worker
        """Host view of one page, resident.  Waits out an in-flight refill;
        synchronously refills a spilled page; acquires (and zero-fills) a
        fresh slot for a never-written page.  With ``pin=True`` the page is
        returned pinned (evictions skip it) — the caller MUST :meth:`unpin`
        after its copy/write; writers must also mark the page dirty before
        unpinning or the write may be lost to a clean eviction."""
        if unit not in self.units:
            raise KeyError(f"unknown KV unit {unit!r}")
        if not 0 <= page < self.pages_per_unit:
            raise ValueError(f"page {page} outside [0, "
                             f"{self.pages_per_unit}) for unit {unit!r}")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        return self._ensure((unit, slot, page), pin=pin)

    def unpin(self, unit: str, page: int, *,
              slot: int = 0) -> None:  # thread: executor, h2d-worker
        """Release one pin on a page (see :meth:`ensure_page`)."""
        self._unpin((unit, slot, page))

    def gather_window(self, unit: str, extent: int  # thread: executor, h2d-worker
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Contiguous host (K, V) arrays of shape
        ``(batch, extent, kv_heads, head_dim)`` covering positions
        ``[0, extent)`` — the attended window one ``block_step`` H2Ds.

        Pages are ensured (refilled if spilled) and copied one at a time
        under a pin, so the budget floor is two slots, not a whole window.
        Never-materialized pages read as zeros: positions ``>= length`` are
        masked by the attention kernel, but the values must still be finite
        (``0 × NaN`` would poison the masked softmax).
        """
        if unit not in self.units:
            raise KeyError(f"unknown KV unit {unit!r}")
        if not 1 <= extent <= self.max_seq:
            raise ValueError(f"extent {extent} outside [1, {self.max_seq}]")
        pt = self.page_shape[2]
        kh, d = self.page_shape[3], self.page_shape[4]
        k_out = np.zeros((self.batch, extent, kh, d), self.dtype)
        v_out = np.zeros((self.batch, extent, kh, d), self.dtype)
        rows = slice(None) if self.slots == 1 else None
        for slot in range(self.slots):
            if self.slots > 1:
                rows = slice(slot, slot + 1)
            for p in range(self.pages_for(extent)):
                with self._lock:
                    materialized = self._materialized((unit, slot, p))
                if not materialized:
                    continue    # lazily never written: stays zero
                view = self.ensure_page(unit, p, slot=slot, pin=True)
                try:
                    lo = p * pt
                    m = min(pt, extent - lo)
                    k_out[rows, lo:lo + m] = view[0][:, :m]
                    v_out[rows, lo:lo + m] = view[1][:, :m]
                finally:
                    self.unpin(unit, p, slot=slot)
        return k_out, v_out

    def _rows(self, arr: np.ndarray, slot: int) -> np.ndarray:
        """The batch rows a slot owns: everything for a joint cache, one
        row (kept 2-D-leading) per batch slot otherwise."""
        return arr if self.slots == 1 else arr[slot:slot + 1]

    def append(self, unit: str, k_new: np.ndarray,
               v_new: np.ndarray) -> None:  # thread: executor
        """Write one decoded token's K/V (``(B, 1, KH, D)``) into each
        **active** slot's tail page at that slot's own length (advance once
        per step via :meth:`advance`) — the only pages a decode step
        dirties.  Inactive slots' rows are ignored (their lanes carry
        masked garbage)."""
        targets = sorted(self.active)
        if not targets:
            raise RuntimeError("append with no active slots")
        for s in targets:
            if self.lengths[s] >= self.max_seq:
                raise ValueError(f"KV cache full: slot {s} length "
                                 f"{int(self.lengths[s])} at capacity "
                                 f"{self.max_seq}")
        for s in targets:
            page, off = divmod(int(self.lengths[s]), self.page_tokens)
            view = self.ensure_page(unit, page, slot=s, pin=True)
            try:
                view[0][:, off] = self._rows(k_new, s)[:, 0]
                view[1][:, off] = self._rows(v_new, s)[:, 0]
                with self._lock:
                    self._dirty.add((unit, s, page))
            finally:
                self.unpin(unit, page, slot=s)
        self._maybe_spill_after_use()

    def append_window(self, unit: str, k_new: np.ndarray,
                      v_new: np.ndarray) -> None:  # thread: executor
        """Write a K-token draft window's K/V (``(B, K, KH, D)``) into
        each **active** slot's pages starting at that slot's own length,
        WITHOUT advancing it — the speculative-decode verify write.  The
        window may span several pages; each touched page is dirtied.  The
        host inspects the verify logits afterwards and calls
        :meth:`rollback` with ``length + accepted`` per slot, which both
        advances the slot over the accepted prefix and drops any page the
        rejected tail had materialized.  ``K == 1`` is :meth:`append`
        minus the advance."""
        kq = int(k_new.shape[1])
        targets = sorted(self.active)
        if not targets:
            raise RuntimeError("append_window with no active slots")
        if kq < 1:
            raise ValueError(f"window must be >= 1 token, got {kq}")
        for s in targets:
            if self.lengths[s] + kq > self.max_seq:
                raise ValueError(
                    f"KV cache full: slot {s} length "
                    f"{int(self.lengths[s])} + window {kq} exceeds "
                    f"capacity {self.max_seq}")
        pt = self.page_tokens
        for s in targets:
            kr, vr = self._rows(k_new, s), self._rows(v_new, s)
            start = int(self.lengths[s])
            done = 0
            while done < kq:
                page, off = divmod(start + done, pt)
                m = min(pt - off, kq - done)
                view = self.ensure_page(unit, page, slot=s, pin=True)
                try:
                    view[0][:, off:off + m] = kr[:, done:done + m]
                    view[1][:, off:off + m] = vr[:, done:done + m]
                    with self._lock:
                        self._dirty.add((unit, s, page))
                finally:
                    self.unpin(unit, page, slot=s)
                done += m
        self._maybe_spill_after_use()

    def write_prefill(self, unit: str, k: np.ndarray, v: np.ndarray, *,
                      slots: list[int] | None = None) -> None:  # thread: executor
        """Write the prefill pass's K/V (``(B, S_bucket, KH, D)``; entries
        past the true prompt length are masked garbage, overwritten by
        later appends), scattered page by page.  ``slots`` restricts the
        scatter to the named batch slots' rows — the continuous-batching
        joiner path, where the other lanes belong to mid-flight requests
        whose pages must not be touched."""
        s_extent = k.shape[1]
        if s_extent > self.max_seq:
            raise ValueError(f"prefill extent {s_extent} exceeds capacity "
                             f"{self.max_seq}")
        targets = range(self.slots) if slots is None else slots
        pt = self.page_tokens
        for slot in targets:
            if not 0 <= slot < self.slots:
                raise ValueError(f"slot {slot} outside [0, {self.slots})")
            kr, vr = self._rows(k, slot), self._rows(v, slot)
            for p in range(-(-s_extent // pt)):
                lo = p * pt
                m = min(pt, s_extent - lo)
                view = self.ensure_page(unit, p, slot=slot, pin=True)
                try:
                    view[0][:, :m] = kr[:, lo:lo + m]
                    view[1][:, :m] = vr[:, lo:lo + m]
                    with self._lock:
                        self._dirty.add((unit, slot, p))
                finally:
                    self.unpin(unit, p, slot=slot)
        self._maybe_spill_after_use()

    # -- lengths + slot lifecycle --------------------------------------------

    @property
    def length(self) -> int:
        """Longest cached sequence (all slots agree on the joint path)."""
        return int(self.lengths.max(initial=0))

    def slot_length(self, slot: int) -> int:
        return int(self.lengths[slot])

    def set_length(self, length: int) -> None:
        """Joint-path length update: every slot in lockstep."""
        if not 0 <= length <= self.max_seq:
            raise ValueError(f"length {length} outside [0, {self.max_seq}]")
        self.lengths[:] = length

    def set_slot_length(self, slot: int, length: int) -> None:
        """One slot's length (the serving prefill lands a joiner here)."""
        if not 0 <= length <= self.max_seq:
            raise ValueError(f"length {length} outside [0, {self.max_seq}]")
        if slot not in self.active:
            raise RuntimeError(f"slot {slot} is not active")
        self.lengths[slot] = length

    def advance(self, n: int = 1) -> None:  # thread: executor
        """Advance every **active** slot by ``n`` (one decode step)."""
        for s in self.active:
            new = int(self.lengths[s]) + n
            if not 0 <= new <= self.max_seq:
                raise ValueError(f"length {new} outside [0, {self.max_seq}] "
                                 f"for slot {s}")
        for s in self.active:
            self.lengths[s] += n

    @property
    def free_slots(self) -> int:
        """Batch slots available to :meth:`join`."""
        with self._lock:
            return len(self._free)

    def admissible(self, prompt_len: int) -> bool:
        """KV-page admission check: can a request with this prompt stream
        its own attended window?  Its per-unit prompt pages plus one
        turnover slot must fit the page budget — a longer prompt would
        evict a page it is about to read *within a single gather*, every
        step, forever (thrash, not progress), so the scheduler refuses it
        terminally rather than queueing it."""
        if not 1 <= prompt_len <= self.max_seq:
            return False
        return self.pages_for(prompt_len) + 1 <= self.resident_limit

    def join(self) -> int | None:  # thread: executor
        """Claim a retired batch slot for a new request (FIFO over the
        free list); ``None`` when every slot is mid-request.  The slot
        comes back empty: length 0, no pages materialized (its previous
        request's pages were reclaimed and its SSD keys forgotten by
        :meth:`retire`, so the first gather reads zeros)."""
        with self._lock:
            if self.closed:
                raise RuntimeError("KV cache is closed")
            if not self._free:
                return None
            slot = self._free.popleft()
            self.active.add(slot)
            self.lengths[slot] = 0
            return slot

    def retire(self, slot: int) -> None:  # thread: executor
        """Retire one batch slot: reclaim its pages and return it to the
        free list.  Reclaim is the cheap half of the spill machinery —
        resident pages (dirty or not) release their pool slots *without*
        a store write, in-flight refills are waited out and dropped, and
        the slot's SSD keys are forgotten so a rejoining request can
        never read the retired request's bytes.  Drive-thread only,
        between plan runs: pages of a retiring slot must not be pinned
        (the staging worker is quiesced between runs)."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        with self._lock:
            if slot in self._free:
                raise RuntimeError(f"slot {slot} already retired")
            self.active.discard(slot)
            self.lengths[slot] = 0
            # wait out a dirty spill write mid-flight on another thread;
            # it lands the key in _spilled, which is forgotten below
            while any(k[1] == slot for k in self._evicting):
                if not self._lock.wait(timeout=30.0):
                    raise RuntimeError(
                        f"slot {slot} page stuck in eviction for 30s")
            if any(self._pinned.get(k) for k in self._slots
                   if k[1] == slot):
                raise RuntimeError(
                    f"retire({slot}) with pinned pages: retire only "
                    f"between plan runs, after staging has drained")
            fut_entries = [(k, self._futures.pop(k))
                           for k in [k for k in self._futures
                                     if k[1] == slot]]
            # popped futures no longer count toward capacity via _futures;
            # hold their slots via _in_transit until the reads settle
            self._in_transit += len(fut_entries)
            reclaimed = []
            for k in [k for k in self._slots if k[1] == slot]:
                reclaimed.append(self._slots.pop(k))
                self._use_order.remove(k)
                self._dirty.discard(k)
                self.stats.reclaims += 1
                self.stats.reclaim_bytes += self.page_nbytes
            for k in [k for k in self._spilled if k[1] == slot]:
                self._spilled.discard(k)   # SSD bytes orphaned, unreadable
            self._free.append(slot)
        for buf in reclaimed:
            buf.release()
        for _k, (buf, future) in fut_entries:
            try:
                future.result()   # the async read targets buf: settle first
            except BaseException:
                pass              # data is being discarded
            finally:
                buf.release()
        with self._lock:
            self._in_transit -= len(fut_entries)
            self.stats.reclaims += len(fut_entries)
            self.stats.reclaim_bytes += len(fut_entries) * self.page_nbytes
            self._lock.notify_all()   # freed capacity: wake slot waiters

    def rollback(self, slot: int, length: int) -> None:  # thread: executor
        """Declare ``length`` as one slot's authoritative cached extent
        and drop every page materialized past its tail.

        Two callers:

        * **spec-decode commit** — after :meth:`append_window` wrote a
          K-token draft window past ``lengths[slot]``, the host accepts
          ``c`` tokens and calls ``rollback(slot, old_length + c)``: the
          accepted prefix is kept (the slot advances over it), the
          rejected tail's pages are dropped;
        * **plain truncation** — ``length`` below the current length
          rewinds the slot (rejected slots in a mixed batch roll back
          independently while accepted slots advance).

        Pages covering ``[0, length)`` survive; the partial tail page is
        kept as-is — its bytes past ``length`` are masked by the
        attention kernel and overwritten by the next append, and for a
        spilled tail page the SSD copy still holds the only valid prefix
        bytes.  Fully-dropped pages release their pool slots without a
        store write, their in-flight refills are settled and discarded,
        and their SSD keys are **forgotten**: a dirty page that spilled
        while it still held rejected draft tokens must never resurrect
        those bytes on a later refill (``rollback_pages`` counts every
        drop).  Unlike :meth:`retire`, a dropped page pinned by an
        in-flight staged gather is *waited out*, not an error — the
        gather unpins in bounded time and reads data that was valid when
        it was staged (the accept decision only shrinks what later steps
        may attend to)."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        if not 0 <= length <= self.max_seq:
            raise ValueError(f"length {length} outside [0, {self.max_seq}]")
        keep = self.pages_for(length)

        def _dropped(keys):
            return [k for k in keys if k[1] == slot and k[2] >= keep]

        with self._lock:
            if self.closed:
                raise RuntimeError("KV cache is closed")
            if slot in self._free:
                raise RuntimeError(f"rollback of retired slot {slot}")
            # wait out (a) dirty spill writes mid-flight on another
            # thread — they land the key in _spilled, forgotten below —
            # and (b) staged-gather pins on the dropped range
            while True:
                busy = [k for k in _dropped(self._evicting)]
                busy += [k for k in _dropped(self._slots)
                         if self._pinned.get(k)]
                if not busy:
                    break
                if not self._lock.wait(timeout=30.0):
                    raise RuntimeError(
                        f"rollback({slot}, {length}) waited 30s for busy "
                        f"pages {busy!r} (mid-eviction or pinned by a "
                        f"staged gather)")
            fut_entries = [(k, self._futures.pop(k))
                           for k in _dropped(self._futures)]
            # popped futures no longer count toward capacity via
            # _futures; hold their slots via _in_transit until settled
            self._in_transit += len(fut_entries)
            dropped = []
            for k in _dropped(self._slots):
                dropped.append(self._slots.pop(k))
                self._use_order.remove(k)
                self._dirty.discard(k)
                self.stats.rollback_pages += 1
            for k in _dropped(self._spilled):
                self._spilled.discard(k)   # SSD bytes orphaned, unreadable
                self.stats.rollback_pages += 1
            self.stats.rollbacks += 1
            self.lengths[slot] = length
        for buf in dropped:
            buf.release()
        for _k, (buf, future) in fut_entries:
            try:
                future.result()   # the async read targets buf: settle first
            except BaseException:
                pass              # data is being discarded
            finally:
                buf.release()
        with self._lock:
            self._in_transit -= len(fut_entries)
            self.stats.rollback_pages += len(fut_entries)
            self._lock.notify_all()   # freed capacity: wake slot waiters

    @property
    def resident_pages(self) -> list[tuple]:
        """Sorted keys currently host-resident: ``(unit, page)`` for a
        joint cache, ``(unit, slot, page)`` otherwise."""
        with self._lock:
            keys = sorted(self._slots)
        if self.slots == 1:
            return [(u, p) for (u, _s, p) in keys]
        return keys

    # close() is inherited from PagedResidency: wait out in-flight
    # refills, return every slot; idempotent (generate()'s error path).
