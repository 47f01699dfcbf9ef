"""Shared paged-residency layer: the page machinery behind both the KV
cache and the expert-weight pager.

PRs 5–9 grew a page-granular residency engine inside the KV cache — a
block table of pool slots, MRU eviction (Belady under cyclic access),
dirty tracking, pin refcounts, prefetched refills, and an in-transit
capacity ledger that keeps two ensuring threads from oversubscribing the
pool.  None of that is KV-specific: the same machinery pages any set of
fixed-shape host tensors through a bounded pinned-slot budget with SSD as
the backing tier.

This module hoists that engine into :class:`PagedResidency`, keyed by
opaque page keys, with two page classes on top:

* :class:`~repro_torch.core.kv_cache.SpillableKVCache` — keys are
  ``(unit, batch_slot, page_index)`` time-axis pages of decode state
  (read-write: decode dirties tail pages, eviction writes them back);
* :class:`ExpertPageCache` — keys are ``(unit, param_name)`` per-expert
  weight tensors of a MoE block (read-only: the SSD ``.compute`` copy the
  optimizer maintains is authoritative, so eviction is always a free
  ``clean_drop`` and a page is re-readable forever — every key is born
  spilled).

Thread contract
---------------

Same as the KV cache it was extracted from: all page/slot bookkeeping
lives under one non-reentrant lock (``_spill`` releases it around the
dirty-page store write, which only balances if no path ever acquires it
twice).  Two threads may ensure/evict concurrently (compute thread +
H2D staging worker), so a page view is only written or copied while
**pinned** — eviction skips pinned pages.  ``close`` must only run after
any staging worker has drained.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from .buffer_pool import BufferPoolBase, PoolBuffer
from .nvme import TensorStore

# Pool shape class of expert weight pages (route-aware MoE streaming).
# Expert tensors of a paged-MoE unit leave the per-block streaming census
# and become standalone page slots sized by the expert-residency budget,
# exactly as KV_CLASS slots are sized by DecodeSpec's page budget.
EXPERT_PAGE_CLASS = "expert"


@dataclass
class PageStats:
    """Spill-pipeline effectiveness counters for one page class.

    All byte counters are page-granular: ``spill_bytes`` counts only
    *dirty* page writes (``clean_drops`` pages were evicted for free —
    their bytes were already on SSD and unchanged)."""

    spills: int = 0            # dirty page written to SSD + slot released
    clean_drops: int = 0       # clean page evicted without a write
    refills: int = 0           # SSD page read back into a slot (any path)
    prefetch_refills: int = 0  # refills issued ahead of use
    prefetch_hits: int = 0     # refill already complete when asked for
    sync_refills: int = 0      # ensure found nothing in flight
    spill_bytes: int = 0
    refill_bytes: int = 0
    wait_seconds: float = 0.0  # time blocked on outstanding refills

    _FIELDS = ("spills", "clean_drops", "refills", "prefetch_refills",
               "prefetch_hits", "sync_refills", "spill_bytes",
               "refill_bytes", "wait_seconds")

    def snapshot(self) -> dict:
        return {k: getattr(self, k) for k in self._FIELDS}


class PagedResidency:
    """Page-granular residency of fixed-shape host tensors in pool slots,
    spilled to / refilled from an SSD tensor store past a slot budget.

    Subclasses name the pages: they provide the store key, shape, dtype
    and byte size of a page via the ``_page_*`` hooks, own the public API
    (which validates user-facing arguments and builds opaque keys), and
    may reach into the protected maps for lifecycle surgery the generic
    layer does not know about (slot retirement, rollback, invalidation) —
    provided they follow the same locking and ``_in_transit`` discipline.
    """

    # error-string labels; subclasses override so messages keep naming
    # the concrete cache ("KV cache is closed", "expert cache is closed")
    _cache_label = "page cache"
    _page_label = "page"

    def __init__(self, pool: BufferPoolBase, store: TensorStore, *,
                 pool_class: str, total_pages: int,
                 resident_limit: int | None, stats: PageStats) -> None:
        self.pool = pool
        self.store = store
        self.pool_class = pool_class
        self.resident_limit = total_pages if resident_limit is None else \
            min(resident_limit, total_pages)
        if self.resident_limit < total_pages and self.resident_limit < 2:
            raise ValueError(
                f"resident_limit {self.resident_limit} < 2 cannot stream "
                f"{total_pages} pages (one page pinned for a copy, one "
                f"turning over)")
        # Below budget every page stays resident; at budget, reserve two
        # slots for the (in use, prefetching) pair cycling the cold pages.
        self._keep = total_pages if self.resident_limit >= total_pages \
            else max(0, self.resident_limit - 2)
        self.stats = stats                 # guarded-by: _lock
        self.closed = False                # guarded-by: _lock
        # A Condition, not a bare Lock: with two ensuring threads (compute
        # + staging worker) capacity can be transiently held entirely by
        # in-flight refills and mid-read ensures — a thread needing a slot
        # then waits for the next land/unpin/spill instead of failing.
        # Backed by a NON-reentrant Lock on purpose: _spill releases it
        # around the dirty-page store write, which only balances if no
        # path ever acquires it twice (an accidental nested acquire should
        # deadlock loudly, not silently unlock early).
        self._lock = threading.Condition(threading.Lock())
        # every map below is page/slot bookkeeping and lives under the
        # one lock; keys are subclass-defined opaque tuples
        self._slots: dict[tuple, PoolBuffer] = {}     # guarded-by: _lock
        self._futures: dict[tuple, tuple[PoolBuffer, Future]] = {}  # guarded-by: _lock
        self._spilled: set[tuple] = set()    # guarded-by: _lock
        self._dirty: set[tuple] = set()      # guarded-by: _lock
        self._evicting: set[tuple] = set()   # guarded-by: _lock
        self._pinned: dict[tuple, int] = {}  # guarded-by: _lock
        self._use_order: list[tuple] = []    # guarded-by: _lock
        # Pages whose buffer is held by an ensure mid-read (popped out of
        # _futures / freshly acquired, not yet landed in _slots).  Two
        # threads ensure concurrently (compute + staging worker), so
        # capacity math must count these or the pool oversubscribes.
        self._in_transit = 0               # guarded-by: _lock

    # -- subclass page-naming hooks -------------------------------------------

    def _store_key_of(self, key: tuple) -> str:
        raise NotImplementedError

    def _page_shape_of(self, key: tuple) -> tuple:
        raise NotImplementedError

    def _page_dtype_of(self, key: tuple) -> np.dtype:
        raise NotImplementedError

    def _page_nbytes_of(self, key: tuple) -> int:
        raise NotImplementedError

    # -- internals -----------------------------------------------------------

    def _touch(self, key: tuple) -> None:  # analyze: holds(_lock)
        if key in self._use_order:
            self._use_order.remove(key)
        self._use_order.append(key)

    def _acquire(self, key: tuple) -> PoolBuffer:  # analyze: holds(_lock)
        # Budget is self-managed: resident + in-flight never exceeds
        # resident_limit (the census slot count), so this never blocks —
        # a pool wait here would mean the capacity ledger is wrong, and
        # the 30s acquire timeout turns that bug into a loud failure.
        return self.pool.acquire(self.pool_class, self._page_nbytes_of(key),  # analyze: ignore[lock-blocking]
                                 tag=self._store_key_of(key))

    def _free_capacity(self) -> int:  # analyze: holds(_lock)
        return (self.resident_limit - len(self._slots) - len(self._futures)
                - self._in_transit)

    def _materialized(self, key: tuple) -> bool:  # analyze: holds(_lock)
        return (key in self._slots or key in self._futures
                or key in self._spilled or key in self._evicting)

    def _try_spill_one(self, exclude: set) -> bool:  # analyze: holds(_lock)
        """Evict the most-recently-used resident page (Belady under cyclic
        access) that is neither excluded nor pinned; False when every
        resident page is pinned/excluded (the caller waits for capacity)."""
        for key in reversed(self._use_order):
            if (key in self._slots and key not in exclude
                    and not self._pinned.get(key)):
                self._spill(key)
                return True
        return False

    def _spill(self, key: tuple) -> None:  # analyze: holds(_lock)
        """Evict one resident page.  Called with the lock held; a dirty
        page's store write runs with the lock RELEASED so the other
        thread can keep gathering/appending meanwhile — the page sits in
        ``_evicting`` for the duration (materialized-but-busy: ensure
        waits it out, eviction scans cannot see it).  A failed write puts
        the page back resident + dirty: the host copy is the only one."""
        buf = self._slots.pop(key)
        self._use_order.remove(key)
        if key in self._dirty:
            self._dirty.discard(key)
            self._evicting.add(key)
            self._in_transit += 1     # slot still held during the write
            self._lock.release()
            ok = False
            try:
                view = buf.view(self._page_dtype_of(key),
                                self._page_shape_of(key))
                self.store.write(self._store_key_of(key), view)
                ok = True
            finally:
                self._lock.acquire()
                self._evicting.discard(key)
                self._in_transit -= 1
                if not ok:
                    # failed write: the host copy is the only one — put
                    # the page back resident (and dirty) rather than leak
                    # the slot or forget the data; the error propagates
                    self._slots[key] = buf
                    self._use_order.append(key)
                    self._dirty.add(key)
                    self._lock.notify_all()
            self.stats.spills += 1
            self.stats.spill_bytes += self._page_nbytes_of(key)
        else:
            # clean page: its bytes already live on SSD, unchanged — the
            # paged design's whole point is that this write is free
            self.stats.clean_drops += 1
        buf.release()
        self._spilled.add(key)
        self._lock.notify_all()   # freed capacity: wake slot waiters

    def _maybe_spill_after_use(self) -> None:
        """Spill-after-use: once a unit's use is done, its pages' next use
        is a full cycle away — evict MRU pages over the keep line (skipping
        pinned pages; a concurrent gather may hold one mid-copy)."""
        with self._lock:
            while len(self._slots) > self._keep:
                if not self._try_spill_one(exclude=set()):
                    break

    def _prefetch_one(self, key: tuple) -> bool:  # analyze: holds(_lock)
        """Issue one async SSD refill for a spilled page into a free slot.
        No-op (True) for non-spilled/in-flight pages; False when fewer
        than two slots are free (the caller stops prefetching — one slot
        stays in reserve so a concurrent fresh-page write can always
        evict its way to a slot)."""
        if (key not in self._spilled or key in self._slots
                or key in self._futures):
            return True
        if self._free_capacity() < 2:
            return False
        buf = self._acquire(key)
        try:
            view = buf.view(self._page_dtype_of(key),
                            self._page_shape_of(key))
            future = self.store.read_async(self._store_key_of(key), view)
        except BaseException:
            # failed issue: the key is still in _spilled (the SSD copy is
            # intact) — only the slot must go back
            buf.release()
            raise
        self._futures[key] = (buf, future)
        self._spilled.discard(key)
        self.stats.prefetch_refills += 1
        return True

    def _ensure(self, key: tuple, *,
                pin: bool = False) -> np.ndarray:  # thread: executor, h2d-worker
        """Host view of one page, resident.  Waits out an in-flight refill;
        synchronously refills a spilled page; acquires (and zero-fills) a
        fresh slot for a never-written page.  With ``pin=True`` the page is
        returned pinned (evictions skip it) — the caller MUST unpin after
        its copy/write; writers must also mark the page dirty before
        unpinning or the write may be lost to a clean eviction."""
        with self._lock:
            if self.closed:
                raise RuntimeError(f"{self._cache_label} is closed")
            # A page mid-spill (dirty write in flight on the other thread,
            # lock dropped) is materialized but in no map: wait for the
            # write to land, then take the _spilled path below.
            while key in self._evicting:
                if not self._lock.wait(timeout=30.0):
                    raise RuntimeError(
                        f"{self._page_label} {key!r} stuck in eviction "
                        f"for 30s")
            entry = self._futures.pop(key, None)
            spilled = key in self._spilled
            if entry is not None:
                buf, future = entry
                hit = future.done()
            elif key in self._slots:
                self._touch(key)
                if pin:
                    self._pinned[key] = self._pinned.get(key, 0) + 1
                return self._slots[key].view(self._page_dtype_of(key),
                                             self._page_shape_of(key))
            else:
                # Sync path: spilled (refill now) or first touch (zero).
                # When no page is evictable (all pinned, or the capacity
                # sits in other pages' in-flight refills / mid-read
                # ensures), wait: the other thread's land/unpin frees it.
                while self._free_capacity() < 1:
                    if (not self._try_spill_one(exclude={key})
                            and not self._lock.wait(timeout=30.0)):
                        raise RuntimeError(
                                f"{self._cache_label} slot wait timed out "
                                f"for page {key!r}: every slot pinned or "
                                f"in flight for 30s (budget "
                                f"{self.resident_limit})")
                buf = self._acquire(key)
                future = None
                hit = False
            self._in_transit += 1   # buf held outside _slots/_futures
        t0 = time.perf_counter()
        try:
            view = buf.view(self._page_dtype_of(key),
                            self._page_shape_of(key))
            if future is not None:
                future.result()
            elif spilled:
                self.store.read(self._store_key_of(key), view)
            else:
                view[...] = np.zeros((), self._page_dtype_of(key))  # fresh
        except BaseException:
            with self._lock:
                self._in_transit -= 1
                if future is not None:
                    # a failed prefetched refill must not forget the page:
                    # the SSD copy is still valid (_prefetch_one removed
                    # the key from _spilled when it issued the read) — the
                    # sync path below keeps _spilled until success, this
                    # mirrors it so a retry refills instead of zero-fills
                    self._spilled.add(key)
                self._lock.notify_all()
            buf.release()   # slot must not leak on a failed read
            raise
        wait = time.perf_counter() - t0
        # Counters strictly under the lock: the staging worker and the
        # compute thread both run ensure/prefetch while refills land from
        # store workers — unlocked read-modify-writes tore the ledger.
        with self._lock:
            if future is not None:
                self.stats.refills += 1
                self.stats.refill_bytes += self._page_nbytes_of(key)
                self.stats.prefetch_hits += int(hit)
            elif spilled:
                self.stats.refills += 1
                self.stats.refill_bytes += self._page_nbytes_of(key)
                self.stats.sync_refills += 1
            self.stats.wait_seconds += wait
            self._in_transit -= 1
            self._spilled.discard(key)
            self._slots[key] = buf
            self._touch(key)
            if pin:
                self._pinned[key] = self._pinned.get(key, 0) + 1
            self._lock.notify_all()   # landed page is evictable again
        return view

    def _unpin(self, key: tuple) -> None:  # thread: executor, h2d-worker
        """Release one pin on a page (see :meth:`_ensure`)."""
        with self._lock:
            n = self._pinned.get(key, 0) - 1
            if n <= 0:
                self._pinned.pop(key, None)
                self._lock.notify_all()   # page is evictable again
            else:
                self._pinned[key] = n

    def close(self) -> None:  # thread: executor
        """Wait out in-flight refills and return every slot.  Idempotent;
        runs on error paths, so nothing may leak.  Callers must drain any
        worker still gathering first (the session's abort path does) —
        close does not wait for pins."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            futures = list(self._futures.values())
            self._futures.clear()
            slots = list(self._slots.values())
            self._slots.clear()
            self._use_order.clear()
            self._dirty.clear()
            self._pinned.clear()
        for buf, future in futures:
            try:
                future.result()
            except BaseException:
                pass            # data is being discarded
            finally:
                buf.release()
        for buf in slots:
            buf.release()


class ExpertPageCache(PagedResidency):
    """Per-expert weight tensors of paged-MoE units as individually
    fetchable pages.

    Page key = ``(unit_name, param_name)`` — e.g.
    ``("block_000", "moe.expert3.w_gate")``.  The backing bytes are the
    same ``{unit}/{param}.compute`` SSD copies the offloaded optimizer
    commits after each Adam step, so:

    * every key is born **spilled** (the SSD copy exists before the first
      fetch — the session writes initial compute-precision params during
      construction);
    * pages are never dirtied — eviction is always a free ``clean_drop``,
      refill is always a plain read of the authoritative copy;
    * after a unit's optimizer commit rewrites its ``.compute`` keys, the
      session calls :meth:`invalidate_unit` so stale resident pages are
      dropped back to spilled and the next fetch rereads fresh bytes.

    Thread contract: :meth:`ensure` / :meth:`unpin` run on the executor
    and the H2D staging worker (the expert stage task pins pages while
    building the routed stack); :meth:`prefetch` runs on the executor
    inside the lookahead window; :meth:`invalidate_unit` runs on the
    executor or the optimizer worker, strictly after the unit's expert
    stage for the step has drained (the readiness-gate ordering in the
    session guarantees no pins or in-flight reads for that unit).
    """

    _cache_label = "expert cache"
    _page_label = "expert page"

    def __init__(self, pages: dict[tuple[str, str], tuple],
                 dtype, pool: BufferPoolBase, store: TensorStore, *,
                 resident_limit: int | None = None,
                 store_suffix: str = "") -> None:
        """``pages`` maps ``(unit, param_name) -> shape``; ``store_suffix``
        is appended to ``{unit}/{param}`` when addressing the store (the
        session passes the optimizer's compute-copy suffix)."""
        if not pages:
            raise ValueError("expert cache needs at least one page")
        self._shapes = {tuple(k): tuple(v) for k, v in pages.items()}
        self.dtype = np.dtype(dtype)
        self._nbytes = {k: int(self.dtype.itemsize
                               * np.prod(s, dtype=np.int64))
                        for k, s in self._shapes.items()}
        self.page_nbytes = max(self._nbytes.values())
        self.store_suffix = store_suffix
        super().__init__(pool, store, pool_class=EXPERT_PAGE_CLASS,
                         total_pages=len(self._shapes),
                         resident_limit=resident_limit, stats=PageStats())
        # the SSD compute copies are authoritative and already written:
        # every page starts spilled (fetchable), none resident
        self._spilled.update(self._shapes)

    # -- page naming ----------------------------------------------------------

    def _store_key_of(self, key: tuple) -> str:
        unit, pname = key
        return f"{unit}/{pname}{self.store_suffix}"

    def _page_shape_of(self, key: tuple) -> tuple:
        return self._shapes[key]

    def _page_dtype_of(self, key: tuple) -> np.dtype:
        return self.dtype

    def _page_nbytes_of(self, key: tuple) -> int:
        return self._nbytes[key]

    # -- the session-facing API ----------------------------------------------

    def ensure(self, unit: str, pname: str, *,
               pin: bool = False) -> np.ndarray:  # thread: executor, h2d-worker
        """Host view of one expert tensor, resident (refilled from its
        SSD compute copy if spilled).  Pin across any copy out of the
        view; unpin via :meth:`unpin`."""
        key = (unit, pname)
        if key not in self._shapes:
            raise KeyError(f"unknown expert page {key!r}")
        return self._ensure(key, pin=pin)

    def unpin(self, unit: str, pname: str) -> None:  # thread: executor, h2d-worker
        self._unpin((unit, pname))

    def prefetch(self, unit: str,
                 pnames: list[str]) -> None:  # thread: executor
        """Hint that ``unit``'s named expert tensors are needed soon:
        issue async SSD refills into free slots, stopping when fewer than
        two slots are free."""
        with self._lock:
            if self.closed:
                return
            for pname in pnames:
                key = (unit, pname)
                if key not in self._shapes:
                    continue
                if not self._prefetch_one(key):
                    return
        self._drain_over_budget()

    def _drain_over_budget(self) -> None:
        """Expert pages are persistent-cold (a unit's next use is a full
        step away), so after each batch of work trim resident pages over
        the keep line — always free clean drops."""
        self._maybe_spill_after_use()

    def release_round(self) -> None:  # thread: executor
        """End of one unit's fetch round: trim MRU pages over the keep
        line so the budget has room for the next unit's pages."""
        self._maybe_spill_after_use()

    def invalidate_unit(self, unit: str) -> None:  # thread: executor, optim-worker
        """Drop a unit's resident and in-flight pages back to spilled —
        called after the unit's optimizer commit rewrote its SSD compute
        copies, so stale host bytes are never served again.  Raises if a
        page is pinned: the caller sequences invalidation strictly after
        the unit's stage work drained."""
        with self._lock:
            if self.closed:
                return
            keys = [k for k in self._shapes if k[0] == unit]
            pinned = [k for k in keys if self._pinned.get(k)]
            if pinned:
                raise RuntimeError(
                    f"invalidate_unit({unit!r}) with pinned pages "
                    f"{pinned!r}: invalidation must run after the unit's "
                    f"expert stage drained")
            fut_entries = [(k, self._futures.pop(k))
                           for k in keys if k in self._futures]
            # popped futures no longer count toward capacity via _futures;
            # hold their slots via _in_transit until the reads settle
            self._in_transit += len(fut_entries)
            dropped = []
            for k in keys:
                if k in self._slots:
                    dropped.append(self._slots.pop(k))
                    self._use_order.remove(k)
                self._spilled.add(k)
        for buf in dropped:
            buf.release()
        for _k, (buf, future) in fut_entries:
            try:
                future.result()   # the async read targets buf: settle first
            except BaseException:
                pass              # stale data is being discarded anyway
            finally:
                buf.release()
        with self._lock:
            self._in_transit -= len(fut_entries)
            self._lock.notify_all()   # freed capacity: wake slot waiters

    @property
    def resident_pages(self) -> list[tuple]:
        """Sorted ``(unit, param)`` keys currently host-resident."""
        with self._lock:
            return sorted(self._slots)
