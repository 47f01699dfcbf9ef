"""Parameter swapper: the SSD→host prefetch pipeline (paper Fig. 5/6).

The swapper sits between the tensor store (SSD) and the device: when the
training engine is about to need block *i*'s weights, the swapper has
already (a) checked a pool slot out of the parameter buffer pool, (b) issued
the SSD read into that slot from a worker thread, and keeps (c) a bounded
number of blocks "in flight" — the prefetch depth N that sizes the pool.

The engine calls :meth:`prefetch` ahead of use and :meth:`get` at use time;
``get`` blocks on the outstanding read, hands back a typed numpy view of the
pool slot, and the engine releases the slot once the tensor has been copied
to the device (H2D), returning capacity to the pool — exactly the lifecycle
in §IV-A.

For the full-overlap executor the blocking half moves off the compute
thread: :meth:`claim` is the *issue* half of a split ``get`` — it takes
ownership of the in-flight ticket without waiting — and the H2D worker
waits the ticket itself, reporting the blocked time back through
:meth:`record_get` so the stats stay one coherent ledger no matter which
thread paid the wait.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from .buffer_pool import BufferPoolBase, PoolBuffer
from .nvme import TensorStore


@dataclass
class SwapStats:
    """Prefetch-pipeline effectiveness counters (paper Fig. 5/6 overlap).

    ``wait_seconds`` is the time :meth:`ParameterSwapper.get` spent blocked —
    pool-slot backpressure plus outstanding SSD reads.  With lookahead
    pipelining most reads complete under compute, so waits shrink,
    ``prefetch_hits`` approaches ``n_gets``, and ``sync_fallbacks`` stays 0.
    """

    n_prefetches: int = 0     # async reads actually issued
    n_gets: int = 0
    prefetch_hits: int = 0    # read had already completed when get() asked
    sync_fallbacks: int = 0   # get() found nothing in flight: synchronous read
    wait_seconds: float = 0.0

    def snapshot(self) -> dict:
        return {"n_prefetches": self.n_prefetches, "n_gets": self.n_gets,
                "prefetch_hits": self.prefetch_hits,
                "sync_fallbacks": self.sync_fallbacks,
                "wait_seconds": self.wait_seconds}


@dataclass
class FetchTicket:
    key: str
    buf: PoolBuffer
    future: Future
    dtype: object
    shape: tuple

    def wait(self) -> np.ndarray:
        self.future.result()
        return self.buf.view(self.dtype, self.shape)

    def release(self) -> None:
        self.buf.release()


class ParameterSwapper:
    """Bounded-depth asynchronous SSD→pool prefetcher."""

    def __init__(self, store: TensorStore, pool: BufferPoolBase,
                 *, class_of: dict[str, str] | None = None) -> None:
        self.store = store
        self.pool = pool
        self.class_of = class_of or {}
        self.stats = SwapStats()                    # guarded-by: _lock
        self._inflight: dict[str, FetchTicket] = {}  # guarded-by: _lock
        # keys whose SSD pread has not completed yet (count per key):
        # unlike _inflight — which claim() pops while the read may still
        # be copying — this follows the read future itself, so the
        # stale-read write guard covers the claimed-but-still-reading
        # window too
        self._reading: dict[str, int] = {}          # guarded-by: _lock
        self._lock = threading.Lock()

    def _read_done(self, key: str) -> None:  # thread: any
        # (store-worker completion callback, or the failed-issue unwind)
        with self._lock:
            n = self._reading.get(key, 0) - 1
            if n > 0:
                self._reading[key] = n
            else:
                self._reading.pop(key, None)

    def _shape_class(self, key: str, explicit: str | None) -> str:
        if explicit is not None:
            return explicit
        try:
            return self.class_of[key]
        except KeyError:
            raise KeyError(
                f"no shape class registered for {key!r}; pass class_name=") from None

    def prefetch(self, key: str, dtype, shape, *,
                 class_name: str | None = None
                 ) -> FetchTicket:  # thread: executor, h2d-worker
        """Queue an async read of ``key`` into a pool slot; idempotent.

        The h2d-worker role covers :meth:`claim`'s fallback issue on the
        staging thread; every structure touched here is lock-guarded, so
        the two roles may issue concurrently for different keys."""
        with self._lock:
            if key in self._inflight:
                return self._inflight[key]
        cls = self._shape_class(key, class_name)
        nbytes = int(np.dtype(dtype).itemsize * np.prod(shape, dtype=np.int64))
        buf = self.pool.acquire(cls, nbytes, tag=key)  # may block = backpressure
        try:
            out = buf.view(dtype, shape)
            with self._lock:
                self._reading[key] = self._reading.get(key, 0) + 1
            try:
                future = self.store.read_async(key, out)
            except BaseException:
                self._read_done(key)   # no read issued: undo the guard count
                raise
            future.add_done_callback(lambda _f: self._read_done(key))
        except BaseException:
            # Failed issue: nothing owns the slot yet — release it here or
            # it is checked out of the pool for the rest of the session.
            buf.release()
            raise
        ticket = FetchTicket(key, buf, future, dtype, shape)
        with self._lock:
            self._inflight[key] = ticket
            self.stats.n_prefetches += 1
        return ticket

    def in_flight(self, key: str) -> bool:  # thread: any
        """True if an issued read for ``key`` has not been consumed yet."""
        with self._lock:
            return key in self._inflight

    def assert_not_in_flight(self, key: str) -> None:  # thread: any
        """Stale-read guard for store writers (the Adam commit's
        compute-weight write path): a write to ``key`` while a prefetched
        read of it is still copying would race the in-flight ``pread``
        and could serve half-old bytes to the next fetch.  The session's
        per-unit readiness gates make this impossible by construction —
        this assertion locks the invariant down at the write site.  Both
        windows are covered: an unconsumed ticket (``_inflight``) and a
        claimed ticket whose pread has not completed (``_reading``, which
        follows the read future itself)."""
        with self._lock:
            outstanding = key in self._inflight or key in self._reading
        if outstanding:
            raise RuntimeError(
                f"write to {key!r} while a prefetched read of it is in "
                f"flight; the writer must wait for the fetch gate (per-unit "
                f"readiness) before refreshing weights on the store")

    def claim(self, key: str, dtype, shape, *,
              class_name: str | None = None
              ) -> tuple[FetchTicket, bool, bool]:  # thread: executor, h2d-worker
        """Issue half of a split :meth:`get`: take ownership of the
        in-flight ticket (issuing a fallback read if none) WITHOUT waiting.

        Returns ``(ticket, hit, fallback)``.  The caller owns the ticket
        from here on — it must ``wait()`` it (releasing the slot itself on
        a failed read, since drain() can no longer see the ticket) and
        report the blocked time via :meth:`record_get`.
        """
        with self._lock:
            ticket = self._inflight.pop(key, None)
        fallback = ticket is None
        hit = ticket is not None and ticket.future.done()
        if ticket is None:
            ticket = self.prefetch(key, dtype, shape, class_name=class_name)
            with self._lock:
                self._inflight.pop(key, None)
        return ticket, hit, fallback

    def record_get(self, *, hit: bool, fallback: bool,
                   wait_seconds: float) -> None:  # thread: any
        """Account one completed (claim, wait) pair — from any thread."""
        with self._lock:
            self.stats.n_gets += 1
            self.stats.prefetch_hits += int(hit)
            self.stats.sync_fallbacks += int(fallback)
            self.stats.wait_seconds += wait_seconds

    def get(self, key: str, dtype, shape, *,
            class_name: str | None = None) -> FetchTicket:  # thread: executor
        """Fetch (prefetched or not) and wait for the data to be resident."""
        t0 = time.perf_counter()
        ticket, hit, fallback = self.claim(key, dtype, shape,
                                           class_name=class_name)
        try:
            ticket.wait()
        except BaseException:
            # The ticket left _inflight in claim(), so drain() can no longer
            # see it — release the pool slot here or it leaks for the session.
            ticket.release()
            raise
        self.record_get(hit=hit, fallback=fallback,
                        wait_seconds=time.perf_counter() - t0)
        return ticket

    def drain(self) -> None:  # thread: executor
        """Wait out and release everything in flight (error paths/tests)."""
        with self._lock:
            tickets = list(self._inflight.values())
            self._inflight.clear()
        interrupt = None
        for t in tickets:
            try:
                t.wait()
            except (KeyboardInterrupt, SystemExit) as e:
                interrupt = e   # finish releasing every slot first
            except BaseException:
                # the data is being discarded; a failed read must neither
                # keep later slots checked out nor mask the error that
                # brought us here
                pass
            finally:
                t.release()
        if interrupt is not None:
            raise interrupt
