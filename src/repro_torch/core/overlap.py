"""Background-pipeline primitives for the full-overlap executor (Fig. 6).

The paper's pipeline has four legs that should all hide under compute:

  SSD→host read   — async (:class:`~repro_torch.core.swapper.
                    ParameterSwapper` lookahead prefetch),
  host→device H2D — staged by a :class:`SerialWorker` into a bounded set of
                    :class:`DeviceSlots` (the device-side double buffer),
  device→host D2H — gradient write-back enqueued on a second SerialWorker
                    (the writer thread), drained before the overflow check,
  optimizer       — step *k*'s subgroup-streamed host Adam runs on a third
                    SerialWorker, interleaved with step *k+1*'s forward
                    prefetch window (SSDTrain-style cross-step pipelining).
                    Inside that stage a fourth SerialWorker (the
                    state-prefetch worker) streams subgroup *k+1*'s
                    (master, m, v) into a double-buffered staging arena and
                    drains subgroup *k−1*'s write-backs while subgroup *k*'s
                    arithmetic runs — the Adam stage's own store I/O hides
                    under its own compute.

Cached-decode KV windows ride the same H2D staging worker: the executor
queues a page-gather + H2D task per block (the split KVReadOp's issue
half) behind that block's weight staging, bounded by a dedicated ``kv``
device-slot class, so the serving path's last synchronous transfer also
hides under the previous block's compute.

Activation checkpoints (train) ride both workers: ActSaveOp's D2H + SSD
write runs on the gradient-writer thread (idle during the forward pass),
and ActFetchOp's SSD read + H2D staging rides the H2D worker behind the
backward pass's weight staging, bounded by the dedicated
:data:`ACT_CLASS` device-slot class — block *i−1*'s checkpoint streams
back under block *i*'s ``block_bwd``.

This module holds the machinery shared by those legs; the session wires it
to the StreamPlan executor (:mod:`repro_torch.core.session`).  Everything here is
model-agnostic: a SerialWorker is just an order-preserving single-thread
task queue with latched-error semantics, and DeviceSlots is a counted
per-shape-class staging budget.

Thread contract (who may call what)
-----------------------------------

* :meth:`SerialWorker.submit` may be called from any thread (it only
  enqueues; a bounded queue blocks the *producer*), but each worker's
  tasks run strictly FIFO on its single daemon thread — tasks never need
  locks against each other, only against state shared with other threads.
* :meth:`SerialWorker.drain` / :meth:`SerialWorker.close` re-raise the
  latched first failure exactly once; callers that already delivered a
  task's exception out-of-band must :meth:`SerialWorker.consume_error` it
  first or teardown double-reports.
* :meth:`DeviceSlots.acquire` is only ever called by the single H2D
  staging worker, in fetch order; :meth:`DeviceSlots.release_all` is
  called by the executor thread (at ``ReleaseOp`` / abort).  That pairing
  is the deadlock-freedom argument: every blocked acquire sits at or
  before the worker's queue head, with all earlier units' slots already
  releasable by the live executor.
* :class:`OverlapStats` plain fields are executor-thread-only; counters
  accrued on worker threads go through
  :meth:`OverlapStats.add_worker_seconds`, which locks.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field


# Device-slot class bounding staged activation-checkpoint H2Ds (train
# backward).  Depth 2 = one checkpoint consumed by the current block_bwd
# plus one being staged for the next — the same double-buffer rotation as
# the weight classes, and the same deadlock-freedom argument: the single
# H2D worker acquires, the executor's block_bwd consume releases.
ACT_CLASS = "__act__"

# Device-slot class bounding staged expert-stack H2Ds (route-aware MoE
# paging).  Depth 2 = one unit's routed expert stacks consumed by the
# current block_moe plus one being staged for the next MoE unit — the
# same rotation and deadlock-freedom argument as ACT_CLASS.
EXPERT_CLASS = "__expert__"


def done_future(value=None) -> Future:
    """An already-resolved Future (sync-mode stand-in for a queued task)."""
    fut: Future = Future()
    fut.set_result(value)
    return fut


class SerialWorker:
    """One daemon thread executing submitted callables strictly FIFO.

    The executor's async legs all need the same contract:

    * **order**: tasks run in submission order (grad scatters must land in
      plan order; optimizer subgroups must follow their ``begin_step``),
    * **bounded memory**: ``maxsize`` backpressures the producer (the
      compute thread) instead of queueing unbounded device arrays,
    * **no lost errors**: with ``latch=True`` the first task failure is
      latched and re-raised at the next :meth:`drain` or :meth:`close` (and
      each task's own :class:`Future` carries its exception for callers
      that wait on it directly).  Workers whose every future *is* awaited
      (the H2D stage) pass ``latch=False`` so an already-delivered failure
      is not re-raised a second time at teardown; latching callers that
      deliver a failure out-of-band call :meth:`consume_error`.

    A worker is *not* a thread pool — single-threaded by design, so tasks
    need no internal locking against each other.
    """

    def __init__(self, name: str, *, maxsize: int = 0,
                 latch: bool = True) -> None:
        self.name = name
        self._q: queue.Queue = queue.Queue(maxsize)
        self._latch = latch
        self._error: BaseException | None = None   # guarded-by: _error_lock
        # Consumed error INSTANCES (strong refs, identity semantics): a
        # poisoned pipeline re-raises the same object from later tasks,
        # which must not re-latch; holding the object (not its id) keeps
        # a recycled address from masking an unrelated future failure.
        self._delivered: list[BaseException] = []  # guarded-by: _error_lock
        self._error_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                fn, fut = item
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as e:
                    fut.set_exception(e)
                    if self._latch:
                        with self._error_lock:
                            if self._error is None and not any(
                                    e is d for d in self._delivered):
                                self._error = e
            finally:
                self._q.task_done()

    def submit(self, fn) -> Future:  # thread: any
        """Queue ``fn``; blocks when the queue is full (backpressure)."""
        if self._closed:
            raise RuntimeError(f"worker {self.name!r} is closed")
        fut: Future = Future()
        self._q.put((fn, fut))
        return fut

    def consume_error(self, error: BaseException) -> None:
        """Mark ``error`` as delivered: a caller that just re-raised a task
        future's exception clears the latch so drain()/close() don't report
        the same failure again.  The instance is remembered, so a *later*
        task that fails with the very same exception object (a poisoned
        pipeline failing fast — see the session's Adam stage) can never
        re-latch a failure that was already delivered."""
        with self._error_lock:
            if not any(error is d for d in self._delivered):
                self._delivered.append(error)
            if self._error is error:
                self._error = None

    def drain(self) -> None:
        """Wait until every queued task ran; re-raise the first failure.

        The latched error is cleared once raised — error paths that drain
        again (to guarantee the queue is empty) don't see it twice.
        """
        self._q.join()
        with self._error_lock:
            error, self._error = self._error, None
        if error is not None:
            raise error

    def close(self) -> None:
        """Run out the queue, stop the thread, re-raise a latched failure.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        with self._error_lock:
            error, self._error = self._error, None
        if error is not None:
            raise error


class DeviceSlots:
    """Counted device-staging budget per shape class (the H2D double buffer).

    ``depths[cls]`` is 2 × the largest number of class-``cls`` tensors any
    single unit streams: one unit's worth resident for compute plus one
    being staged by the H2D worker.  :meth:`acquire` blocks the *worker*
    (never the compute thread) until ``ReleaseOp`` returns the older unit's
    slots, which is exactly the Fig. 6 rotation.

    Deadlock-freedom: only the single H2D worker acquires, strictly in
    fetch order, and every unit the compute thread is waiting on sits at or
    before the worker's queue head, with all earlier units already released
    — so the blocked acquire always has a live releaser.
    """

    def __init__(self, depths: dict[str, int]) -> None:
        for cls, d in depths.items():
            if d < 2:
                raise ValueError(f"device slot class {cls!r} needs depth >= "
                                 f"2 (compute + staging), got {d}")
        self._depths = dict(depths)          # immutable after init
        self._free = dict(depths)            # guarded-by: _cv
        self._cv = threading.Condition()

    def acquire(self, class_name: str) -> None:  # thread: h2d-worker
        with self._cv:
            while self._free[class_name] < 1:
                self._cv.wait()
            self._free[class_name] -= 1

    def release_all(self, class_names) -> None:  # thread: executor, h2d-worker
        """Return one slot per entry of ``class_names`` (a unit's tokens)."""
        with self._cv:
            for cls in class_names:
                if self._free[cls] >= self._depths[cls]:
                    raise ValueError(f"over-release of device slot class "
                                     f"{cls!r}")
                self._free[cls] += 1
            self._cv.notify_all()

    def idle(self) -> bool:
        """True when every slot is free — the leak probe for tests."""
        with self._cv:
            return self._free == self._depths


@dataclass
class OverlapStats:
    """Compute-thread-visible stall counters for the overlapped legs.

    ``h2d_wait_seconds`` is what :class:`~repro_torch.core.swapper.SwapStats.
    wait_seconds` is to SSD reads: the time the executor actually blocked
    at a FetchOp waiting for staged device weights.  Under full overlap the
    swapper's own wait moves onto the H2D worker thread (off the critical
    path) and this is the number that should stay near zero instead.
    ``kv_stage_wait_seconds`` is the cached-decode analogue: executor
    blocking at a KVReadOp for a staged KV window (page refill waits move
    onto the staging worker and into the KV cache's own wait ledger).

    Most fields are mutated by the single executor thread only.  The two
    worker-side counters — ``optim_prefetch_wait_seconds`` (the optimizer
    worker blocked on a state-prefetch future inside the Adam stage) and
    ``overflow_screen_seconds`` (per-region Inf/NaN screens, paid on the
    gradient-writer thread under full overlap) — are accumulated through
    :meth:`add_worker_seconds`, which locks.
    """

    fetch_seconds: float = 0.0  # total FetchOp blocking: read wait + H2D,
    #                             whichever thread originally paid it — the
    #                             mode-comparable "fetch+H2D wait" number
    h2d_gets: int = 0           # FetchOps served from the staging pipeline
    h2d_hits: int = 0           # device weights ready when the FetchOp asked
    h2d_wait_seconds: float = 0.0
    kv_stage_gets: int = 0      # KVReadOps served from the staging pipeline
    kv_stage_hits: int = 0      # KV window staged when the KVReadOp asked
    kv_stage_wait_seconds: float = 0.0  # executor blocked on staged KV
    gradwrite_drain_seconds: float = 0.0  # OverflowCheckOp writer-drain stall
    optim_gate_seconds: float = 0.0       # prefetch blocked on step k-1 Adam
    act_save_wait_seconds: float = 0.0  # executor blocked on an act save
    #                                     (ActFetchOp gating on its unit's
    #                                     still-pending save, or sync-mode
    #                                     inline D2H + store write)
    act_fetch_wait_seconds: float = 0.0  # executor blocked at an ActFetchOp
    #                                      for a staged checkpoint
    act_stage_gets: int = 0     # ActFetchOps served from the staging pipeline
    act_stage_hits: int = 0     # checkpoint staged when the ActFetchOp asked
    expert_stage_gets: int = 0  # ExpertFetchOps served from the pipeline
    expert_stage_hits: int = 0  # routed set covered by the prestaged stack
    expert_fetch_wait_seconds: float = 0.0  # executor blocked at an
    #                                         ExpertFetchOp for staged stacks
    expert_fetch_bytes: int = 0  # expert bytes copied into H2D stacks
    #                              (routed-only vs all-resident ledger);
    #                              accrued via bump() on the staging worker
    optim_prefetch_wait_seconds: float = 0.0  # Adam blocked on staged state
    overflow_screen_seconds: float = 0.0      # per-region Inf/NaN screens
    act_save_seconds: float = 0.0  # D2H + store write on the writer thread
    act_write_failures: int = 0    # SSD act writes that fell back to host
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add_worker_seconds(self, name: str, dt: float) -> None:
        """Accumulate a worker-thread stall into ``name`` (lock-guarded —
        the Adam stage and the gradient writer report from their own
        threads while the executor reads snapshots)."""
        with self._lock:
            setattr(self, name, getattr(self, name) + dt)

    def bump(self, name: str, n: int = 1) -> None:
        """Increment a worker-thread counter (lock-guarded — e.g. the
        gradient writer recording an act-write SSD fallback)."""
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def snapshot(self) -> dict:
        with self._lock:
            worker = {
                "optim_prefetch_wait_seconds": self.optim_prefetch_wait_seconds,
                "overflow_screen_seconds": self.overflow_screen_seconds,
                "act_save_seconds": self.act_save_seconds,
                "act_write_failures": self.act_write_failures}
        return {"fetch_seconds": self.fetch_seconds,
                "h2d_gets": self.h2d_gets, "h2d_hits": self.h2d_hits,
                "h2d_wait_seconds": self.h2d_wait_seconds,
                "kv_stage_gets": self.kv_stage_gets,
                "kv_stage_hits": self.kv_stage_hits,
                "kv_stage_wait_seconds": self.kv_stage_wait_seconds,
                "gradwrite_drain_seconds": self.gradwrite_drain_seconds,
                "optim_gate_seconds": self.optim_gate_seconds,
                "act_save_wait_seconds": self.act_save_wait_seconds,
                "act_fetch_wait_seconds": self.act_fetch_wait_seconds,
                "act_stage_gets": self.act_stage_gets,
                "act_stage_hits": self.act_stage_hits,
                "expert_stage_gets": self.expert_stage_gets,
                "expert_stage_hits": self.expert_stage_hits,
                "expert_fetch_wait_seconds": self.expert_fetch_wait_seconds,
                "expert_fetch_bytes": self.expert_fetch_bytes, **worker}
