"""Host (CPU) Adam with SSD-resident state: the paper's optimizer substrate.

Port of ``src/repro/core/optimizer.py``.  ZeRO-Infinity executes the
optimizer on the CPU (DeepSpeedCPUAdam: fused AVX512/AVX2 + OpenMP) because
Adam's arithmetic intensity never justifies shipping optimizer states over
PCIe.  States live on NVMe and are streamed through host subgroup buffers.

This module provides:

* :func:`adam_update` — the update with bias correction and decoupled
  weight decay: a hand-written C++ loop split over the process's CPUs
  (:mod:`repro_torch.kernels.host_adam`, ``csrc/host_adam.cpp``), as
  DeepSpeed's C++ backend is, on fp32 working copies of fp32 or bf16
  optimizer states.  :func:`adam_update_plain` is its plain numpy
  version, the same bits.
* :class:`OffloadedAdam` — streams (master, m, v) subgroups from a
  :class:`~repro_torch.core.nvme.TensorStore`, updates on host, writes
  back, and emits new half-precision compute weights.  Counts per-iteration
  I/O volume (paper Fig. 20) and supports the **bf16 half-precision
  optimizer** mode (paper §VI-B-3a): master/m/v stored and transferred in
  bf16, cutting I/O per parameter from 26 B to 14 B.

Host bf16 is ``uint16`` bit patterns (:mod:`repro_torch.core.dtypes`):
bf16 state widens into the fp32 staging views exactly and narrows back by
round-to-nearest-even, bit for bit what the reference's ``ml_dtypes`` casts
give.

The streamed step is split into three halves, which one subgroup loop
(:meth:`OffloadedAdam.queue_unit`) composes in every overlap mode
(SSDTrain, arXiv 2408.10013, hides the state I/O the same way):

* :meth:`OffloadedAdam.issue_subgroup`  — acquire one buffer of the
  **double-buffered staging arena** and read (master, m, v) into its fp32
  views, the three reads side by side on the optimizer's read pool,
* :meth:`OffloadedAdam.compute_subgroup` — :func:`adam_update` in place on
  the staged fp32 state,
* :meth:`OffloadedAdam.commit_subgroup_async` — truncate + write back
  master/m/v and the fresh compute-precision weights on the optimizer's
  write-back pool (the four writes side by side), bump the I/O ledger,
  release the staging buffer from the last write's completion callback.

Pipelined (under full overlap) the loop runs on the session's optimizer
thread and issues subgroup *k+1* on the optimizer's own state-prefetch
thread while *k* computes; inline it runs on the caller's thread with
every subgroup in series.  A subgroup's transfers run side by side
because one copy thread moves a fraction of the host's memory bandwidth,
and copies in flight together add up (numpy releases the GIL while it
copies).

:meth:`step_subgroup` remains the synchronous composition of the three.
The arena (2 buffers × (3 × max-subgroup fp32 + a truncation scratch)) is
tracker-charged up front; half-precision truncation casts into the
accounted scratch region.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from collections import deque
from collections.abc import Callable
from concurrent.futures import Future, ThreadPoolExecutor, wait
from dataclasses import dataclass

import numpy as np

from ..kernels.host_adam import host_adam_f32
from . import trace
from .dtypes import (BF16_HOST, bf16_to_f32_, cast_host, f32_to_bf16_,
                     host_dtype)
from .overlap import OverlapStats, SerialWorker, done_future

F32 = np.dtype(np.float32)


@dataclass
class AdamConfig:
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: str = "float32"      # "float32" | "bfloat16"  (paper's bf16 mode)
    compute_dtype: str = "bfloat16"   # precision of weights used by fwd/bwd

    @property
    def state_np_dtype(self) -> np.dtype:
        """Host dtype of optimizer state (bf16 as uint16 bits)."""
        return host_dtype(self.state_dtype)

    @property
    def compute_np_dtype(self) -> np.dtype:
        """Host dtype of compute weights (bf16 as uint16 bits)."""
        return host_dtype(self.compute_dtype)

    @property
    def state_bytes_per_param(self) -> int:
        return self.state_np_dtype.itemsize


# elements an Adam chunk: two fp32 scratch chunks plus the chunk's
# master / m / v / grad stay in L2, so each array is read and written
# once a step instead of once an operation
ADAM_CHUNK = 1 << 16


def _flat_state(master, grad, m, v):
    if not all(a.flags.c_contiguous for a in (master, m, v)):
        raise ValueError("adam_update updates master, m and v in place: "
                         "they must be C-contiguous")
    return (master.reshape(-1), np.reshape(grad, -1), m.reshape(-1),
            v.reshape(-1))


def adam_update(master: np.ndarray, grad: np.ndarray, m: np.ndarray,
                v: np.ndarray, step: int, cfg: AdamConfig) -> int:
    """In-place Adam step on fp32 working copies; returns the threads it
    ran on.

    ``master``, ``m``, ``v`` are fp32 views; callers holding bf16 state
    upcast before and truncate after (exactly the paper's direct-truncation
    scheme).  ``grad`` is fp32 (already unscaled).

    Runs :func:`repro_torch.kernels.host_adam.host_adam_f32` on
    :func:`~repro_torch.kernels.host_adam.threads_for` threads: the bits
    of :func:`adam_update_plain` and of the reference's ``adam_update``.
    """
    master, grad, m, v = _flat_state(master, grad, m, v)
    return host_adam_f32(master, grad, m, v, step=step, beta1=cfg.beta1,
                         beta2=cfg.beta2, eps=cfg.eps,
                         weight_decay=cfg.weight_decay, lr=cfg.lr)


def adam_update_plain(master: np.ndarray, grad: np.ndarray, m: np.ndarray,
                      v: np.ndarray, step: int, cfg: AdamConfig) -> None:
    """:func:`adam_update` in numpy, on one thread.

    Each element gets the reference's float32 operations in the
    reference's order (``src/repro/core/optimizer.py``), so the result is
    the same bits; the arrays are walked in :data:`ADAM_CHUNK`-element
    chunks through two scratch chunks rather than as whole-array
    temporaries.
    """
    master, grad, m, v = _flat_state(master, grad, m, v)
    b1, b2 = cfg.beta1, cfg.beta2
    bias1 = 1.0 - b1 ** step
    bias2 = 1.0 - b2 ** step
    n = master.size
    t = np.empty(min(ADAM_CHUNK, n), np.float32)
    u = np.empty_like(t)
    for lo in range(0, n, ADAM_CHUNK):
        hi = min(lo + ADAM_CHUNK, n)
        g, mc, vc, p = grad[lo:hi], m[lo:hi], v[lo:hi], master[lo:hi]
        tc, uc = t[:hi - lo], u[:hi - lo]
        mc *= b1
        np.multiply(g, 1.0 - b1, out=tc)
        mc += tc
        vc *= b2
        np.square(g, out=tc)
        tc *= 1.0 - b2
        vc += tc
        np.divide(vc, bias2, out=tc)       # denom = sqrt(v / bias2) + eps
        np.sqrt(tc, out=tc)
        tc += cfg.eps
        np.divide(mc, bias1, out=uc)       # update = (m / bias1) / denom
        uc /= tc
        if cfg.weight_decay:
            np.multiply(p, cfg.weight_decay, out=tc)
            uc += tc
        uc *= cfg.lr
        p -= uc


def _narrow(src: np.ndarray, out: np.ndarray) -> None:
    """Round fp32 ``src`` into the half-precision host array ``out``
    (bf16 bits round to nearest even, as fp16's numpy cast does)."""
    if out.dtype == BF16_HOST:
        f32_to_bf16_(src, out)
    else:
        out[:] = src


@dataclass
class SubgroupMeta:
    key: str            # base key; store keys are f"{key}.master" etc.
    shape: tuple
    size: int           # element count


class _StagingArena:
    """Double-buffered host staging for the Adam stage.

    :data:`BUFFERS` buffers, each holding fp32 working copies of one
    subgroup's (master, m, v) plus a scratch region for half-precision
    truncation: the I/O thread reads subgroup *k+1* into one buffer while
    the optimizer thread updates subgroup *k* in the other, and the
    committed buffer is recycled once its write-back lands.

    :meth:`acquire` blocks until a buffer is free.  Deadlock-freedom:
    only the state-prefetch worker blocks here (the read pool's tasks
    never acquire, and an inline stage holds one buffer at a time), and
    every held buffer is released from an independent thread — a commit's
    write-completion callback on the optimizer's write-back pool, or the
    stage's thread on error paths — never from a task queued behind the
    blocked acquire.  :meth:`close` wakes blocked waiters, which raise
    instead of hanging.
    """

    BUFFERS = 2   # the staging depth: subgroup k+1 read under k's update

    def __init__(self, max_elems: int, scratch_bytes: int, tracker,
                 component: str) -> None:
        self.max_elems = max_elems
        self.scratch_bytes = scratch_bytes
        self._tracker = tracker
        self._bufs = []
        for _ in range(self.BUFFERS):
            self._bufs.append((
                np.empty(3 * max_elems, dtype=np.float32),
                np.empty(scratch_bytes, dtype=np.uint8),
            ))
        self._handle = tracker.alloc(
            component, self.BUFFERS * (3 * max_elems * 4 + scratch_bytes),
            tag="adam_staging_arena")
        self._free = list(range(self.BUFFERS))   # guarded-by: _cv
        self._cv = threading.Condition()
        self._closed = False    # guarded-by: _cv

    def acquire(self) -> int:
        with self._cv:
            while not self._free:
                if self._closed:
                    raise RuntimeError("staging arena is closed")
                self._cv.wait()
            if self._closed:
                raise RuntimeError("staging arena is closed")
            return self._free.pop()

    def release(self, index: int) -> None:
        with self._cv:
            if index in self._free:
                raise ValueError(f"double release of staging buffer {index}")
            self._free.append(index)
            self._cv.notify_all()

    def views(self, index: int, n: int):
        """(master, m, v) fp32 views of length ``n`` plus the raw scratch."""
        f32, scratch = self._bufs[index]
        me = self.max_elems
        return (f32[0:n], f32[me:me + n], f32[2 * me:2 * me + n], scratch)

    def idle(self) -> bool:
        with self._cv:
            return len(self._free) == self.BUFFERS

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()   # a blocked acquire raises, never hangs
        self._tracker.free(self._handle)


@dataclass
class StagedSubgroup:
    """One subgroup's staged state between issue and commit."""

    key: str
    buf: int                # staging-arena buffer index
    master: np.ndarray      # fp32 views into the arena
    m: np.ndarray
    v: np.ndarray
    io_read: int            # bytes read at issue (ledger half)


class OffloadedAdam:
    """Adam whose full state lives on the tensor store, streamed per subgroup.

    One "subgroup" = one parameter tensor (the paper streams optimizer-state
    subgroups through a fixed host buffer; tensor granularity matches its
    description and keeps peak host usage to the staging arena: 2 buffers of
    max-tensor-size × 3 fp32 + truncation scratch).

    Thread contract: the stage runs on one thread the caller picks (the
    session's optimizer worker under full overlap, its executor
    otherwise): :meth:`begin_step`, every :meth:`queue_unit` task and
    :meth:`end_step`, in that order.  ``pipelined`` gives the stage its
    own state-prefetch thread, on which :meth:`issue_subgroup` runs; the
    optimizer creates, drains and closes it with the read and write-back
    pools.  One step is in flight at a time.  The I/O ledger
    (``last_io_bytes``, ``completed_io_bytes``) is lock-guarded so the
    training thread can read a coherent value mid-step.  The stage's
    spans and counters go into ``stats``.

    ``write_guard`` (optional, set by the session) is called with the base
    key before the refreshed compute weights are written — the stale-read
    guard asserting no prefetched read of those weights is still in flight.
    """

    MASTER, M, V, COMPUTE = ".master", ".m", ".v", ".compute"
    STATE = (MASTER, M, V)

    def __init__(self, store, cfg: AdamConfig, *, tracker=None,
                 component: str = "optimizer_stream", pipelined: bool = False,
                 stats: OverlapStats | None = None) -> None:
        from .memory_tracker import GLOBAL_TRACKER
        self.store = store
        self.cfg = cfg
        self.tracker = tracker or GLOBAL_TRACKER
        self.component = component
        self.step_count = 0
        self.subgroups: dict[str, SubgroupMeta] = {}
        self.write_guard = None
        self._io_lock = threading.Lock()
        self._arena_lock = threading.Lock()
        self._arena: _StagingArena | None = None   # guarded-by: _arena_lock
        # The optimizer's own pools, not the store's shared "-aio" pool:
        # the next step's small, latency-critical weight prefetches must
        # never queue behind this stage's large state transfers.  Reads:
        # one worker per state tensor, so an issue's three reads run side
        # by side.  Writes: one worker per store write of a commit.
        self._read_io_pool: ThreadPoolExecutor | None = None  # guarded-by: _arena_lock
        self._io_pool: ThreadPoolExecutor | None = None  # guarded-by: _arena_lock
        self._closed = False     # guarded-by: _arena_lock
        # I/O volume of the running step, and of the last one that ended
        self.last_io_bytes = 0   # guarded-by: _io_lock
        self.completed_io_bytes = 0   # guarded-by: _io_lock
        self.stats = stats if stats is not None else OverlapStats()
        # The step's subgroup loop (queue_unit): the work list is appended
        # by the executor under _work_lock and read by the stage's thread;
        # the issue count, in-flight deque and poison are the stage
        # thread's own.  Pipelined, the state-prefetch thread issues
        # subgroups as far ahead as the arena has buffers (latch=False:
        # the stage awaits every future it submits, which delivers
        # failures); inline, the stage issues each one itself, in series.
        self._work_lock = threading.Lock()
        self._work: list[str] = []   # guarded-by: _work_lock
        self._issued = 0
        self._inflight: deque = deque()   # (work index, staged future)
        self._poison: BaseException | None = None
        self._prefetch = (SerialWorker("offload-optim-prefetch", latch=False)
                          if pipelined else None)
        # subgroups staged at once, the computing one included
        self._window = _StagingArena.BUFFERS if pipelined else 1

    # -- registration ------------------------------------------------------------

    def register(self, key: str, init_value: np.ndarray) -> None:  # thread: executor
        """Seed master weights + zero moments on the store; emit compute copy."""
        if init_value.dtype == BF16_HOST:
            raise TypeError(f"{key}: bf16 host units (uint16 bits) carry no "
                            f"fp32 master; train from fp32 units")
        sd = self.cfg.state_np_dtype
        meta = SubgroupMeta(key, init_value.shape, init_value.size)
        self.subgroups[key] = meta
        master = np.asarray(init_value, np.float32)
        self.store.write(key + self.MASTER,
                         cast_host(master, self.cfg.state_dtype))
        zeros = np.zeros(meta.shape, dtype=sd)
        self.store.write(key + self.M, zeros)
        self.store.write(key + self.V, zeros)
        self.store.write(key + self.COMPUTE,
                         cast_host(master, self.cfg.compute_dtype))

    # -- staging arena -----------------------------------------------------------

    def _scratch_bytes_per_elem(self) -> int:
        # an issue's three state reads and a commit's four writes may be
        # in flight together (on the optimizer's pools), so each
        # half-precision tensor needs its own scratch region
        sd = self.cfg.state_np_dtype
        cd = self.cfg.compute_np_dtype
        return ((3 * sd.itemsize if sd != F32 else 0)
                + (cd.itemsize if cd != F32 else 0))

    def _ensure_arena(self) -> _StagingArena:
        with self._arena_lock:
            if self._closed:
                # a step after close() must fail loudly, not resurrect a
                # fresh arena/pool behind the freed tracker charge
                raise RuntimeError("optimizer is closed")
            if self._arena is None:
                if not self.subgroups:
                    raise RuntimeError("no subgroups registered")
                max_elems = max(s.size for s in self.subgroups.values())
                self._arena = _StagingArena(
                    max_elems, max_elems * self._scratch_bytes_per_elem(),
                    self.tracker, self.component)
            return self._arena

    def staging_idle(self) -> bool:  # thread: any
        """True when no staging buffer is checked out — the leak probe."""
        with self._arena_lock:
            arena = self._arena
        return arena is None or arena.idle()

    def _lazy_pool(self, attr: str, workers: int,
                   prefix: str) -> ThreadPoolExecutor:
        with self._arena_lock:
            if self._closed:
                # a transfer racing close() must fail loudly: recreating a
                # pool here would resurrect threads nobody joins (close()
                # already shut the old one down and returned)
                raise RuntimeError("optimizer is closed")
            pool = getattr(self, attr)
            if pool is None:
                pool = ThreadPoolExecutor(max_workers=workers,
                                          thread_name_prefix=prefix)
                setattr(self, attr, pool)
            return pool

    def _pool(self) -> ThreadPoolExecutor:
        """The write-back pool: one worker per store write of a commit."""
        return self._lazy_pool("_io_pool", len(self.STATE) + 1,
                               "offload-optim-io")

    def _read_pool(self) -> ThreadPoolExecutor:
        """The read pool: one worker per state tensor of an issue."""
        return self._lazy_pool("_read_io_pool", len(self.STATE),
                               "offload-optim-read")

    def close(self) -> None:  # thread: executor
        """Stop the state-prefetch thread (running out its queue) and both
        I/O pools (waiting out in-flight transfers), then free the staging
        arena's tracker charge.  Idempotent; later streaming calls raise
        instead of resurrecting the arena or a pool."""
        if self._prefetch is not None:
            self._prefetch.close()
        with self._arena_lock:
            self._closed = True
            pools = (self._read_io_pool, self._io_pool)
            self._read_io_pool = self._io_pool = None
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=True)
        with self._arena_lock:
            arena, self._arena = self._arena, None
        if arena is not None:
            arena.close()

    # -- the streamed step, split into issue / compute / commit ------------------

    def _state_scratch(self, scratch: np.ndarray, n: int):
        """Three disjoint state-precision regions of the scratch (one per
        concurrently in-flight tensor) — only meaningful when sd != fp32."""
        sd = self.cfg.state_np_dtype
        w = n * sd.itemsize
        return [scratch[i * w:(i + 1) * w].view(sd) for i in range(3)]

    @trace.spanned("adam.read")
    def issue_subgroup(self, key: str) -> StagedSubgroup:  # thread: executor, optim-prefetch
        """Acquire a staging buffer and read (master, m, v) into its fp32
        views.  Pipelined it runs on the state-prefetch thread, which alone
        blocks on the arena (while both buffers are in use).  It hands the
        three reads to the read pool and waits for all of them.  On a
        failed read the buffer is released — after every read of the
        subgroup has finished, so none lands in a recycled buffer — before
        re-raising the first error."""
        meta = self.subgroups[key]
        sd = self.cfg.state_np_dtype
        arena = self._ensure_arena()
        with trace.span("adam.staging_acquire", key=key):
            buf = arena.acquire()
        try:
            n = meta.size
            master, m, v, scratch = arena.views(buf, n)
            # bf16 state is read at state precision into the scratch and
            # widened in place
            halves = (self._state_scratch(scratch, n) if sd != F32
                      else [None] * len(self.STATE))
            reads = [functools.partial(self._read_one, key + skey, out, half)
                     for skey, out, half in zip(self.STATE, (master, m, v),
                                                halves, strict=True)]
            self._read_side_by_side(reads)
            return StagedSubgroup(key, buf, master, m, v,
                                  io_read=3 * n * sd.itemsize)
        except BaseException:
            arena.release(buf)
            raise

    def _read_side_by_side(self, reads) -> None:  # thread: executor, optim-prefetch
        """Run ``reads`` on the read pool and wait for every one that was
        submitted, then raise the first error in key order."""
        futures = []
        try:
            pool = self._read_pool()
            for read in reads:
                futures.append(pool.submit(read))
        finally:
            wait(futures)
        for fut in futures:
            fut.result()

    def _read_one(self, skey: str, out: np.ndarray,
                  half: np.ndarray | None) -> None:  # thread: any
        """One store read of an issue into its fp32 view, through the
        state-precision ``half`` when the state is bf16."""
        with trace.span("adam.store_read", key=skey):
            if half is None:
                self.store.read(skey, out)
            else:
                self.store.read(skey, half)
                bf16_to_f32_(half, out)

    def compute_subgroup(self, staged: StagedSubgroup,
                         grad_f32: np.ndarray) -> None:  # thread: executor, optim-worker
        """In-place :func:`adam_update` on the staged fp32 state, its
        elements counted in ``adam_update_elems``, and in
        ``adam_update_split_elems`` too when the update ran on more than
        one thread.  ``grad_f32`` is already unscaled."""
        threads = adam_update(staged.master, np.reshape(grad_f32, -1),
                              staged.m, staged.v, self.step_count, self.cfg)
        n = staged.master.size
        self.stats.bump("adam_update_elems", n)
        if threads > 1:
            self.stats.bump("adam_update_split_elems", n)

    def commit_subgroup_async(self, staged: StagedSubgroup, *,
                              return_compute: bool = False
                              ) -> "Future":  # thread: executor, optim-worker
        """Submit the write-back batch — master/m/v (truncated in the
        accounted scratch when half-precision) plus the fresh compute
        weights — on the optimizer's write-back pool (``_io_pool``;
        deliberately not the store's shared pool), the four side by side,
        and return a Future that resolves once **every** write landed, the
        I/O ledger was bumped, and the staging buffer was released (all
        from the last write's completion callback).  The buffer is
        released on failure too; the future carries the first write
        error.

        The caller (the pipelined Adam stage) keeps streaming the next
        subgroups while these writes drain — write-backs overlap both the
        state-prefetch reads and the arithmetic.  If preparing the batch
        fails (the write guard fires, a cast raises), the buffer is
        released here and the error propagates synchronously."""
        meta = self.subgroups[staged.key]
        sd = self.cfg.state_np_dtype
        cd = self.cfg.compute_np_dtype
        key, n = staged.key, meta.size
        arena = self._ensure_arena()
        try:
            with trace.span("adam.commit_prep", key=key):
                if self.write_guard is not None:
                    self.write_guard(key)
                _master, _m, _v, scratch = arena.views(staged.buf, n)
                sources = [(self.MASTER, staged.master), (self.M, staged.m),
                           (self.V, staged.v)]
                state_off = 0
                if sd != F32:
                    halves = self._state_scratch(scratch, n)
                    for (_skey, src), half in zip(list(sources), halves,
                                                  strict=True):
                        _narrow(src, half)  # truncate into the scratch
                    sources = [(skey, half) for (skey, _src), half
                               in zip(sources, halves, strict=True)]
                    state_off = 3 * n * sd.itemsize
                if cd == F32:
                    compute_src = staged.master
                else:
                    compute_src = scratch[
                        state_off:state_off + n * cd.itemsize].view(cd)
                    _narrow(staged.master, compute_src)
                result = (compute_src.reshape(meta.shape).copy()
                          if return_compute else None)
        except BaseException:
            arena.release(staged.buf)
            raise
        done: Future = Future()
        done.set_running_or_notify_cancel()
        io = staged.io_read + 3 * n * sd.itemsize + n * cd.itemsize
        pending = {"left": 4, "error": None}
        agg_lock = threading.Lock()

        def _one_landed(fut) -> None:
            err = fut.exception()
            with agg_lock:
                if err is not None and pending["error"] is None:
                    pending["error"] = err
                pending["left"] -= 1
                if pending["left"]:
                    return
                error = pending["error"]
            # last write settled: nothing references the buffer any more
            arena.release(staged.buf)
            if error is None:
                with self._io_lock:
                    self.last_io_bytes += io
                done.set_result(result)
            else:
                done.set_exception(error)

        batch = sources + [(self.COMPUTE, compute_src)]
        writes = []
        try:
            pool = self._pool()
            for skey, src in batch:
                writes.append(pool.submit(self._write_back, key + skey, src))
        except BaseException:
            # submit itself failed (e.g. executor shut down mid-teardown):
            # the buffer must still come back — via the already-submitted
            # writes' callbacks if any are in flight, directly otherwise
            if writes:
                with agg_lock:
                    pending["left"] = len(writes)
                for fut in writes:
                    fut.add_done_callback(_one_landed)
            else:
                arena.release(staged.buf)
            raise
        for fut in writes:
            fut.add_done_callback(_one_landed)
        return done

    def _write_back(self, skey: str, src: np.ndarray) -> None:  # thread: any
        """One store write of a commit, on the write-back pool."""
        with trace.span("adam.write", key=skey):
            self.store.write(skey, src)

    def discard_staged(self, staged: StagedSubgroup) -> None:  # thread: any
        """Error-path release of an issued-but-never-committed buffer."""
        self._ensure_arena().release(staged.buf)

    def step_subgroup(self, key: str, grad_f32: np.ndarray) -> np.ndarray:  # thread: executor
        """Stream one subgroup synchronously: issue, compute, commit.

        Returns the refreshed compute-precision weights (also written to the
        store for the next iteration's parameter prefetch).
        """
        staged = self.issue_subgroup(key)
        try:
            self.compute_subgroup(staged, grad_f32)
        except BaseException:
            self.discard_staged(staged)
            raise
        return self.commit_subgroup_async(staged,
                                          return_compute=True).result()

    # -- the stage: one subgroup loop for every overlap mode -----------------------

    def open_step(self) -> None:  # thread: executor
        """Empty the stage's work list and window for a new step.  The
        caller runs this once the previous step's unit tasks resolved and
        before the step's first :meth:`queue_unit`."""
        with self._work_lock:
            self._work = []
        self._issued = 0
        self._inflight = deque()
        self._poison = None

    def begin_step(self) -> None:  # thread: executor, optim-worker
        self.step_count += 1
        with self._io_lock:
            self.last_io_bytes = 0

    def end_step(self) -> None:  # thread: executor, optim-worker
        """Queued after a step's last unit: its I/O becomes the completed
        step's ledger."""
        with self._io_lock:
            self.completed_io_bytes = self.last_io_bytes

    def queue_unit(self, unit: str, keys: list[str],
                   grad: Callable[[str], np.ndarray]
                   ) -> Callable[[], None]:  # thread: executor
        """Append one unit's subgroups ``keys`` to the step's work list and
        return the task that streams them, for the stage's thread;
        ``grad(key)`` gives a subgroup's unscaled fp32 gradient.  The task
        returns once every write-back of the unit landed."""
        with self._work_lock:
            lo = len(self._work)
            self._work.extend(keys)
            hi = len(self._work)
        return functools.partial(self._run_unit, unit, lo, hi, grad)

    def _run_unit(self, unit: str, lo: int, hi: int,
                  grad: Callable[[str], np.ndarray]) -> None:  # thread: executor, optim-worker
        """Work items [lo, hi): subgroup *k+1*'s (master, m, v) streams into
        the staging arena while *k*'s update runs, and *k−1*'s write-backs
        drain behind them; inline, each subgroup's write-backs land before
        the next one is read.

        On any failure the whole in-flight window is drained and the step
        is **poisoned**: the remaining unit tasks fail fast with the *same*
        exception instance, so a failure surfaces exactly once while every
        affected unit's readiness future still refuses to serve its
        un-updated weights."""
        if self._poison is not None:
            raise self._poison
        commits: list[Future] = []
        stats = self.stats
        try:
            with trace.timed(stats, "adam_stage_seconds", "adam.unit",
                             unit=unit):
                for g in range(lo, hi):
                    self._issue_upto(g + self._window)
                    idx, staged_fut = self._inflight.popleft()
                    if idx != g:    # defensive; the reset/cleanup paths
                        raise RuntimeError(  # keep issue order == work order
                            f"adam pipeline out of order: staged {idx}, "
                            f"expected {g}")
                    with trace.timed(stats, "optim_prefetch_wait_seconds",
                                     "adam.read_wait", unit=unit):
                        staged = staged_fut.result()
                    try:
                        with trace.timed(stats, "adam_update_seconds",
                                         "adam.update", key=staged.key):
                            self.compute_subgroup(staged, grad(staged.key))
                    except BaseException:
                        self.discard_staged(staged)
                        raise
                    commits.append(self.commit_subgroup_async(staged))
                    if self._prefetch is None:   # inline: in series
                        self._land(commits[-1:], unit)
                self._land(commits, unit)
        except BaseException as e:
            self._poison = e
            self._abort(commits, resume_at=hi)
            raise

    def _issue_upto(self, upto: int) -> None:  # thread: executor, optim-worker
        """Issue the work items below ``upto`` not yet issued: on the
        state-prefetch thread when pipelined, here otherwise.

        Deadlock-freedom of the arena's blocking acquire (inside the issue,
        on the state-prefetch thread): every held buffer is released by a
        write-completion callback on the write-back pool (commit), by the
        stage's thread (error paths), or by the issue's own failure
        handler — never by a task queued *behind* the blocked issue on the
        state-prefetch thread itself.  Inline, the previous subgroup's
        buffer came back before this issue, so the acquire never waits."""
        with self._work_lock:
            pending = self._work[self._issued:upto]
        for key in pending:
            if self._prefetch is not None:
                fut = self._prefetch.submit(
                    functools.partial(self.issue_subgroup, key))
            else:   # the stage's thread is then the executor
                fut = done_future(self.issue_subgroup(key))  # analyze: ignore[thread-affinity]
            self._inflight.append((self._issued, fut))
            self._issued += 1

    def _land(self, commits: list[Future], unit: str) -> None:  # thread: executor, optim-worker
        with trace.timed(self.stats, "adam_write_wait_seconds",
                         "adam.write_wait", unit=unit):
            for commit in commits:
                commit.result()

    def _abort(self, commits: list[Future], *, resume_at: int) -> None:  # thread: executor, optim-worker
        """Failure path of a unit task: wait out this unit's commits (each
        releases its own buffer), release every issued-but-never-computed
        staging buffer, and reset the issue counter to ``resume_at``."""
        for commit in commits:
            with contextlib.suppress(BaseException):
                commit.result()
        while self._inflight:
            _idx, staged_fut = self._inflight.popleft()
            try:
                staged = staged_fut.result()
            except BaseException:
                continue        # a failed issue released its own buffer
            self.discard_staged(staged)
        self._issued = resume_at

    # -- static accounting (paper Fig. 20, at any model scale) ---------------------

    @staticmethod
    def io_bytes_per_param(cfg: AdamConfig, *, include_grad_offload: bool = True) -> int:
        """Per-parameter optimizer-step I/O volume for a given precision mode.

        The paper's Fig. 20 counts everything the optimizer step moves over
        NVMe: (master, m, v) read+write at state precision, the refreshed
        compute-precision weights, and — when gradients spill to SSD — the
        gradient write+read.  ZeRO-Infinity's gradient flat buffer is fp32,
        so the bf16-optimizer mode shrinks the gradient traffic too (the
        paper transfers "parameters, gradients, and momentum in
        half-precision")."""
        s = cfg.state_bytes_per_param
        c = cfg.compute_np_dtype.itemsize
        io = 3 * s + 3 * s + c          # read m/v/master + write back + compute wts
        if include_grad_offload:
            io += 2 * s                  # grad spill w+r at state precision
        return io
