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

The streamed step is split into three halves so the session's Adam stage
can pipeline them across threads (SSDTrain, arXiv 2408.10013, hides the
state I/O the same way):

* :meth:`OffloadedAdam.issue_subgroup`  — acquire one buffer of the
  **double-buffered staging arena** and read (master, m, v) into its fp32
  views (from the state-prefetch thread, the three reads side by side on
  the optimizer's read pool),
* :meth:`OffloadedAdam.compute_subgroup` — :func:`adam_update` in place on
  the staged fp32 state (optimizer thread),
* :meth:`OffloadedAdam.commit_subgroup_async` — truncate + write back
  master/m/v and the fresh compute-precision weights on the optimizer's
  write-back pool (the four writes side by side), bump the I/O ledger,
  release the staging buffer from the last write's completion callback.

A subgroup's transfers run side by side because one copy thread moves a
fraction of the host's memory bandwidth, and copies in flight together
add up (numpy releases the GIL while it copies).

:meth:`step_subgroup` remains the synchronous composition of the three.
The arena (2 buffers × (3 × max-subgroup fp32 + a truncation scratch)) is
tracker-charged up front; half-precision truncation casts into the
accounted scratch region.
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from dataclasses import dataclass

import numpy as np

from ..kernels.host_adam import host_adam_f32
from . import trace
from .dtypes import (BF16_HOST, bf16_to_f32_, cast_host, f32_to_bf16_,
                     host_dtype)

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
                v: np.ndarray, step: int, cfg: AdamConfig) -> None:
    """In-place Adam step on fp32 working copies.

    ``master``, ``m``, ``v`` are fp32 views; callers holding bf16 state
    upcast before and truncate after (exactly the paper's direct-truncation
    scheme).  ``grad`` is fp32 (already unscaled).

    Runs :func:`repro_torch.kernels.host_adam.host_adam_f32` on
    :func:`~repro_torch.kernels.host_adam.threads_for` threads: the bits
    of :func:`adam_update_plain` and of the reference's ``adam_update``.
    """
    master, grad, m, v = _flat_state(master, grad, m, v)
    host_adam_f32(master, grad, m, v,
                  step=step, beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
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
    """Double-buffered host staging for the pipelined Adam stage.

    Two buffers, each holding fp32 working copies of one subgroup's
    (master, m, v) plus a scratch region for half-precision truncation:
    the I/O thread reads subgroup *k+1* into one buffer while the
    optimizer thread updates subgroup *k* in the other, and the committed
    buffer is recycled once its write-back lands.

    :meth:`acquire` blocks until a buffer is free.  Deadlock-freedom:
    only the state-prefetch worker blocks here (the read pool's tasks
    never acquire), and every held buffer is released from an independent
    thread — a commit's write-completion callback on the optimizer's
    write-back pool, or the optimizer thread on error paths — never from a
    task queued behind the blocked acquire.  :meth:`close` wakes blocked
    waiters, which raise instead of hanging.
    """

    def __init__(self, max_elems: int, scratch_bytes: int, tracker,
                 component: str) -> None:
        self.max_elems = max_elems
        self.scratch_bytes = scratch_bytes
        self._tracker = tracker
        self._bufs = []
        for _ in range(2):
            self._bufs.append((
                np.empty(3 * max_elems, dtype=np.float32),
                np.empty(scratch_bytes, dtype=np.uint8),
            ))
        self._handle = tracker.alloc(
            component, 2 * (3 * max_elems * 4 + scratch_bytes),
            tag="adam_staging_arena")
        self._free = [0, 1]     # guarded-by: _cv
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
            return len(self._free) == 2

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

    Thread contract: the split halves are designed for two extra session
    threads — :meth:`issue_subgroup` runs on one I/O thread (the session's
    state-prefetch worker) and :meth:`compute_subgroup` and
    :meth:`commit_subgroup_async` on the optimizer worker, with
    :meth:`begin_step` sequenced before its subgroups on the optimizer
    worker.  One step is in flight at a time.  The I/O ledger
    (``last_io_bytes``) is lock-guarded so the training thread can read a
    coherent value mid-step.

    ``write_guard`` (optional, set by the session) is called with the base
    key before the refreshed compute weights are written — the stale-read
    guard asserting no prefetched read of those weights is still in flight.
    """

    MASTER, M, V, COMPUTE = ".master", ".m", ".v", ".compute"
    STATE = (MASTER, M, V)

    def __init__(self, store, cfg: AdamConfig, *, tracker=None,
                 component: str = "optimizer_stream") -> None:
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
        # I/O volume of the most recent step
        self.last_io_bytes = 0   # guarded-by: _io_lock

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
        """Free the staging arena's tracker charge and stop both I/O pools
        (waiting out in-flight transfers).  Idempotent; later streaming
        calls raise instead of resurrecting the arena or a pool."""
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
        views.  Runs on the state-prefetch thread, which alone blocks on
        the arena (while both buffers are in use); it hands the three reads
        to the read pool and waits for all of them.  On a failed read the
        buffer is released — after every read of the subgroup has
        finished, so none lands in a recycled buffer — before re-raising
        the first error."""
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
        """In-place :func:`adam_update` on the staged fp32 state.  Runs on
        the optimizer thread; ``grad_f32`` is already unscaled."""
        adam_update(staged.master, np.reshape(grad_f32, -1), staged.m,
                    staged.v, self.step_count, self.cfg)

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

    def commit_subgroup(self, staged: StagedSubgroup, *,
                        return_compute: bool = False
                        ) -> np.ndarray | None:  # thread: executor, optim-worker
        """Blocking commit: the async batch, waited out."""
        return self.commit_subgroup_async(
            staged, return_compute=return_compute).result()

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
        return self.commit_subgroup(staged, return_compute=True)

    def begin_step(self) -> None:  # thread: executor, optim-worker
        self.step_count += 1
        with self._io_lock:
            self.last_io_bytes = 0

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
