"""SSD tensor stores: filesystem baseline vs the Direct NVMe engine (§IV-E).

Two engines with one interface (:class:`TensorStore`):

* :class:`FilesystemEngine` — the DeepNVMe/ZeRO-Infinity design: **one file
  per tensor** on a normal filesystem.  Every I/O pays pathname resolution,
  metadata (inode) updates, block allocation and (journaled) bookkeeping.
  We use real files, so those costs are real in this container too.

* :class:`DirectNVMeEngine` — MemAscend's design: the engine owns N raw
  block devices (here: N preallocated region files standing in for
  ``/dev/nvme*n1``), runs its **own location allocator** (a shared
  next-free-LBA counter per device), keeps a **tensor-location dictionary**
  {tensor key -> stripe extents}, and serves reads/writes by splitting each
  request into equal stripes across devices and issuing positional I/O
  (``os.pwrite``/``os.pread``) from a worker-thread pool — the
  libaio/io_uring analogue.  Striping subsumes software RAID-0, and no
  filesystem metadata is touched on the data path (the region file's blocks
  are allocated once, up front).

Both engines count bytes moved (the paper's Fig. 20 I/O-volume metric) and
wall-clock per op (Fig. 14 latency/bandwidth benchmark).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, Future
from dataclasses import dataclass, field

import numpy as np

LBA_ALIGN = 4096  # logical-block alignment for direct I/O


def _as_bytes(arr: np.ndarray) -> np.ndarray:
    """uint8 view of a contiguous array (memoryview chokes on bfloat16)."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


@dataclass
class IOStats:
    """I/O volume/latency ledger.  ``record`` is reached concurrently —
    the ``-aio`` pool runs several reads/writes at once and the direct
    engine's striped ops land from its worker pool — so the
    read-modify-write counters are lock-guarded."""

    bytes_written: int = 0    # guarded-by: _lock
    bytes_read: int = 0       # guarded-by: _lock
    n_writes: int = 0         # guarded-by: _lock
    n_reads: int = 0          # guarded-by: _lock
    write_seconds: float = 0.0  # guarded-by: _lock
    read_seconds: float = 0.0   # guarded-by: _lock
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def record(self, kind: str, nbytes: int, seconds: float) -> None:  # thread: any
        with self._lock:
            if kind == "w":
                self.bytes_written += nbytes
                self.n_writes += 1
                self.write_seconds += seconds
            else:
                self.bytes_read += nbytes
                self.n_reads += 1
                self.read_seconds += seconds

    def snapshot(self) -> dict:  # thread: any
        with self._lock:
            return {
                "bytes_written": self.bytes_written,
                "bytes_read": self.bytes_read,
                "n_writes": self.n_writes, "n_reads": self.n_reads,
                "write_seconds": self.write_seconds,
                "read_seconds": self.read_seconds,
            }


class TensorStore:
    """Common interface: named tensors on 'SSD'."""

    def __init__(self) -> None:
        self.stats = IOStats()
        # Per-instance, set here rather than as a class-attribute default:
        # a class attribute is shared by every engine until the first
        # lazy assignment shadows it, so one store's close() could tear
        # down (or miss) another's I/O threads.
        self._async_pool: ThreadPoolExecutor | None = None  # guarded-by: _async_pool_lock
        self._async_pool_lock = threading.Lock()

    # -- blocking API ---------------------------------------------------------

    def write(self, key: str, data: np.ndarray) -> None:
        raise NotImplementedError

    def read(self, key: str, out: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def read_new(self, key: str, dtype, shape) -> np.ndarray:
        out = np.empty(shape, dtype=dtype)
        return self.read(key, out)

    def contains(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self):
        raise NotImplementedError

    def close(self) -> None:
        """Shut down the lazily-created async I/O executor (idempotent).

        Engines with more resources extend this — the base class owns the
        ``-aio`` thread pool so no engine can forget it and leak up to 4
        worker threads per session open/close cycle.
        """
        with self._async_pool_lock:
            pool, self._async_pool = self._async_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- async API (the swapper overlaps I/O with compute) ---------------------

    def write_async(self, key: str, data: np.ndarray) -> Future:
        return self._pool().submit(self.write, key, data)

    def read_async(self, key: str, out: np.ndarray) -> Future:
        return self._pool().submit(self.read, key, out)

    def _pool(self) -> ThreadPoolExecutor:
        with self._async_pool_lock:
            if self._async_pool is None:
                self._async_pool = ThreadPoolExecutor(
                    max_workers=4,
                    thread_name_prefix=f"{type(self).__name__}-aio")
            return self._async_pool


# ---------------------------------------------------------------------------
# Baseline: one file per tensor on the filesystem
# ---------------------------------------------------------------------------

class FilesystemEngine(TensorStore):
    """ZeRO-Infinity-style per-tensor files (ext4 + O_DIRECT in the paper).

    ``fsync`` (default on) charges the durability cost the paper's O_DIRECT
    path pays on every offload; turning it off models a page-cache-absorbing
    configuration for comparison.
    """

    def __init__(self, root: str, *, fsync: bool = True) -> None:
        super().__init__()
        self.root = root
        self.fsync = fsync
        os.makedirs(root, exist_ok=True)
        # key -> dtype, shape, nbytes
        self._meta: dict[str, tuple[str, tuple, int]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        safe = key.replace("/", "__")
        return os.path.join(self.root, safe + ".bin")

    def write(self, key: str, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data)
        t0 = time.perf_counter()
        # open -> allocate blocks -> write -> metadata update: the whole
        # filesystem path, per tensor, per iteration.
        with open(self._path(key), "wb") as f:
            f.write(_as_bytes(data))
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self.stats.record("w", data.nbytes, time.perf_counter() - t0)
        with self._lock:
            self._meta[key] = (str(data.dtype), data.shape, data.nbytes)

    def read(self, key: str, out: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        path = self._path(key)
        with open(path, "rb") as f:
            n = f.readinto(_as_bytes(out))
        if n != out.nbytes:
            raise IOError(f"short read for {key}: {n} != {out.nbytes}")
        self.stats.record("r", out.nbytes, time.perf_counter() - t0)
        return out

    def contains(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> None:
        os.unlink(self._path(key))
        with self._lock:
            self._meta.pop(key, None)

    def keys(self):
        # Snapshot under the lock: concurrent write_async completions
        # mutate _meta while a checkpoint enumerates it, and dict
        # iteration raises on concurrent insert.
        with self._lock:
            return list(self._meta)


# ---------------------------------------------------------------------------
# MemAscend: Direct NVMe engine
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Extent:
    device: int
    offset: int
    length: int


class _LocationAllocator:
    """Shared next-free-offset counters, one per device (paper Fig. 7).

    The paper uses a shared-memory integer per device so multiple processes
    never hand out overlapping LBAs; within this process a lock plays that
    role.  Allocation is append-only (tensors are preallocated once and
    updated in place thereafter — training-state I/O never frees).
    """

    def __init__(self, n_devices: int, capacity: int) -> None:
        self._next = [0] * n_devices   # guarded-by: _lock
        self._capacity = capacity
        self._lock = threading.Lock()

    def alloc(self, device: int, nbytes: int) -> int:
        aligned = ((nbytes + LBA_ALIGN - 1) // LBA_ALIGN) * LBA_ALIGN
        with self._lock:
            off = self._next[device]
            if off + aligned > self._capacity:
                raise IOError(
                    f"device {device} full: need {aligned} B at {off}, "
                    f"capacity {self._capacity} B")
            self._next[device] = off + aligned
            return off


class DirectNVMeEngine(TensorStore):
    """Raw-LBA striped tensor store with a worker-thread I/O pool.

    Parameters
    ----------
    root: directory where the raw 'device' region files live.
    n_devices: stripe width (the paper stripes across SSDs instead of RAID-0).
    device_capacity: bytes preallocated per device region.
    n_workers: I/O threads (the paper's multi-threaded AIO submission).
    min_stripe: don't split requests below this size — small tensors go to a
        single device, avoiding per-stripe overhead.
    """

    def __init__(self, root: str, *, n_devices: int = 2,
                 device_capacity: int = 1 << 30, n_workers: int = 4,
                 min_stripe: int = 1 << 20) -> None:
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.n_devices = n_devices
        self.min_stripe = min_stripe
        self._fds: list[int] = []
        for d in range(n_devices):
            path = os.path.join(root, f"nvme{d}.raw")
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            os.ftruncate(fd, device_capacity)  # preallocate the region once
            self._fds.append(fd)
        self._alloc = _LocationAllocator(n_devices, device_capacity)
        # tensor-location dictionary: key -> (dtype, shape, [extents])
        self._locations: dict[str, tuple[str, tuple, list[Extent]]] = {}  # guarded-by: _loc_lock
        self._loc_lock = threading.Lock()
        self._workers = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="direct-nvme")
        self._rr = 0  # round-robin start device  # guarded-by: _rr_lock
        self._rr_lock = threading.Lock()

    # -- placement --------------------------------------------------------------

    def _plan_extents(self, nbytes: int) -> list[Extent]:
        """Split a request into per-device stripes and allocate LBAs."""
        if nbytes <= self.min_stripe or self.n_devices == 1:
            # Reached from concurrent write_async workers: the bump must be
            # atomic or lost updates skew the round-robin balance.
            with self._rr_lock:
                dev = self._rr % self.n_devices
                self._rr += 1
            return [Extent(dev, self._alloc.alloc(dev, nbytes), nbytes)]
        per = -(-nbytes // self.n_devices)
        per = ((per + LBA_ALIGN - 1) // LBA_ALIGN) * LBA_ALIGN
        extents, pos = [], 0
        for dev in range(self.n_devices):
            if pos >= nbytes:
                break
            length = min(per, nbytes - pos)
            extents.append(Extent(dev, self._alloc.alloc(dev, length), length))
            pos += length
        return extents

    def _extents_for(self, key: str, data: np.ndarray) -> list[Extent]:
        with self._loc_lock:
            entry = self._locations.get(key)
            if entry is not None:
                dtype, shape, extents = entry
                if sum(e.length for e in extents) != data.nbytes:
                    raise ValueError(
                        f"size change for {key}: {data.nbytes} vs recorded "
                        f"{sum(e.length for e in extents)}")
                return extents
        extents = self._plan_extents(data.nbytes)
        with self._loc_lock:
            self._locations[key] = (str(data.dtype), data.shape, extents)
        return extents

    # -- I/O ---------------------------------------------------------------------

    def _rw_striped(self, kind: str, extents: list[Extent], buf: memoryview) -> None:
        def one(extent: Extent, piece: memoryview) -> None:
            fd = self._fds[extent.device]
            if kind == "w":
                written = os.pwrite(fd, piece, extent.offset)
                if written != len(piece):
                    raise IOError(f"short pwrite: {written}/{len(piece)}")
            else:
                data = os.pread(fd, len(piece), extent.offset)
                if len(data) != len(piece):
                    raise IOError(
                        f"short pread on device {extent.device} at offset "
                        f"{extent.offset}: got {len(data)} of "
                        f"{len(piece)} B (region truncated or extent "
                        f"beyond preallocated capacity)")
                piece[:] = data

        pos = 0
        futures = []
        for e in extents:
            futures.append(self._workers.submit(one, e, buf[pos:pos + e.length]))
            pos += e.length
        for f in futures:
            f.result()

    def write(self, key: str, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data)
        extents = self._extents_for(key, data)
        t0 = time.perf_counter()
        self._rw_striped("w", extents, memoryview(_as_bytes(data)))
        self.stats.record("w", data.nbytes, time.perf_counter() - t0)

    def read(self, key: str, out: np.ndarray) -> np.ndarray:
        with self._loc_lock:
            entry = self._locations.get(key)
        if entry is None:
            raise KeyError(f"tensor {key!r} not in location dictionary")
        _, _, extents = entry
        total = sum(e.length for e in extents)
        if total != out.nbytes:
            raise ValueError(f"read size mismatch for {key}: {out.nbytes} vs {total}")
        t0 = time.perf_counter()
        self._rw_striped("r", extents, memoryview(_as_bytes(out)))
        self.stats.record("r", out.nbytes, time.perf_counter() - t0)
        return out

    def contains(self, key: str) -> bool:
        with self._loc_lock:
            return key in self._locations

    def delete(self, key: str) -> None:
        # Raw-LBA space is append-allocated; delete only drops the mapping
        # (training-state tensors are never actually freed mid-run).
        with self._loc_lock:
            self._locations.pop(key)

    def keys(self):
        with self._loc_lock:
            return list(self._locations)

    def close(self) -> None:
        self._workers.shutdown(wait=True)
        super().close()           # the base-class -aio pool, once, here
        for fd in self._fds:
            os.close(fd)
        self._fds = []
