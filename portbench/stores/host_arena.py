"""The training cells' store: a ``TensorStore`` over one host arena.

It stands in for the SSD.  The offloaded Adam writes 14 B a parameter a
step (fp32 master, m and v, and the bf16 compute copy), about 1 GB a
second whatever the model's size; a measured window on a disk would write
tens of GB a run.  This store keeps the same key-value contract in one
anonymous mapping that is allocated and touched before the model is drawn,
so its resident bytes are a constant that the benchmark subtracts from the
process's peak.  Every other part of the trainer is the port's own.

Bytes read and written, and the seconds spent copying, land in the
``IOStats`` every store keeps.
"""

from __future__ import annotations

import mmap
import threading
import time

import numpy as np

from repro_torch.core.nvme import TensorStore

ALIGN = 4096
PAGE = 4096


def _bytes(arr: np.ndarray) -> np.ndarray:
    return arr.reshape(-1).view(np.uint8)


class HostArenaStore(TensorStore):
    """Append-placed tensors in one pre-touched arena of ``capacity``
    bytes; a key keeps its place and size once written."""

    def __init__(self, capacity: int) -> None:
        super().__init__()
        self.nbytes = -(-capacity // ALIGN) * ALIGN
        self._map = mmap.mmap(-1, self.nbytes,
                              flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
        if hasattr(mmap, "MADV_HUGEPAGE"):
            self._map.madvise(mmap.MADV_HUGEPAGE)
        self.arena = np.frombuffer(self._map, dtype=np.uint8)
        self.arena[::PAGE] = 0          # every page resident from here on
        self._lock = threading.Lock()
        self._next = 0                                 # guarded-by: _lock
        self._where: dict[str, tuple[int, int]] = {}   # guarded-by: _lock

    def _place(self, key: str, nbytes: int) -> int:
        with self._lock:
            where = self._where.get(key)
            if where is not None:
                if where[1] != nbytes:
                    raise ValueError(f"size change for {key}: {nbytes} B vs "
                                     f"{where[1]} B")
                return where[0]
            off = self._next
            end = off + -(-nbytes // ALIGN) * ALIGN
            if end > self.nbytes:
                raise IOError(f"host arena full: {key} needs {nbytes} B at "
                              f"{off} of {self.nbytes} B")
            self._next = end
            self._where[key] = (off, nbytes)
            return off

    def _span(self, key: str) -> tuple[int, int]:
        with self._lock:
            where = self._where.get(key)
        if where is None:
            raise KeyError(f"tensor {key!r} not in the host arena")
        return where

    def write(self, key: str, data: np.ndarray) -> None:
        src = _bytes(np.ascontiguousarray(data))
        off = self._place(key, src.nbytes)
        t0 = time.perf_counter()
        np.copyto(self.arena[off:off + src.nbytes], src)
        self.stats.record("w", src.nbytes, time.perf_counter() - t0)

    def read(self, key: str, out: np.ndarray) -> np.ndarray:
        off, nbytes = self._span(key)
        if out.nbytes != nbytes:
            raise ValueError(f"read size mismatch for {key}: {out.nbytes} B "
                             f"vs {nbytes} B")
        if not out.flags.c_contiguous:
            raise ValueError(f"read of {key} into a non-contiguous array")
        t0 = time.perf_counter()
        np.copyto(_bytes(out), self.arena[off:off + nbytes])
        self.stats.record("r", nbytes, time.perf_counter() - t0)
        return out

    def view(self, key: str, dtype, shape) -> np.ndarray:
        """The stored bytes of ``key`` as an array, without a copy and
        without counting I/O (the benchmark reads the trainer's state)."""
        off, nbytes = self._span(key)
        return self.arena[off:off + nbytes].view(dtype).reshape(shape)

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._where

    def delete(self, key: str) -> None:
        with self._lock:
            self._where.pop(key)

    def keys(self):
        with self._lock:
            return list(self._where)
