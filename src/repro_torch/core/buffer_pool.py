"""Parameter buffer pools: the paper's §III-A (problem) and §IV-B (fix).

SSD-offloaded training streams layer weights SSD→host→device with several
transformer blocks "in flight" (prefetch depth N).  The host staging region
is a *pool* of pinned buffers:

* **FixedBufferPool** (ZeRO-Infinity baseline): every slot is sized to the
  *largest* tensor in the model — almost always the embedding
  (vocab × hidden).  FFN/attention tensors are 10–100× smaller, so the pool
  carries massive internal fragmentation (paper: 70.82% for Llama-3 8B).

* **AdaptiveBufferPool** (MemAscend): one subpool per *shape class*
  (embed/LM-head, FFN projections, KV projections, QO projections, expert
  FFNs, SSM params, ...), each slot sized exactly to its class.  Following
  the paper, the subpools live inside ONE monolithic arena allocated up
  front, with a hashtable of {key -> (offset, size)} metadata, so management
  cost matches the baseline.

Both pools draw their arena through a pinned allocator
(:mod:`repro_torch.core.pinned_alloc`), so the pow2-vs-exact policy compounds with
the pool policy exactly as in the paper's Fig. 8.

The census describing "what tensors does one model stream, and how many are
concurrently live" comes from the model config
(:func:`repro_torch.configs.base.ModelConfig.pool_census`).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

from .pinned_alloc import PinnedAllocatorBase, PinnedBuffer


@dataclass(frozen=True)
class ShapeClass:
    """One class of streamed tensors.

    ``per_block``:  tensors of this class needed per in-flight transformer
                    block (0 for standalone classes like the embedding).
    ``standalone``: tensors of this class that exist once per model and need
                    a dedicated slot (embedding, LM head).
    """

    name: str
    nbytes: int          # max payload bytes of a tensor in this class
    per_block: int = 0
    standalone: int = 0

    def slots(self, inflight_blocks: int) -> int:
        return self.per_block * inflight_blocks + self.standalone


# Shape class of KV-cache page slots (offloaded cached decode).  KV state
# streams through the same arena as the weights it attends against, but its
# slots are *persistent across steps* (a SpillableKVCache keeps them checked
# out and spills cold time-axis pages to SSD) rather than released at H2D.
# The same name doubles as the staged-KV device-slot class in the overlap
# executor's DeviceSlots budget.
KV_CLASS = "kv"


@dataclass(frozen=True)
class PoolCensus:
    """Shape-class census for one model (one data-parallel shard thereof)."""

    classes: tuple[ShapeClass, ...]
    inflight_blocks: int = 2   # prefetch depth N (paper uses small N)

    @property
    def max_tensor_bytes(self) -> int:
        return max(c.nbytes for c in self.classes)

    @property
    def total_slots(self) -> int:
        return sum(c.slots(self.inflight_blocks) for c in self.classes)

    def scaled(self, shard_count: int) -> "PoolCensus":
        """Census for one of ``shard_count`` ZeRO parameter partitions."""
        return PoolCensus(
            tuple(ShapeClass(c.name, -(-c.nbytes // shard_count), c.per_block,
                             c.standalone) for c in self.classes),
            self.inflight_blocks)

    def with_kv(self, nbytes: int, slots: int) -> "PoolCensus":
        """Census extended with ``slots`` dedicated KV-cache slots of
        ``nbytes`` each (one slot holds one time-axis *page* of one
        layer's K+V state — ``DecodeSpec.page_size`` tokens).

        The slots are standalone — their count is the *host-residency
        budget* for cached decode, not a per-inflight-block multiple; pages
        beyond it spill to SSD (see :mod:`repro_torch.core.kv_cache`)."""
        if nbytes <= 0 or slots <= 0:
            raise ValueError(f"kv census needs nbytes>0 and slots>0, got "
                             f"nbytes={nbytes}, slots={slots}")
        if any(c.name == KV_CLASS for c in self.classes):
            raise ValueError(f"census already has a {KV_CLASS!r} class")
        return PoolCensus(
            self.classes + (ShapeClass(KV_CLASS, nbytes, standalone=slots),),
            self.inflight_blocks)


class PoolBuffer:
    """A checked-out pool slot; payload is a slice of the arena."""

    __slots__ = ("pool", "class_name", "slot_index", "offset", "capacity",
                 "requested", "tag", "released")

    def __init__(self, pool, class_name, slot_index, offset, capacity,
                 requested, tag):
        self.pool = pool
        self.class_name = class_name
        self.slot_index = slot_index
        self.offset = offset
        self.capacity = capacity
        self.requested = requested
        self.tag = tag
        self.released = False

    def view(self, dtype, shape):
        """Typed numpy view of this slot (numpy-backed pools only)."""
        import numpy as np
        arena = self.pool.arena
        if arena is None:
            raise RuntimeError("accounting-mode pool has no storage")
        nbytes = int(np.dtype(dtype).itemsize * np.prod(shape, dtype=np.int64))
        if nbytes > self.capacity:
            raise ValueError(
                f"view {nbytes} B > slot capacity {self.capacity} B "
                f"(class {self.class_name})")
        return arena[self.offset:self.offset + nbytes].view(dtype).reshape(shape)

    def release(self) -> None:
        self.pool.release(self)


class BufferPoolBase:
    """Slot management over a single monolithic pinned arena."""

    def __init__(self, census: PoolCensus, allocator: PinnedAllocatorBase,
                 *, name: str = "param_buffer_pool") -> None:
        self.census = census
        self.allocator = allocator
        self.name = name
        self._lock = threading.Condition()
        # subclass fills these (slot sizes/counts are immutable once
        # _layout returns; only the free lists mutate afterwards):
        self._slot_size: dict[str, int] = {}       # class -> slot bytes
        self._free_slots: dict[str, list[tuple[int, int]]] = {}  # guarded-by: _lock
        self._total_slots: dict[str, int] = {}
        self._layout()  # -> sets the above + self.pool_bytes
        self._arena_buf: PinnedBuffer = self.allocator.alloc(
            self.pool_bytes, tag=name)
        # fragmentation accounting
        self.in_use_payload = 0        # guarded-by: _lock
        self.peak_in_use_payload = 0   # guarded-by: _lock
        self.in_use_reserved = 0       # guarded-by: _lock
        self.peak_in_use_reserved = 0  # guarded-by: _lock
        # hashtable metadata, as in the paper: tag -> live PoolBuffers.
        # A tag can be checked out more than once concurrently (a unit's
        # forward ticket still staging while its backward re-fetch is
        # issued inside a deep lookahead window), so each entry is a list —
        # a plain {tag: buf} map silently overwrote the first buffer's
        # record and the first release then dropped the wrong one.
        self._live: dict[str, list[PoolBuffer]] = {}  # guarded-by: _lock

    # -- subclass interface --------------------------------------------------

    def _layout(self) -> None:  # analyze: pre-share
        raise NotImplementedError

    def _class_for(self, class_name: str) -> str:
        """Map a request's shape class to the backing slot class."""
        raise NotImplementedError

    # -- API -----------------------------------------------------------------

    @property
    def arena(self):
        return self._arena_buf.array  # None in accounting mode

    def acquire(self, class_name: str, nbytes: int, *, tag: str = "",
                timeout: float | None = 30.0) -> PoolBuffer:  # thread: any
        """Check out a slot able to hold ``nbytes`` of class ``class_name``.

        Blocks until a slot frees up (the prefetch pipeline naturally
        backpressures on pool capacity, as in ZeRO-Infinity).
        """
        slot_class = self._class_for(class_name)
        size = self._slot_size[slot_class]
        if nbytes > size:
            raise ValueError(
                f"tensor {tag!r} ({nbytes} B) exceeds slot size {size} B of "
                f"class {slot_class!r}")
        with self._lock:
            ok = self._lock.wait_for(
                lambda: bool(self._free_slots[slot_class]), timeout=timeout)
            if not ok:
                raise TimeoutError(
                    f"buffer pool exhausted for class {slot_class!r} "
                    f"({self._total_slots[slot_class]} slots)")
            idx, offset = self._free_slots[slot_class].pop()
            buf = PoolBuffer(self, slot_class, idx, offset, size, nbytes, tag)
            self.in_use_payload += nbytes
            self.in_use_reserved += size
            self.peak_in_use_payload = max(self.peak_in_use_payload,
                                           self.in_use_payload)
            self.peak_in_use_reserved = max(self.peak_in_use_reserved,
                                            self.in_use_reserved)
            if tag:
                self._live.setdefault(tag, []).append(buf)
            return buf

    def release(self, buf: PoolBuffer) -> None:  # thread: any
        with self._lock:
            if buf.released:
                raise ValueError(f"double release of pool slot {buf.tag!r}")
            buf.released = True
            self._free_slots[buf.class_name].append((buf.slot_index, buf.offset))
            self.in_use_payload -= buf.requested
            self.in_use_reserved -= buf.capacity
            live = self._live.get(buf.tag)
            if live is not None:
                with contextlib.suppress(ValueError):
                    live.remove(buf)    # this buffer's record, not the tag's
                if not live:
                    del self._live[buf.tag]
            self._lock.notify_all()

    def close(self) -> None:
        self._arena_buf.free()

    # -- reporting -------------------------------------------------------------

    def fragmentation(self) -> float:  # thread: any
        """Internal fragmentation: 1 − (peak payload / pool size).

        This is the paper's metric: the pool reserves ``pool_bytes`` but the
        maximum payload ever resident is ``peak_in_use_payload``.
        """
        with self._lock:
            return self._fragmentation_locked()

    def _fragmentation_locked(self) -> float:  # analyze: holds(_lock)
        if self.pool_bytes == 0:
            return 0.0
        return 1.0 - self.peak_in_use_payload / self.pool_bytes

    def stats(self) -> dict:  # thread: any
        # Snapshot under the lock: a mid-acquire read tore peak counters
        # against the free-list (observed as transient >100% utilisation
        # in metrics sampled from the serve scheduler thread).
        with self._lock:
            return {
                "pool_bytes": self.pool_bytes,
                "arena_reserved_bytes": self._arena_buf.capacity,
                "peak_in_use_payload": self.peak_in_use_payload,
                "peak_in_use_reserved": self.peak_in_use_reserved,
                "fragmentation": self._fragmentation_locked(),
                "slots": dict(self._total_slots),
                "slot_size": dict(self._slot_size),
            }


class FixedBufferPool(BufferPoolBase):
    """ZeRO-Infinity baseline: every slot sized to the largest tensor."""

    SLOT_CLASS = "__monolithic__"

    def _layout(self) -> None:  # analyze: pre-share
        slab = self.census.max_tensor_bytes
        n = self.census.total_slots
        self._slot_size = {self.SLOT_CLASS: slab}
        self._total_slots = {self.SLOT_CLASS: n}
        self._free_slots = {
            self.SLOT_CLASS: [(i, i * slab) for i in reversed(range(n))]}
        self.pool_bytes = slab * n

    def _class_for(self, class_name: str) -> str:
        return self.SLOT_CLASS


class AdaptiveBufferPool(BufferPoolBase):
    """MemAscend: per-shape-class subpools inside one arena (paper §IV-B)."""

    def _layout(self) -> None:  # analyze: pre-share
        self._slot_size = {}
        self._total_slots = {}
        self._free_slots = {}
        offset = 0
        for cls in self.census.classes:
            n = cls.slots(self.census.inflight_blocks)
            if n == 0:
                continue
            self._slot_size[cls.name] = cls.nbytes
            self._total_slots[cls.name] = n
            slots = []
            for i in reversed(range(n)):
                slots.append((i, offset + i * cls.nbytes))
            self._free_slots[cls.name] = slots
            offset += n * cls.nbytes
        self.pool_bytes = offset

    def _class_for(self, class_name: str) -> str:
        if class_name not in self._slot_size:
            raise KeyError(
                f"unknown shape class {class_name!r}; census has "
                f"{sorted(self._slot_size)}")
        return class_name
