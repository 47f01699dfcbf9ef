"""OffloadSession: owns the offload lifecycle and executes StreamPlans.

Port of ``src/repro/core/session.py`` (train, eval and cached-decode
modes).  One session = one open store/allocator/pool/swapper(/optimizer)
stack over an :class:`~repro_torch.core.offload_engine.OffloadableModel`; a
context manager, so the pinned arena, gradient flat buffer and in-flight
SSD reads are always drained and returned, success or error.

Execution is plan-driven (:mod:`repro_torch.core.stream_plan`) with
**lookahead-N pipelining**: at a :class:`FetchOp` the executor first issues
async SSD reads for the next ``lookahead`` units in the plan's fetch order,
then blocks only on the unit it needs now.  Depth is bounded by
``policy.inflight_blocks``, which sizes the pool (paper §IV-B).

Under ``policy.overlap`` ≠ ``"sync"`` FetchOp and KVReadOp split into an
issue half and a wait half: the ``offload-h2d`` staging worker waits out
the SSD reads, gathers the attended KV window, and copies both to the
device under the previous block's compute, double-buffered by counted
device slots.

Host-to-device copies (:meth:`OffloadSession._h2d_copy`).  On CUDA the pool
arena is page-locked, so a ``non_blocking`` copy from a slot is a DMA that
returns before it lands.  The copy runs on a side stream and records an
event; the staging thread synchronises the event before the pool slot is
released (otherwise the next SSD read could overwrite bytes still in
flight), the compute stream waits on it, and ``record_stream`` keeps the
caching allocator from handing the copy's memory to the side stream while
compute still reads it.

Training (``train_step``, the default ``mode="train"``) runs the
``compile_train`` plan: the streamed forward (each block's input saved as
its activation checkpoint), the head loss and its gradients, the reverse
backward (each block recomputed from its checkpoint under autograd), the
embedding backward, the overflow screen, the loss scaler and the host Adam
over SSD-resident state (:class:`~repro_torch.core.optimizer.OffloadedAdam`).
Under ``overlap="full"`` the gradient write-back runs on the
``offload-gradwrite`` worker and Adam on ``offload-optim`` (with its state
reads on ``offload-optim-prefetch``), so step *k*'s Adam overlaps step
*k+1*'s forward; per-unit readiness futures gate the next fetch and the
next gradient write of each unit.

Activation checkpoints (``policy.act_policy``; see
:func:`~repro_torch.core.stream_plan.resolve_act_policy`) leave the device
after each block's forward: a block's ActSaveOp copies its input to host
memory (``host``) and onward to the store (``ssd``) on the gradient-writer
thread under full overlap, inline otherwise; ``recompute`` blocks save
nothing and re-run the previous block's forward in the backward; ``device``
blocks (``offload_checkpoints=False``) keep theirs on the card.  The
backward's ActFetchOps split into issue/wait halves riding the staging
worker under a depth-2 ``ACT_CLASS`` device slot, so block *i−1*'s
checkpoint streams back under block *i*'s ``block_bwd``.  On CUDA the
checkpoint's D2H runs on the writer's side stream after an event recorded
on the compute stream when the checkpoint was bound, into page-locked
memory, and is synchronised before the device tensor is dropped; it comes
back in its own dtype, bit for bit.

Gradient write-back (:meth:`OffloadSession._write_grads`).  The executor
casts each unit's device gradients to fp32 on the compute stream and
records an event.  On CUDA the writer then, on a side stream that waits on
the event, screens every fp32 gradient tensor for Inf/NaN with the Hopper
kernel (:func:`repro_torch.kernels.ops.overflow_flag_`) into the unit's
device int32 flag, copies the tensors into the page-locked fp32 flat buffer
with ``non_blocking`` DMAs (``record_stream`` guards their memory), copies
the flag after them, and synchronises that stream's event before anything
reads the region or the flag.  On the CPU the same steps run with the
kernel's plain version.  The OverflowCheckOp barrier only ORs the per-unit
verdicts (the partition-OR invariant of :mod:`repro_torch.core.overflow`).

Serving (``mode="serve"``) has the uncached full-prefix pass
(``decode_logits``, the ``decode`` plan) and cached decode over a paged
spill-able KV cache (:mod:`repro_torch.core.kv_cache`) whose page slots
come from the same pool arena: the joint ``prefill`` / ``decode_step``;
the continuous-batching joiner ``prefill(slots=, lengths=)``, which
scatters only the joiners' pages, and ``decode_step_slots`` over per-slot
lengths; and the speculative ``verify_step`` / ``verify_step_slots``,
which step a (batch, K) draft window in one weight pass and return logits
bitwise equal to K chained steps (the window's positions run at the
step's own shapes: ``block_verify`` in the adapter, and the head here one
position at a time).

Expert paging (``policy.expert_paging`` "all" or "routed", over a model
whose MoE blocks carry per-expert pages): a MoE block splits into its
routing half, whose top-k indices come back to the host, and its expert
half, which runs over ``(E, …)`` expert stacks built **on the device**:
zeros, with only the staged experts' pages copied in from the expert page
cache's page-locked pool slots (the reference fills zero host stacks and
copies the whole stack: the same function, and the same pages counted).
``expert_fetch_bytes`` counts every page copied into a stack, a prestage
staged on a wrong prediction included, as the reference's does.  Unrouted
rows are zero and never read, so routed and all-resident residency give
the same bits.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import split_positions
from .buffer_pool import KV_CLASS
from .dtypes import cast_host, to_host, to_torch, torch_dtype
from .kv_cache import DecodeSpec, SpillableKVCache
from .loss_scale import DynamicLossScaler
from .memory_tracker import MemoryTracker
from .optimizer import OffloadedAdam
from .overflow import check_region, flat_overflow_check
from .overlap import (ACT_CLASS, EXPERT_CLASS, DeviceSlots, OverlapStats,
                      SerialWorker, done_future)
from .paged import ExpertPageCache
from .stream_plan import (PLAN_COMPILERS, ActFetchOp, ActSaveOp, ComputeOp,
                          ExpertFetchOp, ExpertReleaseOp, FetchOp,
                          GradWriteOp, KVReadOp, KVWriteOp, OptimStepOp,
                          OverflowCheckOp, ReleaseOp, StreamPlan,
                          compile_train, resolve_act_policy)
from .swapper import ParameterSwapper

COMPUTE_SUFFIX = OffloadedAdam.COMPUTE   # store key suffix of compute weights


def verify_bucket(n: int) -> int:
    """Speculative-verify window K bucketed to the next power of two.

    Padding a draft of ``n`` real tokens to the covering power of two
    keeps the set of window shapes bounded by ``{1, 2, 4, ...}`` however
    ragged the drafts run.  Padding token K/V is appended and then rolled
    back with the rejected tail (the accept prefix can never reach into
    the padding — a draft's real length bounds it)."""
    if n < 1:
        raise ValueError(f"verify window must be >= 1 token, got {n}")
    return 1 << (n - 1).bit_length()


class _ActCkpt:
    """One block's activation checkpoint, tracked through its tiers.

    ``tier`` walks ``device`` (just saved: ``value`` is the device tensor)
    → ``host`` (ActSaveOp copied it out: ``value`` is a host ndarray,
    ``handle`` its tracker allocation) → ``ssd`` (the store holds the
    bytes; only ``shape``/``np_dtype`` remain) → ``ready`` (ActFetchOp
    staged it back: ``value`` is a device tensor again, ``slot`` set if it
    holds an ACT_CLASS device slot).  ``dtype`` is the tensor's own dtype,
    which the H2D back restores (bf16 travels as ``uint16`` bits).
    ``ready_event`` (CUDA) was recorded on the compute stream when the
    checkpoint was bound: the D2H waits on it.  ``fut`` is the in-flight
    ActSaveOp future while the gradient-writer thread runs the offload;
    the executor only reads the tier fields after ``fut`` resolves (the
    Future is the happens-before edge), or after an inline save on its own
    thread."""

    __slots__ = ("unit", "tier", "value", "handle", "shape", "np_dtype",
                 "dtype", "ready_event", "fut", "slot")

    def __init__(self, unit: str, value: torch.Tensor, ready_event=None):
        self.unit = unit
        self.tier = "device"
        self.value = value
        self.handle = None      # tracker handle while a host copy is live
        self.shape = None       # ssd tier: host array shape
        self.np_dtype = None    # ssd tier: host array dtype
        self.dtype = value.dtype
        self.ready_event = ready_event
        self.fut = None         # pending ActSaveOp (writer-thread) future
        self.slot = False       # value holds an ACT_CLASS device slot


class _ExecState:
    """Per-plan-run bindings and carried activations/cotangents."""

    __slots__ = ("tokens", "labels", "scale", "h", "dh",
                 "loss", "logits", "live", "live_slots", "h2d", "grads",
                 "checkpoints", "overflowed", "apply", "optim_begun",
                 "kv", "kv_live", "kv_append", "kv_stage", "kv_slots",
                 "kv_time", "cache_len", "last_pos", "kv_write_slots",
                 "stage_seq", "act_order", "act_next", "act_stage",
                 "act_reads", "act_slots_out", "expert_route", "expert_idx",
                 "expert_stage", "expert_live", "expert_slots",
                 "expert_slots_out")

    def __init__(self, tokens: torch.Tensor,
                 labels: torch.Tensor | None = None, scale: float = 1.0):
        self.tokens = tokens
        self.labels = labels
        self.scale = float(scale)        # loss scale of this run's grads
        self.h = self.dh = self.loss = self.logits = None
        self.live: dict[str, dict] = {}     # unit -> device params
        self.live_slots: dict[str, tuple] = {}  # unit -> device-slot tokens
        self.h2d: dict[str, deque] = {}     # unit -> staged-fetch futures
        self.grads: dict[str, dict] = {}    # unit -> device grads
        self.checkpoints: dict[str, _ActCkpt] = {}  # unit -> block input
        self.overflowed: bool | None = None  # set by OverflowCheckOp
        self.apply: bool | None = None       # set by OverflowCheckOp
        self.optim_begun = False             # begin_step() sequenced once
        self.kv: SpillableKVCache | None = None
        self.kv_live: dict[str, tuple] = {}    # unit -> device (k, v) window
        self.kv_append: dict[str, tuple] = {}  # unit -> device (k, v) to land
        self.kv_stage: dict[str, Future] = {}  # unit -> staged-KV future
        self.kv_slots: dict[str, tuple] = {}   # unit -> kv device-slot tokens
        self.kv_time = 0          # device-cache bucket extent this run
        self.cache_len = None     # device int: tokens already cached (0-dim
        #                           on the joint path, (B,) per slot on the
        #                           continuous-batching path)
        self.last_pos = None      # device int: last prompt index (0-dim,
        #                           or (B,) per row for joiner prefills)
        self.kv_write_slots = None  # prefill-scatter target slots
        # (kind, unit) per staging-worker submission, in FIFO order —
        # "w" weight stages, "kv" window stages and "act" checkpoint
        # stages interleave on ONE worker, so the abort path must drain
        # them in this exact order
        self.stage_seq: list[tuple[str, str]] = []
        # activation-checkpoint streaming (train plans with host/ssd tiers)
        self.act_order: list[str] = []   # plan's ActFetchOp units, in order
        self.act_next = 0                # first act fetch not yet issued
        self.act_stage: dict[str, Future] = {}  # unit -> staged-ckpt future
        self.act_reads: dict[str, tuple] = {}   # unit -> (fut, buf, handle)
        #                                         sync-mode SSD act reads
        self.act_slots_out = 0   # ACT_CLASS submissions not yet consumed —
        #                          capped at the slot depth so the staging
        #                          worker's acquire can never block
        # expert paging (paged-MoE plans only): the routing indices persist
        # for the WHOLE plan run — the backward's ExpertFetchOp reuses the
        # forward's routing
        self.expert_route: dict[str, np.ndarray] = {}  # unit -> host idx
        self.expert_idx: dict[str, torch.Tensor] = {}  # unit -> device idx
        self.expert_stage: dict[str, deque] = {}  # unit -> staged-stack futs
        self.expert_live: dict[str, tuple] = {}   # unit -> device stacks
        self.expert_slots: dict[str, tuple] = {}  # unit -> EXPERT_CLASS tokens
        self.expert_slots_out = 0  # EXPERT_CLASS submissions whose slot has
        #                            not been returned — capped at the slot
        #                            depth, like act_slots_out


class OffloadSession:
    """Executes StreamPlans over one open offload stack (context manager)."""

    def __init__(self, model, policy, *, tracker: MemoryTracker | None = None,
                 mode: str = "train",
                 decode: DecodeSpec | None = None) -> None:
        if mode not in ("train", "serve"):
            raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
        self.model = model
        self.policy = policy
        self.mode = mode
        self.device = torch.device(model.device)
        self.tracker = tracker or MemoryTracker()
        self.store = policy.store_factory()
        # The store is open from here on: if any later construction step
        # fails (disk-full while seeding optimizer state, MemoryError on
        # the flat buffer), __enter__ never runs and no caller can close()
        # — release whatever was acquired before re-raising.
        self._closed = False
        try:
            self._construct(model, policy, mode, decode)
        except BaseException:
            self.close()
            raise

    # pre-share: runs inside __init__, before any worker thread exists
    def _construct(self, model, policy, mode: str,  # analyze: pre-share
                   decode: DecodeSpec | None) -> None:
        # The backing follows the device, explicitly: page-locked host
        # memory when the weights go to a CUDA device, plain numpy on CPU.
        cuda = self.device.type == "cuda"
        self.allocator = policy.allocator_cls(
            tracker=self.tracker, component="pinned",
            backing="cuda" if cuda else "numpy")
        cd_host = policy.adam.compute_np_dtype
        self.compute_dtype = torch_dtype(policy.adam.compute_dtype)
        # Expert paging (paged MoE): resolved before the census because the
        # paged units' per-expert tensors leave the per-block streaming
        # counts and become standalone expert-page slots instead.
        self._expert_mode = policy.expert_paging
        self._expert_meta = model.expert_meta or {}
        if self._expert_mode != "off" and not self._expert_meta:
            raise ValueError(
                f"expert_paging={self._expert_mode!r} but the model has no "
                f"paged-MoE units; build it with make_offloadable_lm(..., "
                f"expert_paging=...) so expert tensors split into pages")
        if self._expert_mode == "off" and self._expert_meta:
            raise ValueError(
                "model was built with per-expert pages (expert_meta set) "
                "but the policy streams experts densely "
                "(expert_paging='off'); the dense block apply would miss "
                "the stacked expert weights — align the two knobs")
        self._paged_params: dict[str, frozenset] = {
            u: frozenset(model.expert_params(u)) for u in self._expert_meta}
        expert_pages: dict[tuple[str, str], tuple] = {}
        for unit in model.units:
            for pname in self._paged_params.get(unit.name, ()):
                expert_pages[(unit.name, pname)] = unit.params[pname].shape
        budget = policy.expert_page_slots or len(expert_pages)
        self._expert_cache: ExpertPageCache | None = None
        self._expert_prior: dict[str, np.ndarray] = {}
        census = model.census(
            policy.inflight_blocks, bytes_per_elem=cd_host.itemsize,
            expert_page_slots=budget if expert_pages else None)
        # Cached decode: the KV cache draws slots from the same pool arena
        # the weights stream through, so its residency budget is part of
        # the census (paper §IV-B sizing, extended to decode state).
        self.decode_spec = decode
        self._kv_units = tuple(u.name for u in model.units[1:-1])
        self._kv_page_shape = None
        self._kv_resident = 0
        self._kv_cache: SpillableKVCache | None = None
        if decode is not None:
            if model.block_step is None or model.kv_shape is None:
                raise ValueError(
                    "model has no cached-decode applies (block_step/"
                    "kv_shape); decode=DecodeSpec(...) needs an attention-"
                    "mixer family (see model_adapter.make_offloadable_lm)")
            if not self._kv_units:
                raise ValueError("model has no block units to cache KV for")
            # page-granular census: one kv-class slot per page, per batch
            # slot; the budget is the cache's host-residency limit
            self._kv_resident = (decode.page_budget(len(self._kv_units))
                                 * decode.batch)
            self._kv_page_shape = tuple(model.kv_shape(1, decode.page_size))
            kv_nbytes = int(cd_host.itemsize * np.prod(
                self._kv_page_shape, dtype=np.int64))
            census = census.with_kv(kv_nbytes, self._kv_resident)
        self.pool = policy.pool_cls(census, self.allocator)
        # Paged expert tensors are NOT swapper-streamed: they go through
        # the expert page cache below, one page per (unit, param).
        self.swapper = ParameterSwapper(self.store, self.pool, class_of={
            f"{unit.name}/{key}{COMPUTE_SUFFIX}": model.class_of(key)
            for unit in model.units for key in unit.params
            if key not in self._paged_params.get(unit.name, ())})
        if expert_pages:
            # pages are born spilled against the {key}.compute store copies
            # the registration loop below writes: nothing reads before a
            # fetch, so creating the cache first is safe
            self._expert_cache = ExpertPageCache(
                expert_pages, cd_host, self.pool, self.store,
                resident_limit=budget, store_suffix=COMPUTE_SUFFIX)
        self.scaler = DynamicLossScaler()
        if policy.adam.compute_dtype != "float16":
            self.scaler.scale = 1.0  # only fp16 needs scaling; check stays on
        lookahead = policy.lookahead or policy.inflight_blocks
        self.lookahead = max(1, min(lookahead, policy.inflight_blocks))

        # Per-block activation-checkpoint tiers (train mode), resolved once
        # so a bad act_policy fails here, not at the first train_step.
        # offload_checkpoints=False keeps every checkpoint on the device.
        block_names = [u.name for u in model.units[1:-1]]
        self._act_tiers: tuple[str, ...] = ()
        if mode == "train" and block_names:
            self._act_tiers = resolve_act_policy(
                block_names,
                policy.act_policy if policy.offload_checkpoints
                else "device")

        # Full-overlap machinery (policy.overlap; see module docstring and
        # repro_torch.core.overlap).  Created before the store writes below
        # so a mid-construction failure still finds them on close().
        self.overlap = policy.overlap
        self._ostats = OverlapStats()
        self._optim_lock = threading.Lock()
        self._optim_futures: dict[str, Future] = {}  # guarded-by: _optim_lock
        self._optim_io_completed = 0                 # guarded-by: _optim_lock
        self._device_slots: DeviceSlots | None = None
        self._h2d: SerialWorker | None = None
        self._grad_writer: SerialWorker | None = None
        self._optim_worker: SerialWorker | None = None
        self._optim_prefetch: SerialWorker | None = None
        # Adam-stage subgroup pipeline bookkeeping (see _exec_optim):
        # _adam_work is appended by the executor thread under _adam_lock
        # and read by the optimizer worker; the issue counter and in-flight
        # deque are touched by the optimizer worker only.
        self._adam_lock = threading.Lock()
        # (unit, param key) pairs:
        self._adam_work: list[tuple[str, str]] = []   # guarded-by: _adam_lock
        self._adam_issued = 0
        self._adam_inflight: deque = deque()          # (index, staged fut)
        self._adam_poison: BaseException | None = None
        # per-unit overflow screen: verdicts land per unit (writer thread
        # under full overlap) and are OR-ed at the barrier.
        self._screen_lock = threading.Lock()
        self._region_verdicts: dict[str, bool] = {}  # guarded-by: _screen_lock
        self._screen_regions = policy.fused_overflow and mode == "train"
        if cuda:
            self._compute_stream = torch.cuda.current_stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
            if mode == "train":
                self._d2h_stream = torch.cuda.Stream(self.device)
        if policy.overlap in ("h2d", "full"):
            per_unit: dict[str, int] = {}
            for unit in model.units:
                paged = self._paged_params.get(unit.name, ())
                counts: dict[str, int] = {}
                for key in unit.params:
                    if key in paged:
                        continue   # staged as (E, ...) stacks, not per key
                    cls = model.class_of(key)
                    counts[cls] = counts.get(cls, 0) + 1
                for cls, c in counts.items():
                    per_unit[cls] = max(per_unit.get(cls, 0), c)
            # Two units' worth of device buffers per shape class: one in
            # use by compute, one being staged — the Fig. 6 double buffer.
            depths = {cls: 2 * c for cls, c in per_unit.items()}
            if decode is not None:
                # staged KV windows double-buffer too
                depths[KV_CLASS] = 2
            if any(t in ("host", "ssd") for t in self._act_tiers):
                # staged activation checkpoints double-buffer the same way:
                # one consumed by the current block_bwd, one being staged
                depths[ACT_CLASS] = 2
            if expert_pages:
                # staged expert (E, ...) stacks double-buffer: one triple
                # feeding the current block_moe, one being staged ahead
                depths[EXPERT_CLASS] = 2
            self._device_slots = DeviceSlots(depths)
            # latch=False: every staging future is awaited by the executor
            # (the wait half, or the abort path), which delivers failures.
            self._h2d = SerialWorker("offload-h2d", latch=False)
        if policy.overlap == "full" and mode == "train":
            self._grad_writer = SerialWorker("offload-gradwrite", maxsize=4)
            self._optim_worker = SerialWorker("offload-optim")
            # The Adam stage's own I/O thread: issues (state reads into the
            # double-buffered staging arena) run here.  latch=False: every
            # future is awaited by the optimizer worker, which delivers
            # failures through the unit readiness future.
            self._optim_prefetch = SerialWorker("offload-optim-prefetch",
                                                latch=False)

        # Register every parameter.  Train mode seeds master weights + Adam
        # moments on the store; serve mode writes only compute weights.
        self.optimizer = (OffloadedAdam(self.store, policy.adam,
                                        tracker=self.tracker)
                          if mode == "train" else None)
        if self.optimizer is not None:
            # stale-read guard on the Adam commit's compute-weight write
            self.optimizer.write_guard = self._guard_compute_write
        self._units: dict[str, tuple] = {}
        total_params = 0
        for unit in model.units:
            meta = {}
            for key, value in unit.params.items():
                if self.optimizer is not None:
                    self.optimizer.register(f"{unit.name}/{key}", value)
                else:
                    self.store.write(f"{unit.name}/{key}{COMPUTE_SUFFIX}",
                                     cast_host(value,
                                               policy.adam.compute_dtype))
                meta[key] = (value.shape, value.size)
                total_params += value.size
            self._units[unit.name] = (unit, meta)
        self.total_params = total_params

        # Gradient flat buffer: fp32, whole partition, lives for the session
        # (train mode only).  It comes from the policy's allocator, so on
        # CUDA it is page-locked and every gradient D2H into it is a DMA.
        self._flat_buf = None
        self.flat = None
        if mode == "train":
            self._flat_buf = self.allocator.alloc(total_params * 4,
                                                  tag="gradient_flat_buffer")
            self.flat = self._flat_buf.view(np.float32, (total_params,))
            self._flat_t = torch.from_numpy(self.flat)
            self._flat_offsets: dict[str, tuple[int, int, tuple]] = {}
            self._unit_flat_region: dict[str, tuple[int, int]] = {}
            off = 0
            for unit in model.units:
                lo = off
                for key, (shape, size) in self._units[unit.name][1].items():
                    self._flat_offsets[f"{unit.name}/{key}"] = (
                        off, size, shape)
                    off += size
                # a unit's parameters are contiguous in the flat buffer:
                # [lo, off) is the region its per-unit screen covers
                self._unit_flat_region[unit.name] = (lo, off)
        if self._screen_regions:
            # one int32 Inf/NaN flag per unit on the device, and where the
            # writer reads it back (page-locked on CUDA)
            n = len(model.units)
            self._flag_index = {u.name: i for i, u in enumerate(model.units)}
            self._flags = torch.zeros(n, dtype=torch.int32,
                                      device=self.device)
            self._flags_host = (torch.zeros(n, dtype=torch.int32,
                                            pin_memory=True)
                                if cuda else self._flags)
        self._plans: dict[str, StreamPlan] = {}
        self.metrics: dict = {}

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "OffloadSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:  # thread: executor
        """Drain in-flight reads and pipeline workers, return the arena +
        flat buffer, close the store.  Idempotent; runs on the error path
        via ``__exit__`` and on partially-constructed sessions (attributes
        may not exist yet).

        Worker order matters: the staging worker goes first (its queued
        jobs own swapper tickets), then the gradient writer (its tasks may
        gate on optimizer futures, so the optimizer worker must still be
        alive), then the optimizer worker (whose unit tasks wait on
        state-prefetch futures), then the state-prefetch worker, and only
        then the swapper drain that sweeps any ticket nobody claimed.  The
        optimizer's staging arena is freed after every worker that touches
        it has stopped, and the flat buffer after the writer (whose DMAs
        target it) has."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        steps = []
        if getattr(self, "_kv_cache", None) is not None:
            steps.append(self._kv_cache.close)
        if getattr(self, "_expert_cache", None) is not None:
            steps.append(self._expert_cache.close)
        for worker_attr in ("_h2d", "_grad_writer", "_optim_worker",
                            "_optim_prefetch"):
            worker = getattr(self, worker_attr, None)
            if worker is not None:
                steps.append(worker.close)
        if getattr(self, "optimizer", None) is not None:
            steps.append(self.optimizer.close)
        if getattr(self, "swapper", None) is not None:
            steps.append(self.swapper.drain)
        if getattr(self, "pool", None) is not None:
            steps.append(self.pool.close)
        if getattr(self, "_flat_buf", None) is not None:
            steps.append(self._flat_buf.free)
        steps.append(self.store.close)
        # every step must run even if an earlier one raises — otherwise the
        # arena/flat buffer/store leak with no way to retry; first failure
        # re-raises.
        failure = None
        for step in steps:
            try:
                step()
            except BaseException as e:
                if failure is None:
                    failure = e
        if failure is not None:
            raise failure

    def synchronize(self) -> None:  # thread: executor
        """Drain the cross-step pipeline — queued gradient write-backs and
        the in-flight optimizer stage, re-raising their failures — and
        wait until the device finished every queued kernel and copy.  The
        per-unit readiness gates make this unnecessary for correctness
        between train steps; call it to close a timing window, read
        complete ``optimizer_io_bytes``, or compare state across overlap
        modes."""
        if self._grad_writer is not None:
            self._grad_writer.drain()
        if self._optim_worker is not None:
            self._optim_worker.drain()
        if self._optim_prefetch is not None:
            # empty by construction once the optimizer worker drained (unit
            # tasks wait out their own commits); drained for completeness
            self._optim_prefetch.drain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- plans --------------------------------------------------------------

    def plan(self, name: str) -> StreamPlan:
        """The session's compiled plan for ``name`` (train/eval/decode/
        prefill/decode_cached/decode_verify)."""
        if name not in self._plans:
            if name == "train":
                # the resolved per-block tiers ARE the policy
                self._plans[name] = compile_train(
                    self.model, act_policy=self._act_tiers or None)
            else:
                self._plans[name] = PLAN_COMPILERS[name](self.model)
        return self._plans[name]

    # -- autograd helpers (executor thread: grad mode is thread-local) -------

    @staticmethod
    def _leaves(params: dict) -> dict:
        """Detached copies of staged device weights that autograd can
        differentiate (the staged tensors themselves stay untouched)."""
        return {k: v.detach().requires_grad_() for k, v in params.items()}

    def _head_loss_and_grads(self, params, h, labels, scale: float):
        """Loss, parameter grads and cotangent of the head; the grads carry
        the loss scale (the host Adam unscales them)."""
        with torch.enable_grad():
            p = self._leaves(params)
            x = h.detach().requires_grad_()
            sloss = self.model.head_loss(p, x, labels) * scale
            keys = list(p)
            grads = torch.autograd.grad(sloss, [p[k] for k in keys] + [x])
        return (sloss.detach() / scale, dict(zip(keys, grads[:-1],
                                                 strict=True)), grads[-1])

    def _block_forward(self, params, x):
        """A block's forward as the training plan runs it — the ``block``
        op and ``block_recompute`` alike: no autograd graph (its output is
        a checkpoint or the next block's input), on the compute stream, so
        a recomputed checkpoint is bitwise the forward's."""
        with torch.no_grad():
            return self.model.block_apply(params, x)

    def _block_bwd(self, params, x, dy):
        """Recompute the block forward from its checkpoint under autograd
        and pull the cotangent back: (parameter grads, dx)."""
        with torch.enable_grad():
            p = self._leaves(params)
            xx = x.detach().requires_grad_()
            out = self.model.block_apply(p, xx)
            keys = list(p)
            grads = torch.autograd.grad(out, [p[k] for k in keys] + [xx],
                                        grad_outputs=dy)
        return dict(zip(keys, grads[:-1], strict=True)), grads[-1]

    def _embed_bwd(self, params, tokens, dy):
        with torch.enable_grad():
            p = self._leaves(params)
            out = self.model.embed_apply(p, tokens)
            keys = list(p)
            grads = torch.autograd.grad(out, [p[k] for k in keys],
                                        grad_outputs=dy)
        return dict(zip(keys, grads, strict=True))

    # -- weight streaming ----------------------------------------------------

    def _param_keys(self, unit_name: str):
        unit, meta = self._units[unit_name]
        cd = self.policy.adam.compute_np_dtype
        paged = self._paged_params.get(unit_name, ())
        for key, (shape, _size) in meta.items():
            if key in paged:
                continue   # streamed as expert pages, not with the unit
            yield key, f"{unit.name}/{key}{COMPUTE_SUFFIX}", cd, shape

    def _prefetch_unit(self, unit_name: str) -> None:
        for _key, skey, cd, shape in self._param_keys(unit_name):
            self.swapper.prefetch(skey, cd, shape)

    def _unit_in_flight(self, unit_name: str) -> bool:
        return any(self.swapper.in_flight(skey)
                   for _key, skey, _cd, _shape in
                   self._param_keys(unit_name))

    def _h2d_copy(self, host_view: np.ndarray,  # thread: executor, h2d-worker
                  dtype: torch.dtype | None = None) -> torch.Tensor:
        """Device copy of a host view (a pool slot, a gathered window or an
        activation checkpoint) holding ``dtype`` data (the compute dtype
        unless given; a checkpoint comes back in its own).

        When this returns, the copy has landed: the caller may release the
        slot and the next SSD read may overwrite it.  On CUDA the copy is
        a DMA on the side stream, synchronised here on the calling thread
        (the staging worker, or in sync mode the executor that was going to
        wait anyway), never on an overlapped compute."""
        src = to_torch(host_view, dtype or self.compute_dtype)
        if self.device.type != "cuda":
            return src.clone()
        with torch.cuda.stream(self._copy_stream):
            dev = src.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        self._compute_stream.wait_event(done)
        dev.record_stream(self._compute_stream)
        return dev

    def _submit_h2d(self, unit_name: str, state: _ExecState) -> None:
        """Issue half of the split FetchOp: queue SSD-read-wait + H2D onto
        the staging worker; the wait half pops the future in fetch order."""
        fut = self._h2d.submit(
            functools.partial(self._h2d_stage_unit, unit_name))
        state.h2d.setdefault(unit_name, deque()).append(fut)
        state.stage_seq.append(("w", unit_name))

    def _submit_kv_stage(self, unit_name: str, state: _ExecState) -> None:
        """Issue half of the split KVReadOp: queue page-refill waits +
        window gather + H2D onto the staging worker, behind the same
        unit's weight staging; KVReadOp pops the future (wait half)."""
        fut = self._h2d.submit(functools.partial(
            self._stage_kv_unit, state.kv, unit_name, state.kv_time))
        state.kv_stage[unit_name] = fut
        state.stage_seq.append(("kv", unit_name))

    def _stage_kv_unit(self, kv: SpillableKVCache, unit_name: str,  # thread: h2d-worker
                       extent: int) -> tuple:
        """H2D-worker body for one unit's KV window: gather the attended
        window's pages (waiting out / refilling spilled ones) and stage
        device copies under a counted ``kv`` device slot."""
        k_host, v_host = kv.gather_window(unit_name, extent)
        self._device_slots.acquire(KV_CLASS)
        try:
            return self._h2d_copy(k_host), self._h2d_copy(v_host)
        except BaseException:
            self._device_slots.release_all([KV_CLASS])
            raise

    def _h2d_stage_unit(self, unit_name: str) -> tuple[dict, list]:  # thread: h2d-worker
        """H2D-worker body: claim the unit's tickets, wait each read,
        stage into device slots, release the pool slots.  Returns
        ``(device_params, slot_tokens)``; on any failure every claimed
        ticket and acquired slot token is returned before re-raising."""
        claims = []
        device_params: dict = {}
        tokens: list[str] = []
        try:
            # Claiming inside the try: a claim pops the ticket out of the
            # swapper's in-flight map (drain() can no longer see it), so a
            # mid-loop failure must release the earlier claims here.
            for key, skey, cd, shape in self._param_keys(unit_name):
                ticket, hit, fallback = self.swapper.claim(skey, cd, shape)
                claims.append([key, skey, ticket, hit, fallback, cd, shape])
            for entry in claims:
                key, skey, ticket, hit, fallback, cd, shape = entry
                t0 = time.perf_counter()
                host_view = ticket.wait()
                self.swapper.record_get(
                    hit=hit, fallback=fallback,
                    wait_seconds=time.perf_counter() - t0)
                self._device_slots.acquire(self.swapper.class_of[skey])
                tokens.append(self.swapper.class_of[skey])
                try:
                    device_params[key] = self._h2d_copy(host_view)
                finally:
                    ticket.release()
                    entry[2] = None       # consumed: skip in cleanup
        except BaseException:
            for entry in claims:
                ticket = entry[2]
                if ticket is None:
                    continue
                try:
                    ticket.wait()
                except BaseException:
                    pass          # data is being discarded
                finally:
                    ticket.release()
            self._device_slots.release_all(tokens)
            raise
        return device_params, tokens

    def _fetch_unit(self, unit_name: str, state: _ExecState) -> dict:
        """Blocking half of the lifecycle: wait for staged device weights
        (overlap mode) or wait the reads + H2D inline (sync mode)."""
        pending = state.h2d.get(unit_name)
        if pending:
            fut = pending.popleft()
            if not pending:
                del state.h2d[unit_name]
            hit = fut.done()
            t0 = time.perf_counter()
            device_params, tokens = fut.result()
            self._ostats.h2d_wait_seconds += time.perf_counter() - t0
            self._ostats.h2d_gets += 1
            self._ostats.h2d_hits += int(hit)
            state.live_slots[unit_name] = tuple(tokens)
            return device_params
        device_params = {}
        for key, skey, cd, shape in self._param_keys(unit_name):
            ticket = self.swapper.get(skey, cd, shape)
            try:
                device_params[key] = self._h2d_copy(
                    ticket.buf.view(cd, shape))
            finally:
                ticket.release()                          # slot back to pool
        return device_params

    # -- cross-step optimizer readiness --------------------------------------

    def _guard_compute_write(self, key: str) -> None:  # thread: executor, optim-worker
        """Adam-commit hook: refreshing ``key``'s compute weights on the
        store while a prefetched read of them is in flight would race the
        pread (the readiness gates forbid it; this asserts it)."""
        self.swapper.assert_not_in_flight(key + COMPUTE_SUFFIX)

    def _optim_ready(self, unit_name: str) -> bool:  # thread: executor
        """True when the unit's previous-step Adam landed *successfully* —
        a done-with-exception future is NOT ready (the store still holds
        pre-update weights), so the window stalls on it until the head
        position's :meth:`_optim_wait` delivers the failure."""
        with self._optim_lock:
            fut = self._optim_futures.get(unit_name)
        return fut is None or (fut.done() and fut.exception() is None)

    def _optim_wait(self, unit_name: str) -> None:  # thread: executor
        """Block until the unit's previous-step Adam write-back landed
        (re-raising an optimizer-worker failure here, at the point the
        stale weights would otherwise have been read)."""
        with self._optim_lock:
            fut = self._optim_futures.get(unit_name)
        if fut is None:
            return
        t0 = time.perf_counter()
        try:
            fut.result()
        except BaseException as e:
            if self._optim_worker is not None:
                self._optim_worker.consume_error(e)   # delivered here
            raise
        self._ostats.optim_gate_seconds += time.perf_counter() - t0

    # -- activation-checkpoint streaming -------------------------------------
    #
    # Lifecycle (mirrors the weight stream's split issue/wait halves):
    #
    #   save    ComputeOp(save_input) binds the device tensor as an _ActCkpt
    #           (recording an event on the compute stream); ActSaveOp runs
    #           _act_offload on the gradient-writer thread under full
    #           overlap (the D2H + SSD write hide under the next block's
    #           forward) and inline otherwise,
    #   fetch   _act_issue_ahead (called inside the FetchOp lookahead
    #           window, at each ActFetchOp and after each ReleaseOp) starts
    #           the SSD read + H2D staging for upcoming act fetches, bounded
    #           by the ACT_CLASS device-slot budget; ActFetchOp's
    #           _act_fetch only waits,
    #   consume block_bwd takes the device tensor and returns the slot.
    #
    # Deadlock-freedom of the staged path: the executor never submits an
    # act stage while act_slots_out >= the ACT_CLASS depth, so the staging
    # worker's ACT acquire is always immediately satisfiable — it can
    # never wedge the shared FIFO worker behind an unreleasable slot (a
    # checkpoint fetched early to seed a recompute holds its slot until
    # its own block_bwd).

    def _act_key(self, unit: str, nbytes: int) -> str:
        # nbytes in the key: DirectNVMeEngine reuses an existing key's
        # extents and rejects size changes, so a seq-length change must
        # land under a fresh key (keys are overwritten per step, never
        # deleted — the store reuses their extents)
        return f"__act__/{unit}/{nbytes}"

    def _bind_checkpoint(self, unit: str, h: torch.Tensor) -> _ActCkpt:  # thread: executor
        """A block input saved as its checkpoint; on CUDA with an event
        recorded on the compute stream after the op that produced it."""
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(self._compute_stream)
        return _ActCkpt(unit, h, ready)

    def _exec_act_save(self, op: ActSaveOp, state: _ExecState) -> None:  # thread: executor
        """ActSaveOp: offload the unit's just-saved checkpoint — on the
        gradient-writer thread (full overlap; idle during the forward
        pass) or inline."""
        rec = state.checkpoints[op.unit]
        if self._grad_writer is not None:
            rec.fut = self._grad_writer.submit(
                functools.partial(self._act_offload, rec, op.tier))
        else:
            t0 = time.perf_counter()
            self._act_offload(rec, op.tier)
            self._ostats.act_save_wait_seconds += time.perf_counter() - t0

    def _act_d2h(self, rec: _ActCkpt) -> np.ndarray:  # thread: executor, writer
        """Host copy of a device-tier checkpoint (bf16 as ``uint16`` bits).

        On CUDA the copy is a DMA into page-locked memory on the writer's
        side stream, which first waits on the checkpoint's ready event; it
        is synchronised here, so once this returns the device tensor may be
        dropped (``record_stream`` keeps the caching allocator from reusing
        its memory while the DMA reads it)."""
        value = rec.value
        if self.device.type != "cuda":
            return to_host(value).copy()
        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        done = torch.cuda.Event()
        with torch.cuda.stream(self._d2h_stream):
            self._d2h_stream.wait_event(rec.ready_event)
            host.copy_(value, non_blocking=True)
            value.record_stream(self._d2h_stream)
            done.record(self._d2h_stream)
        done.synchronize()
        return to_host(host)

    def _act_offload(self, rec: _ActCkpt, tier: str) -> None:  # thread: executor, writer
        """D2H the checkpoint and, for the ssd tier, write it onward to
        the store and free the host copy.  A failed SSD write degrades
        gracefully: the host copy stays live (tracked) and the checkpoint
        serves from the host tier — no data loss, no raised step."""
        t0 = time.perf_counter()
        try:
            host = self._act_d2h(rec)
            handle = self.tracker.alloc("activation_checkpoints",
                                        host.nbytes, tag="block_input")
            try:
                if tier == "ssd":
                    try:
                        self.store.write(self._act_key(rec.unit, host.nbytes),
                                         host)
                    except Exception:
                        self._ostats.bump("act_write_failures")
                    else:
                        self.tracker.free(handle)
                        rec.shape, rec.np_dtype = host.shape, host.dtype
                        rec.value, rec.handle = None, None
                        rec.tier = "ssd"
                        return
                rec.value, rec.handle = host, handle
                rec.tier = "host"
            except BaseException:
                # rec stays device-tier; the abort path discards it safely
                self.tracker.free(handle)
                raise
        finally:
            self._ostats.add_worker_seconds("act_save_seconds",
                                            time.perf_counter() - t0)

    def _act_issue_ahead(self, state: _ExecState) -> None:  # thread: executor
        """Issue half of upcoming ActFetchOps: start SSD reads + H2D
        staging for the next offloaded checkpoints, in plan order, so
        block *i−1*'s checkpoint streams back under block *i*'s
        ``block_bwd``.  Stops at a checkpoint whose save is still in
        flight (or failed — the failure surfaces at its ActFetchOp gate)
        and at the ACT slot / lookahead budget."""
        order = state.act_order
        while state.act_next < len(order):
            unit = order[state.act_next]
            rec = state.checkpoints.get(unit)
            if rec is None:
                break              # forward has not saved this one yet
            fut = rec.fut
            if fut is not None:
                if not fut.done():
                    break          # save still in flight on the writer
                if fut.exception() is not None:
                    break          # delivered at the ActFetchOp gate
            if rec.tier not in ("host", "ssd") or unit in state.act_stage \
                    or unit in state.act_reads:
                state.act_next += 1
                continue
            if self._h2d is not None:
                if state.act_slots_out >= 2:
                    break          # ACT_CLASS budget: acquire never blocks
                self._issue_act_stage(unit, rec, state)
            elif rec.tier == "ssd":
                if len(state.act_reads) >= self.lookahead:
                    break
                self._issue_act_read(unit, rec, state)
            # sync-mode host tier: nothing to issue — the H2D is the wait
            state.act_next += 1

    def _act_read_buffer(self, rec: _ActCkpt) -> tuple[np.ndarray, int]:  # thread: executor
        """A tracked host buffer for one ssd-tier checkpoint's read."""
        buf = np.empty(rec.shape, rec.np_dtype)
        return buf, self.tracker.alloc("activation_checkpoints", buf.nbytes,
                                       tag="act_fetch_staging")

    def _issue_act_stage(self, unit: str, rec: _ActCkpt,  # thread: executor
                         state: _ExecState) -> None:
        """Queue one checkpoint's H2D staging (and, for ssd, its async
        store read) on the staging worker, behind the backward pass's
        weight stages."""
        if rec.tier == "ssd":
            buf, handle = self._act_read_buffer(rec)
            try:
                read_fut = self.store.read_async(
                    self._act_key(unit, buf.nbytes), buf)
            except BaseException:
                self.tracker.free(handle)
                raise
            task = functools.partial(self._act_stage_ssd, read_fut, buf,
                                     handle, rec.dtype)
        else:
            task = functools.partial(self._act_stage_host, rec)
        state.act_stage[unit] = self._h2d.submit(task)
        state.stage_seq.append(("act", unit))
        state.act_slots_out += 1

    def _act_stage_ssd(self, read_fut: Future, buf: np.ndarray,  # thread: h2d-worker
                       handle: int, dtype: torch.dtype) -> torch.Tensor:
        """Staging-worker body: wait the SSD read, H2D under a counted ACT
        device slot, free the staging buffer.  On failure the slot is
        returned here; the read buffer's tracker handle is always freed
        (the bytes live on device or nowhere)."""
        self._device_slots.acquire(ACT_CLASS)
        try:
            try:
                read_fut.result()
                return self._h2d_copy(buf, dtype)
            finally:
                self.tracker.free(handle)
        except BaseException:
            self._device_slots.release_all([ACT_CLASS])
            raise

    def _act_stage_host(self, rec: _ActCkpt) -> torch.Tensor:  # thread: h2d-worker
        """Staging-worker body for a host-tier checkpoint: H2D under a
        counted ACT device slot (the host copy's tracker handle is freed
        by the executor when the staged tensor is consumed)."""
        self._device_slots.acquire(ACT_CLASS)
        try:
            return self._h2d_copy(rec.value, rec.dtype)
        except BaseException:
            self._device_slots.release_all([ACT_CLASS])
            raise

    def _issue_act_read(self, unit: str, rec: _ActCkpt,  # thread: executor
                        state: _ExecState) -> None:
        """Sync-mode issue half: async SSD read into a tracked host
        buffer; the ActFetchOp waits it out and H2Ds inline."""
        buf, handle = self._act_read_buffer(rec)
        try:
            fut = self.store.read_async(self._act_key(unit, buf.nbytes), buf)
        except BaseException:
            self.tracker.free(handle)
            raise
        state.act_reads[unit] = (fut, buf, handle)

    def _act_fetch(self, op: ActFetchOp, state: _ExecState) -> None:  # thread: executor
        """Wait half of the split ActFetchOp: surface a failed save
        exactly once, top up the issue window, then make the checkpoint
        device-resident from whichever tier it landed in."""
        unit = op.unit
        rec = state.checkpoints[unit]
        if rec.fut is not None:
            t0 = time.perf_counter()
            try:
                rec.fut.result()
            except BaseException as e:
                if self._grad_writer is not None:
                    self._grad_writer.consume_error(e)  # delivered here
                raise
            finally:
                rec.fut = None
                self._ostats.act_save_wait_seconds += \
                    time.perf_counter() - t0
        self._act_issue_ahead(state)
        t0 = time.perf_counter()
        staged = state.act_stage.pop(unit, None)
        if staged is not None:
            hit = staged.done()
            try:
                value = staged.result()
            finally:
                # a failed stage must not leak the host copy's handle
                if rec.handle is not None:
                    self.tracker.free(rec.handle)
                    rec.handle = None
            self._ostats.act_stage_gets += 1
            self._ostats.act_stage_hits += int(hit)
            rec.value, rec.tier, rec.slot = value, "ready", True
        elif unit in state.act_reads:
            read_fut, buf, handle = state.act_reads.pop(unit)
            try:
                read_fut.result()
                value = self._h2d_copy(buf, rec.dtype)
            finally:
                self.tracker.free(handle)
            rec.value, rec.tier = value, "ready"
        elif rec.tier == "host":
            # inline H2D; the handle is freed even if the copy raises
            try:
                value = self._h2d_copy(rec.value, rec.dtype)
            finally:
                self.tracker.free(rec.handle)
                rec.handle = None
            rec.value, rec.tier = value, "ready"
        elif rec.tier == "ssd":
            # cold path (defensive): read + H2D inline
            buf, handle = self._act_read_buffer(rec)
            try:
                self.store.read(self._act_key(unit, buf.nbytes), buf)
                value = self._h2d_copy(buf, rec.dtype)
            finally:
                self.tracker.free(handle)
            rec.value, rec.tier = value, "ready"
        self._ostats.act_fetch_wait_seconds += time.perf_counter() - t0

    def _consume_checkpoint(self, unit: str, state: _ExecState) -> torch.Tensor:  # thread: executor
        """block_bwd's checkpoint take: pop the record, return its device
        tensor, and give back its ACT device slot."""
        rec = state.checkpoints.pop(unit)
        if rec.slot:
            self._device_slots.release_all([ACT_CLASS])
            state.act_slots_out -= 1
            rec.slot = False
        if rec.tier in ("device", "ready"):
            return rec.value
        # validated at plan build (block_bwd only consumes saved/ready);
        # defensive
        raise RuntimeError(f"checkpoint for {unit!r} is {rec.tier!r}, not "
                           f"device-resident")

    def _discard_checkpoint(self, rec: _ActCkpt,  # thread: executor
                            state: _ExecState) -> None:
        """Abort-path release of one checkpoint record: wait out an
        in-flight save (the writer thread may still be mutating the
        record), return its device slot, free its host handle."""
        if rec.fut is not None:
            with contextlib.suppress(BaseException):
                rec.fut.result()
            rec.fut = None
        if rec.slot:
            self._device_slots.release_all([ACT_CLASS])
            state.act_slots_out -= 1
            rec.slot = False
        if rec.handle is not None:
            self.tracker.free(rec.handle)
            rec.handle = None

    # -- expert-page streaming (paged MoE) -----------------------------------
    #
    # Lifecycle (mirrors the weight stream's split issue/wait halves):
    #
    #   route   block_route (or a cached-decode route variant) computes the
    #           expert assignment; the executor reads the indices back and
    #           binds them for the WHOLE plan run (the backward reuses the
    #           forward's routing),
    #   issue   the FetchOp lookahead window prestages the PREDICTED
    #           routed set — this plan's own routing when already known
    #           (backward: exact), else the previous step's actual set,
    #           or every expert under expert_paging="all" — as device
    #           (E, ...) stacks under a counted EXPERT_CLASS device slot on
    #           the staging worker,
    #   wait    ExpertFetchOp resolves the ACTUAL routed set; a staged set
    #           that covers it is a hit, otherwise the stale stacks are
    #           dropped (slot returned) and the actual set is staged on
    #           demand,
    #   consume block_moe / block_moe_bwd read the stacks; ExpertReleaseOp
    #           returns the device slot and trims the page cache back under
    #           its residency budget.
    #
    # Deadlock-freedom of the staged path: the executor never submits an
    # expert stage while expert_slots_out >= the EXPERT_CLASS depth, so the
    # staging worker's acquire is always immediately satisfiable — it can
    # never wedge the shared FIFO worker behind an unreleasable slot.
    # Unrouted experts are never read by moe_ffn's dispatch or combine
    # (dropped pairs carry weight zero and read a zero row), so routed-only
    # stacks give the same bits as all-resident ones.

    def _expert_predict(self, unit: str, state: _ExecState):  # thread: executor
        """Predicted routed set for a window prestage: every expert under
        "all", this plan's own routing when the route already ran (the
        backward re-fetch — exact by construction), else the previous
        step's actual set (None before any step routed this unit)."""
        if self._expert_mode == "all":
            return np.arange(self._expert_meta[unit]["n_experts"])
        route = state.expert_route.get(unit)
        if route is not None:
            return np.unique(route)
        return self._expert_prior.get(unit)

    def _build_expert_stacks(self, unit: str, ids) -> list:  # thread: executor, h2d-worker
        """Device (E, ...) stacks in the compute dtype: zeros, with the
        ``ids`` experts' pages copied in from the page cache (each page
        pinned until its copy landed).  Rows of other experts stay zero
        and are never read, so the stacks have the all-resident shapes and
        the expert half runs one program for both residencies.  Byte
        accounting lands here: only the copied pages cost SSD/H2D
        traffic."""
        meta = self._expert_meta[unit]
        triples = meta["experts"]
        _unit, umeta = self._units[unit]
        cuda = self.device.type == "cuda"
        nbytes = 0
        with (torch.cuda.stream(self._copy_stream) if cuda
              else contextlib.nullcontext()):
            stacks = [torch.zeros((meta["n_experts"], *umeta[pname][0]),
                                  dtype=self.compute_dtype,
                                  device=self.device)
                      for pname in triples[0]]
            for i in ids:
                for stack, pname in zip(stacks, triples[int(i)],
                                        strict=True):
                    view = self._expert_cache.ensure(unit, pname, pin=True)
                    try:
                        stack[int(i)].copy_(
                            to_torch(view, self.compute_dtype),
                            non_blocking=cuda)
                        if cuda:
                            # the page-locked slot may be evicted once
                            # unpinned: the DMA must have landed
                            self._copy_stream.synchronize()
                    finally:
                        self._expert_cache.unpin(unit, pname)
                    nbytes += view.nbytes
        if cuda:
            # the zero fill and the copies ran on the side stream: the
            # compute stream waits for them, and the caching allocator
            # keeps the stacks until compute is done with them
            done = torch.cuda.Event()
            done.record(self._copy_stream)
            self._compute_stream.wait_event(done)
            for stack in stacks:
                stack.record_stream(self._compute_stream)
        self._ostats.bump("expert_fetch_bytes", nbytes)
        return stacks

    def _stage_experts(self, unit: str, ids: tuple) -> tuple:  # thread: h2d-worker
        """Staging-worker body: build the stacks under a counted
        EXPERT_CLASS device slot; a failed expert SSD read returns the
        slot before it surfaces at the fetch gate."""
        self._device_slots.acquire(EXPERT_CLASS)
        try:
            return (frozenset(int(i) for i in ids),
                    tuple(self._build_expert_stacks(unit, ids)))
        except BaseException:
            self._device_slots.release_all([EXPERT_CLASS])
            raise

    def _submit_expert_stage(self, unit: str, ids,  # thread: executor
                             state: _ExecState) -> None:
        """Issue half: queue one unit's expert staging on the staging
        worker, behind the same unit's weight (and KV) stages."""
        fut = self._h2d.submit(
            functools.partial(self._stage_experts, unit, tuple(ids)))
        state.expert_stage.setdefault(unit, deque()).append(fut)
        state.stage_seq.append(("ex", unit))
        state.expert_slots_out += 1

    def _expert_fetch_now(self, unit: str, ids,  # thread: executor
                          state: _ExecState) -> tuple:
        """On-demand stage (miss, or no prestage was issued): through the
        staging worker when an EXPERT slot is guaranteed free — the
        executor is about to block on the result, so the worker's acquire
        must not be able to block — else built inline without a slot
        (transient, accounted to the fetch wait)."""
        if self._h2d is not None and state.expert_slots_out < 2:
            state.expert_slots_out += 1
            fut = self._h2d.submit(
                functools.partial(self._stage_experts, unit, tuple(ids)))
            # NOT in stage_seq: consumed synchronously right here, even on
            # error (the worker released any slot it held before raising)
            try:
                _ids, stacks = fut.result()
            except BaseException:
                state.expert_slots_out -= 1
                raise
            return stacks, (EXPERT_CLASS,)
        return tuple(self._build_expert_stacks(unit, ids)), ()

    def _expert_fetch(self, op: ExpertFetchOp,  # thread: executor
                      state: _ExecState) -> None:
        """Wait half of the split ExpertFetchOp: resolve the actual routed
        set, take a covering staged prediction, restage on a miss."""
        unit = op.unit
        if self._expert_mode == "all":
            actual = np.arange(self._expert_meta[unit]["n_experts"])
        else:
            actual = np.unique(state.expert_route[unit])
        self._expert_prior[unit] = actual
        t0 = time.perf_counter()
        stacks = tokens = None
        pending = state.expert_stage.get(unit)
        if pending:
            fut = pending.popleft()
            if not pending:
                del state.expert_stage[unit]
            self._ostats.expert_stage_gets += 1
            try:
                staged_ids, staged = fut.result()
            except BaseException:
                # a failed expert SSD read surfaces exactly once, here;
                # the worker returned its slot before raising
                state.expert_slots_out -= 1
                raise
            if set(int(i) for i in actual) <= staged_ids:
                self._ostats.expert_stage_hits += 1
                stacks, tokens = staged, (EXPERT_CLASS,)
            else:
                # stale prediction: drop the stacks, return the slot, and
                # stage the actual routed set on demand
                del staged
                self._device_slots.release_all([EXPERT_CLASS])
                state.expert_slots_out -= 1
        if stacks is None:
            stacks, tokens = self._expert_fetch_now(unit, actual, state)
        state.expert_live[unit] = tuple(stacks)
        state.expert_slots[unit] = tokens
        self._ostats.expert_fetch_wait_seconds += time.perf_counter() - t0

    def _expert_release(self, op: ExpertReleaseOp,  # thread: executor
                        state: _ExecState) -> None:
        """ExpertReleaseOp: drop the staged device stacks, return the
        EXPERT_CLASS slot, and trim the page cache over its keep line (the
        host pages themselves stay cached for future steps)."""
        state.expert_live.pop(op.unit, None)
        tokens = state.expert_slots.pop(op.unit, ())
        if tokens:
            self._device_slots.release_all(tokens)
            state.expert_slots_out -= 1
        self._expert_cache.release_round()

    def _bind_route(self, unit: str, idx: torch.Tensor,  # thread: executor
                    state: _ExecState) -> None:
        """Keep a route stage's expert indices: on the device for the
        expert half, and on the host (a readback — the routed set is host
        control flow) for the fetch decision."""
        state.expert_idx[unit] = idx
        state.expert_route[unit] = idx.cpu().numpy().reshape(-1)

    def expert_cache_stats(self) -> dict:
        """Expert page cache spill/refill counters (see
        :class:`~repro_torch.core.paged.PageStats`); empty when expert
        paging is off."""
        return ({} if self._expert_cache is None
                else self._expert_cache.stats.snapshot())

    # -- plan execution ------------------------------------------------------

    def execute(self, plan: StreamPlan, state: _ExecState) -> _ExecState:  # thread: executor
        """Walk the plan with lookahead-N prefetch; drain on any error."""
        if self._closed:
            raise RuntimeError("session is closed")
        if self.device.type == "cuda":
            with torch.cuda.stream(self._compute_stream):
                return self._execute(plan, state)
        return self._execute(plan, state)

    def _execute(self, plan: StreamPlan, state: _ExecState) -> _ExecState:  # thread: executor
        fetch_order = plan.fetch_order
        fetch_pos = 0       # index of the FetchOp being executed
        next_prefetch = 0   # first fetch position not yet issued async
        # Units whose KV window this plan reads (decode_cached blocks):
        # only they get KV refill prefetch + staged-gather submissions —
        # prefill plans overwrite whole pages, so refilling ahead of a
        # write would be wasted I/O.
        kv_read_units = (frozenset(
            op.unit for op in plan.ops if isinstance(op, KVReadOp))
            if state.kv is not None else frozenset())
        expert_units = frozenset(
            op.unit for op in plan.ops if isinstance(op, ExpertFetchOp))
        state.act_order = [op.unit for op in plan.ops
                           if isinstance(op, ActFetchOp)]
        state.act_next = 0
        try:
            for op in plan.ops:
                if isinstance(op, FetchOp):
                    if state.act_order:
                        # checkpoint fetches ride the same window — issued
                        # BEFORE this dispatch's weight stages so they are
                        # not queued behind a weight stage that is parked
                        # on a device slot the backward has yet to release
                        self._act_issue_ahead(state)
                    limit = min(fetch_pos + self.lookahead, len(fetch_order))
                    while next_prefetch < limit:
                        unit = fetch_order[next_prefetch]
                        head = next_prefetch == fetch_pos
                        # Cross-step gate: the unit's previous-step Adam
                        # write-back must land before its weights are
                        # re-read from the store.  Ahead-of-need positions
                        # stall the window; the head position waits, which
                        # is also where a failed Adam stage is delivered.
                        if head:
                            self._optim_wait(unit)
                        elif not self._optim_ready(unit):
                            break
                        # prefetch() is idempotent per key: a unit still in
                        # flight from an earlier position would alias onto
                        # its ticket, so stall the window until it is
                        # consumed (the head position always proceeds)
                        if not head and self._unit_in_flight(unit):
                            break
                        self._prefetch_unit(unit)
                        if self._h2d is not None:
                            self._submit_h2d(unit, state)
                        if unit in kv_read_units:
                            # ride the same window: block i+1's KV page
                            # refills + window gather/H2D overlap block
                            # i's compute
                            state.kv.prefetch_window(unit, state.kv_time)
                            if self._h2d is not None and \
                                    unit not in state.kv_stage:
                                self._submit_kv_stage(unit, state)
                        if unit in expert_units and self._h2d is not None \
                                and state.expert_slots_out < 2:
                            # prestage the predicted routed set behind the
                            # unit's weight/KV stages; skipped when the
                            # prediction is unknown (first step) or the
                            # EXPERT slot budget is out — the ExpertFetchOp
                            # then stages on demand
                            pred = self._expert_predict(unit, state)
                            if pred is not None and len(pred):
                                self._submit_expert_stage(unit, pred, state)
                        next_prefetch += 1
                    t_fetch = time.perf_counter()
                    state.live[op.unit] = self._fetch_unit(op.unit, state)
                    self._ostats.fetch_seconds += \
                        time.perf_counter() - t_fetch
                    fetch_pos += 1
                elif isinstance(op, ComputeOp):
                    self._compute(op, state)
                elif isinstance(op, KVReadOp):
                    self._read_kv(op.unit, state)
                elif isinstance(op, KVWriteOp):
                    self._write_kv(op, state)
                elif isinstance(op, ActSaveOp):
                    self._exec_act_save(op, state)
                elif isinstance(op, ActFetchOp):
                    self._act_fetch(op, state)
                elif isinstance(op, ExpertFetchOp):
                    self._expert_fetch(op, state)
                elif isinstance(op, ExpertReleaseOp):
                    self._expert_release(op, state)
                elif isinstance(op, GradWriteOp):
                    self._dispatch_grad_write(op.unit, state)
                elif isinstance(op, OverflowCheckOp):
                    self._exec_overflow(op, state)
                elif isinstance(op, OptimStepOp):
                    self._exec_optim(op.unit, state)
                elif isinstance(op, ReleaseOp):
                    state.live.pop(op.unit, None)
                    tokens = state.live_slots.pop(op.unit, None)
                    if tokens:
                        self._device_slots.release_all(tokens)
                    kv_tokens = state.kv_slots.pop(op.unit, None)
                    if kv_tokens:
                        self._device_slots.release_all(kv_tokens)
                    if state.act_order:
                        # a block_bwd just gave an ACT slot back — top the
                        # issue window up ahead of the next weight stages
                        self._act_issue_ahead(state)
                else:   # validated at plan build; defensive
                    raise ValueError(f"unknown plan op {op!r}")
        except BaseException:
            self._abort_execute(state)
            raise
        return state

    def _abort_execute(self, state: _ExecState) -> None:
        """Error path: nothing may leak.  Device-slot tokens are returned
        (resident units first, so a staging worker blocked on a slot can
        finish), staged fetches waited out in submission order, the
        gradient writer drained (resolving in-flight activation saves),
        host-held checkpoints and staged act reads freed, and outstanding
        reads drained back to the pool.  (KV pool slots belong to the
        SpillableKVCache, whose owner — generate()'s finally — closes
        it.)"""
        for tokens in state.live_slots.values():
            self._device_slots.release_all(tokens)
        state.live_slots.clear()
        for tokens in state.kv_slots.values():
            self._device_slots.release_all(tokens)
        state.kv_slots.clear()
        for tokens in state.expert_slots.values():
            if tokens:
                self._device_slots.release_all(tokens)
        state.expert_slots.clear()
        state.expert_live.clear()
        state.live.clear()
        # Staged fetches, KV windows, act checkpoints and expert stacks must
        # settle before the swapper drain: a queued staging job that ran
        # *after* the drain would re-issue its reads and leak device slots.
        # All four kinds interleave on ONE FIFO worker, so waits follow stage_seq's
        # order — waiting a later weight future while an earlier KV task
        # still blocks on a kv device slot would deadlock.  (Act stages
        # never block on their slot: the executor's act_slots_out cap
        # guarantees a free ACT slot per submission, and expert stages a
        # free EXPERT slot.)
        for kind, unit in state.stage_seq:
            if kind == "ex":
                pending = state.expert_stage.get(unit)
                if not pending:
                    continue
                fut = pending.popleft()
                try:
                    fut.result()
                except BaseException:
                    continue      # the worker released its own slot
                self._device_slots.release_all([EXPERT_CLASS])
            elif kind == "w":
                pending = state.h2d.get(unit)
                if not pending:
                    continue
                fut = pending.popleft()
                try:
                    _params, tokens = fut.result()
                except BaseException:
                    continue      # the worker released its own claims
                self._device_slots.release_all(tokens)
            else:   # "kv" / "act": one device slot of the kind's class
                stage, cls = ((state.kv_stage, KV_CLASS) if kind == "kv"
                              else (state.act_stage, ACT_CLASS))
                fut = stage.pop(unit, None)
                if fut is None:
                    continue
                try:
                    fut.result()
                except BaseException:
                    continue      # the worker released its own slot
                self._device_slots.release_all([cls])
        state.stage_seq.clear()
        state.h2d.clear()
        state.kv_live.clear()
        state.kv_append.clear()
        state.act_stage.clear()
        state.expert_stage.clear()
        state.expert_route.clear()
        state.expert_idx.clear()
        state.expert_slots_out = 0
        state.grads.clear()
        if self._grad_writer is not None:
            # the original executor error propagates; queued write-backs
            # finish (their DMAs target the flat buffer) before return,
            # and in-flight activation saves resolve, so the checkpoint
            # discard below sees settled records
            with contextlib.suppress(BaseException):
                self._grad_writer.drain()
        for rec in state.checkpoints.values():
            self._discard_checkpoint(rec, state)
        state.checkpoints.clear()
        for read_fut, _buf, handle in state.act_reads.values():
            with contextlib.suppress(BaseException):
                read_fut.result()   # the async pread targets the buffer
            self.tracker.free(handle)
        state.act_reads.clear()
        state.act_slots_out = 0
        self.swapper.drain()

    def _compute(self, op: ComputeOp, state: _ExecState) -> None:
        params = state.live[op.unit]
        model = self.model
        if op.kind == "embed":
            state.h = model.embed_apply(params, state.tokens)
        elif op.kind == "block":
            if op.save_input:
                # bind the device tensor only — the D2H (and SSD write)
                # happen at the unit's ActSaveOp, off the executor thread
                # under full overlap; device-tier plans keep it as it is
                state.checkpoints[op.unit] = self._bind_checkpoint(
                    op.unit, state.h)
            state.h = self._block_forward(params, state.h)
        elif op.kind == "head_loss_grad":
            state.loss, head_grads, state.dh = self._head_loss_and_grads(
                params, state.h, state.labels, state.scale)
            state.grads[op.unit] = head_grads
        elif op.kind == "head_loss":
            state.loss = model.head_loss(params, state.h, state.labels)
        elif op.kind == "block_bwd":
            x = self._consume_checkpoint(op.unit, state)
            state.grads[op.unit], state.dh = self._block_bwd(
                params, x, state.dh)
        elif op.kind == "block_recompute":
            # re-run this block's forward from its own (peeked, not
            # consumed — its block_bwd still needs it) checkpoint to
            # re-derive the successor's dropped checkpoint, exactly as
            # the forward's block op computed it
            src = state.checkpoints[op.unit]
            if src.tier not in ("device", "ready"):  # validated; defensive
                raise RuntimeError(f"recompute source for {op.unit!r} is "
                                   f"{src.tier!r}, not device-resident")
            state.checkpoints[op.recompute_for] = self._bind_checkpoint(
                op.recompute_for, self._block_forward(params, src.value))
        elif op.kind == "embed_bwd":
            state.grads[op.unit] = self._embed_bwd(params, state.tokens,
                                                   state.dh)
        elif op.kind == "head_logits":
            if state.cache_len is None:    # the uncached full-prefix pass
                state.logits = model.head_logits(params, state.h)
            else:
                # cached step or verify window: one (B, 1) product per
                # position, so a verify position's logits are bitwise the
                # step's whatever the window's width
                state.logits = torch.cat(
                    [model.head_logits(params, h)
                     for h in split_positions(state.h)], dim=1)
        elif op.kind == "head_logits_last":
            # the last valid prompt position of the padded bucket, picked
            # by a device index (no host sync, one code path per length):
            # one position for the whole batch (0-dim) or one per row (B,)
            pos = state.last_pos
            h_last = (state.h.index_select(1, pos.reshape(1))
                      if pos.ndim == 0 else
                      torch.take_along_dim(state.h, pos[:, None, None],
                                           dim=1))
            state.logits = model.head_logits(params, h_last)
        elif op.kind == "block_prefill":
            state.h, k, v = model.block_prefill(params, state.h)
            state.kv_append[op.unit] = (k, v)
        elif op.kind == "block_step":
            k_dev, v_dev = state.kv_live.pop(op.unit)
            state.h, k, v = model.block_step(
                params, state.h, k_dev, v_dev, state.cache_len,
                chunk=self.decode_spec.bucket)
            state.kv_append[op.unit] = (k, v)
        elif op.kind == "block_verify":
            k_dev, v_dev = state.kv_live.pop(op.unit)
            state.h, k, v = model.block_verify(
                params, state.h, k_dev, v_dev, state.cache_len,
                chunk=self.decode_spec.bucket)
            state.kv_append[op.unit] = (k, v)
        elif op.kind == "block_route":
            if op.save_input:
                state.checkpoints[op.unit] = self._bind_checkpoint(
                    op.unit, state.h)
            with torch.no_grad():
                state.h, idx = model.block_route(params, state.h)
            self._bind_route(op.unit, idx, state)
        elif op.kind == "block_moe":
            stacks = state.expert_live[op.unit]
            idx = state.expert_idx[op.unit]
            with torch.no_grad():
                if state.cache_len is None:
                    state.h = model.block_moe(params, *stacks, idx, state.h)
                else:
                    # cached step or verify window: one (B, 1) position at
                    # a time, as block_verify runs its FFN, so a verify
                    # position is bitwise the step's
                    b, kq = state.h.shape[:2]
                    idx = idx.reshape(b, kq, -1)
                    state.h = torch.cat(
                        [model.block_moe(params, *stacks, idx[:, j], hj)
                         for j, hj in enumerate(split_positions(state.h))],
                        dim=1)
        elif op.kind == "block_moe_bwd":
            x = self._consume_checkpoint(op.unit, state)
            dparams, dgate, dup, ddown, state.dh = model.block_moe_bwd(
                params, *state.expert_live[op.unit],
                state.expert_idx[op.unit], x, state.dh)
            # the stacked expert grads back under their per-expert param
            # keys (the flat-buffer layout); unrouted experts' rows are
            # exactly zero — their weights were never read
            for i, triple in enumerate(
                    self._expert_meta[op.unit]["experts"]):
                for g, pname in zip((dgate, dup, ddown), triple,
                                    strict=True):
                    dparams[pname] = g[i]
            state.grads[op.unit] = dparams
        elif op.kind in ("block_prefill_route", "block_step_route",
                         "block_verify_route"):
            if op.kind == "block_prefill_route":
                out = model.block_prefill_route(params, state.h)
            else:
                k_dev, v_dev = state.kv_live.pop(op.unit)
                apply = (model.block_step_route
                         if op.kind == "block_step_route"
                         else model.block_verify_route)
                out = apply(params, state.h, k_dev, v_dev, state.cache_len,
                            chunk=self.decode_spec.bucket)
            state.h, k, v, idx = out
            state.kv_append[op.unit] = (k, v)
            self._bind_route(op.unit, idx, state)
        else:  # validated at plan build; defensive
            raise ValueError(f"unknown compute kind {op.kind!r}")

    def _read_kv(self, unit_name: str, state: _ExecState) -> None:
        """Wait half of the split KVReadOp: take the staged device K/V
        window (overlap modes) or gather and H2D inline (sync mode)."""
        fut = state.kv_stage.pop(unit_name, None)
        if fut is not None:
            hit = fut.done()
            t0 = time.perf_counter()
            k_dev, v_dev = fut.result()
            self._ostats.kv_stage_wait_seconds += time.perf_counter() - t0
            self._ostats.kv_stage_gets += 1
            self._ostats.kv_stage_hits += int(hit)
            state.kv_slots[unit_name] = (KV_CLASS,)
            state.kv_live[unit_name] = (k_dev, v_dev)
            return
        # Inline path (sync overlap): the gather copies out of the pool
        # pages under pins, and _h2d_copy returns only after the device
        # copy landed, so the page slots are free to be spilled after.
        k_host, v_host = state.kv.gather_window(unit_name, state.kv_time)
        state.kv_live[unit_name] = (self._h2d_copy(k_host),
                                    self._h2d_copy(v_host))

    def _write_kv(self, op: KVWriteOp, state: _ExecState) -> None:
        """Land this unit's new K/V in its host pages (D2H on the compute
        stream): one token appended to the tail page (``step``), a K-token
        draft window appended past each slot's length (``verify`` —
        lengths advance only when the host commits the accepted prefix),
        or the whole padded prompt window scattered across pages
        (``prefill``, only the joiners' slots when ``kv_write_slots`` is
        set); the cache spills dirty pages onward past the residency
        budget.

        K/V are cast on the device to the pages' dtype (the policy's
        compute dtype) first: the host form of bf16 is ``uint16`` bits, so
        a numpy assignment of other values into a bf16 page would convert
        values, not bits."""
        k, v = (to_host(t.to(self.compute_dtype))
                for t in state.kv_append.pop(op.unit))
        if op.mode == "prefill":
            state.kv.write_prefill(op.unit, k, v, slots=state.kv_write_slots)
        elif op.mode == "verify":
            state.kv.append_window(op.unit, k, v)
        else:
            state.kv.append(op.unit, k, v)

    # -- gradient write-back -------------------------------------------------

    def _dispatch_grad_write(self, unit_name: str, state: _ExecState) -> None:  # thread: executor
        """Cast the unit's device grads to fp32 on the compute stream, then
        run the write-back inline (sync/h2d modes) or enqueue it on the
        writer thread (full overlap), gated on the previous step's Adam
        having consumed the unit's flat region."""
        staged = self._stage_grads(unit_name, state.grads.pop(unit_name))
        if self._grad_writer is None:
            self._write_grads(unit_name, staged)
            return
        with self._optim_lock:
            gate = self._optim_futures.get(unit_name)
        self._grad_writer.submit(
            functools.partial(self._write_grads, unit_name, staged, gate))

    def _stage_grads(self, unit_name: str, grads: dict) -> tuple:  # thread: executor
        """The flat fp32 device tensors the D2H lands, in flat-buffer order,
        and (on CUDA) an event recorded after their casts on the compute
        stream — the writer's side stream waits on it."""
        _unit, meta = self._units[unit_name]
        flat = [(key, grads[key].float().reshape(-1)) for key in meta]
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(self._compute_stream)
        return flat, ready

    def _write_grads(self, unit_name: str, staged: tuple,  # thread: executor, writer
                     gate: Future | None = None) -> None:
        """Land one unit's fp32 grads in the host flat buffer, screening
        them for Inf/NaN first (fused policies).  Returns only once the
        copies (and the verdict) have landed."""
        if self.flat is None:
            raise RuntimeError("serve-mode session has no gradient buffer")
        if gate is not None:
            gate.result()   # step k-1's Adam must consume flat[unit] first
        grads, ready = staged
        if self.device.type != "cuda":
            if self._screen_regions:
                self._screen_unit_region(unit_name, grads)
            for key, g in grads:
                off, size, _shape = self._flat_offsets[f"{unit_name}/{key}"]
                self._flat_t[off:off + size].copy_(g)
            if self._screen_regions:
                self._read_verdict(unit_name)
            return
        done = torch.cuda.Event()
        try:
            with torch.cuda.stream(self._d2h_stream):
                self._d2h_stream.wait_event(ready)
                if self._screen_regions:
                    self._screen_unit_region(unit_name, grads)
                for key, g in grads:
                    off, size, _shape = \
                        self._flat_offsets[f"{unit_name}/{key}"]
                    self._flat_t[off:off + size].copy_(g, non_blocking=True)
                    g.record_stream(self._d2h_stream)
                if self._screen_regions:
                    i = self._flag_index[unit_name]
                    self._flags_host[i:i + 1].copy_(self._flags[i:i + 1],
                                                    non_blocking=True)
        finally:
            # whatever was enqueued lands before the region or the flag is
            # read, or the flat buffer is freed
            done.record(self._d2h_stream)
            done.synchronize()
        if self._screen_regions:
            self._read_verdict(unit_name)

    def _screen_unit_region(self, unit_name: str, grads: list) -> None:  # thread: executor, writer
        """Per-unit half of the fused overflow check: every fp32 gradient
        tensor of the unit ORs its Inf/NaN verdict into the unit's flag
        (the Hopper kernel on the card, its plain version on the CPU), on
        the stream that then copies the tensors out."""
        t0 = time.perf_counter()
        i = self._flag_index[unit_name]
        flag = self._flags[i:i + 1]
        flag.zero_()
        for _key, g in grads:
            ops.overflow_flag_(g, flag)
        self._ostats.add_worker_seconds("overflow_screen_seconds",
                                        time.perf_counter() - t0)

    def _read_verdict(self, unit_name: str) -> None:  # thread: executor, writer
        t0 = time.perf_counter()
        verdict = bool(self._flags_host[self._flag_index[unit_name]])
        self._ostats.add_worker_seconds("overflow_screen_seconds",
                                        time.perf_counter() - t0)
        with self._screen_lock:
            self._region_verdicts[unit_name] = verdict

    # -- overflow + optimizer plan ops ---------------------------------------

    def _exec_overflow(self, op: OverflowCheckOp, state: _ExecState) -> None:  # thread: executor
        """OverflowCheckOp: drain the writer (the barrier that makes every
        GradWriteOp visible), combine the step verdict, update the scaler.

        With ``op.regions`` under a fused policy the verdict is the OR of
        the per-unit screens that already ran as each write-back landed
        (equal to the whole-buffer scan by the partition invariant); the
        chained-baseline policy, whose 2.25x temporary peak is the thing
        being measured, keeps the whole-buffer host scan here."""
        if self.flat is None:
            raise RuntimeError("serve-mode session has no gradient buffer")
        if self._grad_writer is not None:
            t0 = time.perf_counter()
            self._grad_writer.drain()
            self._ostats.gradwrite_drain_seconds += time.perf_counter() - t0
        with self._screen_lock:
            verdicts, self._region_verdicts = self._region_verdicts, {}
        if op.regions and self._screen_regions:
            overflow = False
            for unit in op.regions:
                verdict = verdicts.get(unit)
                if verdict is None:
                    # a write-back that bypassed the screen (e.g. a test
                    # stubbing _write_grads): screen the region on the host
                    # now so the verdict still covers every gradient
                    lo, hi = self._unit_flat_region[unit]
                    t0 = time.perf_counter()
                    verdict = bool(check_region(self.flat, lo, hi,
                                                fused=True,
                                                tracker=self.tracker))
                    self._ostats.add_worker_seconds(
                        "overflow_screen_seconds", time.perf_counter() - t0)
                overflow = overflow or verdict
        else:
            overflow = bool(flat_overflow_check(
                self.flat, fused=self.policy.fused_overflow,
                tracker=self.tracker))
        state.overflowed = overflow
        state.apply = self.scaler.update(state.overflowed)

    def _exec_optim(self, unit_name: str, state: _ExecState) -> None:  # thread: executor
        """OptimStepOp: stream one unit's subgroups through the host Adam —
        inline, or pipelined across the optimizer + state-prefetch workers
        with a readiness future that resolves when the unit's **last
        write-back lands** (commit), gating the next step's fetch and
        grad-write for this unit.

        An overflow-skipped step (``state.apply`` false) returns before
        anything is enqueued, so no state is prefetched for it and nothing
        is left in flight to corrupt."""
        if self.optimizer is None:
            raise RuntimeError("serve-mode session has no optimizer")
        if state.apply is None:   # validated at plan build; defensive
            raise RuntimeError("OptimStepOp before OverflowCheckOp")
        if not state.apply:
            return                # skipped step: weights unchanged
        if not state.optim_begun:
            state.optim_begun = True
            if self._optim_worker is not None:
                # previous-step Adam tasks have all resolved (every unit's
                # grad write this step gated on its step k-1 future and the
                # barrier drained the writer), so the pipeline bookkeeping
                # can be reset from this thread before new work lands
                with self._adam_lock:
                    self._adam_work = []
                self._adam_issued = 0
                self._adam_inflight = deque()
                self._adam_poison = None
                self._optim_worker.submit(self.optimizer.begin_step)
            else:
                self.optimizer.begin_step()
        inv_scale = np.float32(1.0 / state.scale)
        if self._optim_worker is not None:
            _unit, meta = self._units[unit_name]
            with self._adam_lock:
                lo = len(self._adam_work)
                self._adam_work.extend(
                    (unit_name, key) for key in meta)
                hi = len(self._adam_work)
            task = (self._optim_unit_paged
                    if unit_name in self._expert_meta
                    else self._optim_unit_pipelined)
            fut = self._optim_worker.submit(
                functools.partial(task, unit_name, lo, hi, inv_scale))
        else:
            self._optim_unit(unit_name, inv_scale)
            if unit_name in self._expert_meta:
                self._expert_cache.invalidate_unit(unit_name)
            fut = done_future()
        with self._optim_lock:
            self._optim_futures[unit_name] = fut

    def _optim_unit(self, unit_name: str, inv_scale: np.float32) -> None:  # thread: executor
        """Inline (sync/h2d) Adam stage: stream subgroups synchronously
        (the same three halves, composed back to back)."""
        _unit, meta = self._units[unit_name]
        for key in meta:
            skey = f"{unit_name}/{key}"
            staged = self.optimizer.issue_subgroup(skey)
            try:
                self.optimizer.compute_subgroup(
                    staged, self._unit_grad(skey, inv_scale))
            except BaseException:
                self.optimizer.discard_staged(staged)
                raise
            self.optimizer.commit_subgroup(staged)

    def _unit_grad(self, skey: str, inv_scale: np.float32) -> np.ndarray:  # thread: executor, optim-worker
        """Unscale one subgroup's gradient out of the flat buffer.

        Unscale with the scale the grads were produced under, not the
        post-update one — on a growth step they differ by 2x.  The multiply
        also copies out of the flat buffer, whose region is free for the
        next step's write-back once the unit's readiness future resolves.
        """
        off, size, shape = self._flat_offsets[skey]
        return self.flat[off:off + size].reshape(shape) * inv_scale

    # -- the pipelined Adam stage (full overlap) -----------------------------

    def _adam_ensure_issued(self, upto: int) -> None:  # thread: optim-worker
        """Submit state-prefetch issues for work indices < ``upto``.

        Deadlock-freedom of the arena's blocking acquire (inside the issue,
        on the state-prefetch worker): every held buffer is released by a
        write-completion callback on the optimizer's write-back executor
        (commit), by the optimizer worker (error paths), or by the issue's
        own failure handler — never by a task queued *behind* the blocked
        issue on the state-prefetch worker itself.
        """
        with self._adam_lock:
            n = len(self._adam_work)
            pending = [self._adam_work[i]
                       for i in range(self._adam_issued, min(upto, n))]
        for unit_name, key in pending:
            fut = self._optim_prefetch.submit(functools.partial(
                self.optimizer.issue_subgroup, f"{unit_name}/{key}"))
            self._adam_inflight.append((self._adam_issued, fut))
            self._adam_issued += 1

    def _optim_unit_pipelined(self, unit_name: str, lo: int, hi: int,  # thread: optim-worker
                              inv_scale: np.float32) -> None:
        """Optimizer-worker task for one unit's subgroups [lo, hi):
        subgroup *k+1*'s (master, m, v) streams into the staging arena
        while *k*'s ``adam_update`` runs, and *k−1*'s write-backs drain
        behind them.  Returns — resolving the unit's readiness future —
        only once every commit landed.

        On any failure the whole in-flight window is drained and the step
        is **poisoned**: the remaining unit tasks fail fast with the *same*
        exception instance, so a failure surfaces exactly once while every
        affected unit's readiness future still refuses to serve its
        un-updated weights."""
        if self._adam_poison is not None:
            raise self._adam_poison
        commits: list[Future] = []
        try:
            for g in range(lo, hi):
                self._adam_ensure_issued(g + 2)
                idx, staged_fut = self._adam_inflight.popleft()
                if idx != g:    # defensive; the reset/cleanup paths keep
                    raise RuntimeError(   # issue order == work order
                        f"adam pipeline out of order: staged {idx}, "
                        f"expected {g}")
                t0 = time.perf_counter()
                try:
                    staged = staged_fut.result()
                finally:
                    self._ostats.add_worker_seconds(
                        "optim_prefetch_wait_seconds",
                        time.perf_counter() - t0)
                try:
                    self.optimizer.compute_subgroup(
                        staged, self._unit_grad(staged.key, inv_scale))
                except BaseException:
                    self.optimizer.discard_staged(staged)
                    raise
                commits.append(
                    self.optimizer.commit_subgroup_async(staged))
            for commit in commits:
                commit.result()
        except BaseException as e:
            self._adam_poison = e
            self._adam_abort(commits, resume_at=hi)
            raise

    def _optim_unit_paged(self, unit_name: str, lo: int, hi: int,  # thread: optim-worker
                          inv_scale: np.float32) -> None:
        """Pipelined Adam for a paged-MoE unit, then expert-page
        invalidation (the commit rewrote the unit's SSD compute copies)
        BEFORE the readiness future resolves: the next step's fetch window
        — and therefore every expert prestage or ensure for this unit —
        gates on that future, so no page can be pinned while the
        invalidation drops it."""
        self._optim_unit_pipelined(unit_name, lo, hi, inv_scale)
        self._expert_cache.invalidate_unit(unit_name)

    def _adam_abort(self, commits: list[Future], *, resume_at: int) -> None:  # thread: optim-worker
        """Failure path of a unit task: wait out this unit's commits (each
        releases its own buffer), release every issued-but-never-computed
        staging buffer, and reset the issue counter to ``resume_at``."""
        for commit in commits:
            # the buffer was released in commit's finally
            with contextlib.suppress(BaseException):
                commit.result()
        while self._adam_inflight:
            _idx, staged_fut = self._adam_inflight.popleft()
            try:
                staged = staged_fut.result()
            except BaseException:
                continue        # a failed issue released its own buffer
            self.optimizer.discard_staged(staged)
        self._adam_issued = resume_at

    def _snapshot_optim_io(self) -> None:  # thread: optim-worker
        # queued after a step's last OptimStepOp: the completed-step ledger
        io = self.optimizer.last_io_bytes
        with self._optim_lock:
            self._optim_io_completed = io

    # -- training workloads --------------------------------------------------

    def train_step(self, tokens: np.ndarray, labels: np.ndarray) -> dict:  # thread: executor
        """One streamed training step; the whole pipeline — forward,
        backward, overflow screen, host Adam — executes as the train plan.

        Under ``overlap="full"`` the optimizer stage may still be streaming
        when this returns (it overlaps the *next* step's prefetch window);
        ``metrics["optimizer_io_bytes"]`` then reports the most recently
        *completed* step (0 until one completes) — call :meth:`synchronize`
        first for an exact up-to-date value.
        """
        if self.mode != "train":
            raise RuntimeError("train_step requires a train-mode session")
        wait0 = self.swapper.stats.wait_seconds
        hits0 = self.swapper.stats.prefetch_hits
        o0 = self._ostats.snapshot()
        grad_scale = self.scaler.scale   # the flat-buffer grads carry this
        state = self.execute(self.plan("train"), _ExecState(
            self._tokens(tokens), self._tokens(labels), grad_scale))
        if self._optim_worker is not None and state.apply:
            self._optim_worker.submit(self._snapshot_optim_io)

        ssd_wait = self.swapper.stats.wait_seconds - wait0
        h2d_wait = self._ostats.h2d_wait_seconds - o0["h2d_wait_seconds"]
        if self._optim_worker is not None:
            with self._optim_lock:
                optim_io = self._optim_io_completed
        else:
            optim_io = self.optimizer.last_io_bytes
        self.metrics = {
            "loss": float(state.loss),
            "overflowed": state.overflowed,
            "applied": state.apply,
            "loss_scale": self.scaler.scale,
            "optimizer_io_bytes": optim_io,
            "peak_host_bytes": self.tracker.peak_allocated,
            # compute-thread stall obtaining device weights at FetchOps —
            # read wait + H2D inline (sync) or staged-future wait (overlap
            # modes).  Comparable across overlap levels by construction.
            "fetch_wait_s": self._ostats.fetch_seconds - o0["fetch_seconds"],
            "ssd_wait_s": ssd_wait,    # raw read waits, whichever thread
            "h2d_wait_s": h2d_wait,    # staged-future share of fetch_wait_s
            "prefetch_hits": (self.swapper.stats.prefetch_hits - hits0
                              + self._ostats.h2d_hits - o0["h2d_hits"]),
            "gradwrite_drain_s": (self._ostats.gradwrite_drain_seconds
                                  - o0["gradwrite_drain_seconds"]),
            "optim_gate_s": (self._ostats.optim_gate_seconds
                             - o0["optim_gate_seconds"]),
        }
        o1 = self._ostats.snapshot()
        # worker-side counters: the Adam stage of step k accrues these
        # while step k+1's window runs, so (like optim_gate_s) they are
        # attributed to the train_step whose wall-clock window they land in
        for metric, counter in (
                ("optim_prefetch_wait_s", "optim_prefetch_wait_seconds"),
                # the writer's time in the per-unit screen: kernel launches
                # and the flag read after the unit's D2H synchronised
                ("overflow_screen_s", "overflow_screen_seconds"),
                ("act_save_wait_s", "act_save_wait_seconds"),
                ("act_fetch_wait_s", "act_fetch_wait_seconds"),
                ("act_write_failures", "act_write_failures"),
                # expert paging: executor stall at ExpertFetchOp gates
                # (staged-stack waits, miss restages, on-demand fetches);
                # the bytes and prestage gets / hits are in
                # overlap_snapshot(), as in the reference
                ("expert_fetch_wait_s", "expert_fetch_wait_seconds")):
            self.metrics[metric] = o1[counter] - o0[counter]
        return self.metrics

    def eval_loss(self, tokens: np.ndarray, labels: np.ndarray) -> float:  # thread: executor
        """Streamed forward + head loss (no gradients, no optimizer)."""
        state = self.execute(self.plan("eval"), _ExecState(
            self._tokens(tokens), self._tokens(labels)))
        return float(state.loss)

    def master_param(self, unit_name: str, key: str) -> np.ndarray:  # thread: executor
        """The fp32 (or bf16-bit) master weights of one tensor, read from
        the store after the pipeline drained."""
        if self.mode != "train":
            raise RuntimeError("serve-mode sessions hold no master weights")
        self.synchronize()    # an in-flight Adam stage may still be writing
        _unit, meta = self._units[unit_name]
        shape, _ = meta[key]
        sd = self.policy.adam.state_np_dtype
        return self.store.read_new(f"{unit_name}/{key}.master", sd, shape)

    # -- serving -------------------------------------------------------------

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)

    def _lengths(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    def decode_logits(self, tokens: np.ndarray) -> np.ndarray:
        """One weight-streamed pass over ``tokens`` (batch, time): fp32
        logits for every position.  The uncached (full-prefix) path —
        O(T²) over a generation; the ablation baseline."""
        state = self.execute(self.plan("decode"),
                             _ExecState(self._tokens(tokens)))
        return to_host(state.logits)

    def open_kv_cache(self) -> SpillableKVCache:
        """A fresh paged spill-able KV cache drawing from this session's
        pool.  One at a time: the census reserves exactly the spec's
        page-slot budget.  Close it (``finally:``) to return the slots."""
        if self.decode_spec is None:
            raise RuntimeError(
                "session was built without decode=DecodeSpec(...); cached "
                "decode needs its KV page slots sized into the pool census")
        if self._kv_cache is not None and not self._kv_cache.closed:
            raise RuntimeError("a KV cache is already open on this session; "
                               "close it first (its pool slots are shared)")
        self._kv_cache = SpillableKVCache(
            list(self._kv_units), self._kv_page_shape,
            self.decode_spec.max_seq,
            self.policy.adam.compute_np_dtype, self.pool, self.store,
            resident_limit=self._kv_resident,
            slots=self.decode_spec.batch)
        return self._kv_cache

    def _decode_state(self, kv: SpillableKVCache) -> DecodeSpec:
        if self.decode_spec is None:
            raise RuntimeError("session has no decode spec")
        if kv.closed:
            raise RuntimeError("KV cache is closed")
        return self.decode_spec

    def prefill(self, kv: SpillableKVCache, tokens: np.ndarray, *,
                slots: list[int] | None = None,
                lengths: list[int] | None = None) -> np.ndarray:
        """Prompt pass: cache every block's K/V, return the last valid
        position's logits as fp32 (batch, vocab).  Prompts are right-padded
        to the spec's time bucket.

        Joint path (``slots=None``): every lane carries the same prompt
        length and the whole cache must be empty.

        Joiner path (continuous batching): ``slots`` names the freshly
        joined, empty batch slots being prefilled and ``lengths`` their
        true prompt lengths (``tokens`` rows are right-padded to the
        longest).  Only those slots' pages are written (prefill-scatter);
        the other lanes' rows are computed and discarded, so mid-flight
        requests are untouched and the shapes stay fixed.  Callers group
        joiners by prompt *bucket*: a joiner then runs at the shapes a solo
        prefill of that request would, which keeps continuously batched
        greedy output equal to decoding each request alone."""
        spec = self._decode_state(kv)
        tokens = np.asarray(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != spec.batch:
            raise ValueError(f"prompts must be (batch={spec.batch}, time), "
                             f"got {tokens.shape}")
        t0 = tokens.shape[1]
        if slots is None:
            if kv.length != 0:
                raise RuntimeError("prefill on a non-empty KV cache; open a "
                                   "fresh one per generation")
            last = torch.tensor(t0 - 1, dtype=torch.int64,
                                device=self.device)
        else:
            if lengths is None or len(lengths) != len(slots):
                raise ValueError("joiner prefill needs lengths, one per slot")
            for s, n in zip(slots, lengths, strict=True):
                if s not in kv.active or kv.slot_length(s) != 0:
                    raise RuntimeError(
                        f"slot {s} is not a freshly joined empty slot")
                if not 1 <= n <= t0:
                    raise ValueError(f"prompt length {n} outside [1, {t0}]")
            # per-row last valid position; non-joiner rows read position 0
            # (their logits rows are discarded by the caller)
            pos = np.zeros(spec.batch, np.int64)
            for s, n in zip(slots, lengths, strict=True):
                pos[s] = n - 1
            last = self._lengths(pos)
        padded = np.zeros((spec.batch, spec.bucket_len(t0)), np.int64)
        padded[:, :t0] = tokens
        state = _ExecState(self._tokens(padded))
        state.kv = kv
        state.kv_write_slots = slots
        state.last_pos = last
        state = self.execute(self.plan("prefill"), state)
        if slots is None:
            kv.set_length(t0)
        else:
            for s, n in zip(slots, lengths, strict=True):
                kv.set_slot_length(s, n)
        return to_host(state.logits[:, 0])

    def decode_step(self, kv: SpillableKVCache,
                    tokens: np.ndarray) -> np.ndarray:
        """One cached decode step: append ``tokens`` (batch, 1) to the
        cache, return next-token logits as fp32 (batch, vocab).  Per-token
        cost is O(bucket), independent of how many tokens were emitted."""
        spec = self._decode_state(kv)
        tokens = np.asarray(tokens)
        if tokens.shape != (spec.batch, 1):
            raise ValueError(f"step tokens must be (batch={spec.batch}, 1), "
                             f"got {tokens.shape}")
        if kv.length < 1:
            raise RuntimeError("decode_step before prefill")
        if kv.length + 1 > spec.max_seq:
            raise ValueError(f"KV cache full at max_seq={spec.max_seq}")
        state = _ExecState(self._tokens(tokens))
        state.kv = kv
        state.kv_time = spec.bucket_len(kv.length)
        state.cache_len = torch.tensor(kv.length, dtype=torch.int64,
                                       device=self.device)
        state = self.execute(self.plan("decode_cached"), state)
        kv.advance(1)
        return to_host(state.logits[:, 0])

    def _slot_lengths(self, kv: SpillableKVCache, spec: DecodeSpec,
                      window: int, what: str) -> np.ndarray:
        """Per-lane cache lengths (0 for inactive lanes) of a per-slot
        step or verify pass of ``window`` positions; every active slot
        must be prefilled and have room for the window."""
        active = sorted(kv.active)
        if not active:
            raise RuntimeError(f"{what} with no active slots")
        lens = np.zeros(spec.batch, np.int64)
        for s in active:
            n = kv.slot_length(s)
            if n < 1:
                raise RuntimeError(f"{what} before slot {s}'s prefill")
            if n + window > spec.max_seq:
                raise ValueError(
                    f"KV cache full: slot {s} length {n} + window {window} "
                    f"exceeds max_seq={spec.max_seq}")
            lens[s] = n
        return lens

    def decode_step_slots(self, kv: SpillableKVCache,
                          tokens: np.ndarray) -> np.ndarray:
        """One cached decode step over per-slot lengths (continuous
        batching): every **active** slot's lane appends its token at that
        slot's own position; inactive lanes carry token 0 and are masked
        to self-attention only (``cache_len`` 0), their logits discarded.
        The same ``decode_cached`` plan as :meth:`decode_step` with a (B,)
        ``cache_len``; the device extent is the time bucket covering the
        longest active slot, and the attention step's chunked reductions
        keep each lane's output bitwise a solo decode's."""
        spec = self._decode_state(kv)
        tokens = np.asarray(tokens)
        if tokens.shape != (spec.batch, 1):
            raise ValueError(f"step tokens must be (batch={spec.batch}, 1), "
                             f"got {tokens.shape}")
        lens = self._slot_lengths(kv, spec, 1, "decode_step_slots")
        state = _ExecState(self._tokens(tokens))
        state.kv = kv
        state.kv_time = spec.bucket_len(int(lens.max()))
        state.cache_len = self._lengths(lens)
        state = self.execute(self.plan("decode_cached"), state)
        kv.advance(1)
        return to_host(state.logits[:, 0])

    def _verify(self, kv: SpillableKVCache, spec: DecodeSpec,
                tokens: np.ndarray, extent: int,
                cache_len: torch.Tensor) -> np.ndarray:
        n = tokens.shape[1]
        padded = np.zeros((spec.batch, verify_bucket(n)), np.int64)
        padded[:, :n] = tokens
        state = _ExecState(self._tokens(padded))
        state.kv = kv
        state.kv_time = spec.bucket_len(extent)
        state.cache_len = cache_len
        state = self.execute(self.plan("decode_verify"), state)
        return to_host(state.logits[:, :n])

    def _verify_window(self, spec: DecodeSpec, tokens) -> np.ndarray:
        tokens = np.asarray(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != spec.batch or \
                tokens.shape[1] < 1:
            raise ValueError(f"verify window must be (batch={spec.batch}, "
                             f"n >= 1), got {tokens.shape}")
        return tokens

    def verify_step(self, kv: SpillableKVCache,
                    tokens: np.ndarray) -> np.ndarray:
        """Speculative-decode verify: step a ``(batch, n)`` draft window in
        ONE streamed pass over the weights and return all ``n`` positions'
        next-token logits as fp32 ``(batch, n, vocab)``.  Position ``j``'s
        row is bitwise what :meth:`decode_step` would have produced after
        the first ``j`` draft tokens were appended; the host commits the
        accepted prefix and rolls the cache back over the rejected tail
        (:meth:`~SpillableKVCache.rollback`).  The window is padded to
        :func:`verify_bucket`; slot lengths do NOT advance here."""
        spec = self._decode_state(kv)
        tokens = self._verify_window(spec, tokens)
        k_pad = verify_bucket(tokens.shape[1])
        if kv.length < 1:
            raise RuntimeError("verify_step before prefill")
        if kv.length + k_pad > spec.max_seq:
            raise ValueError(
                f"KV cache full: length {kv.length} + padded window "
                f"{k_pad} exceeds max_seq={spec.max_seq}")
        cache_len = torch.tensor(kv.length, dtype=torch.int64,
                                 device=self.device)
        return self._verify(kv, spec, tokens, kv.length + k_pad, cache_len)

    def verify_step_slots(self, kv: SpillableKVCache,
                          tokens: np.ndarray) -> np.ndarray:
        """:meth:`verify_step` over per-slot lengths (continuous
        batching): each **active** slot's lane steps its own draft window
        at that slot's position; inactive lanes carry token 0, masked to
        self-attention only, logits discarded.  Slots accept and roll back
        independently.  The extent is the time bucket covering the
        longest active slot plus the padded window."""
        spec = self._decode_state(kv)
        tokens = self._verify_window(spec, tokens)
        k_pad = verify_bucket(tokens.shape[1])
        lens = self._slot_lengths(kv, spec, k_pad, "verify_step_slots")
        return self._verify(kv, spec, tokens, int(lens.max()) + k_pad,
                            self._lengths(lens))

    def overlap_snapshot(self) -> dict:
        """Point-in-time copy of the overlap-pipeline stall counters
        (:class:`~repro_torch.core.overlap.OverlapStats`), including the
        staged-KV numbers serving cares about: ``kv_stage_gets`` /
        ``_hits`` and ``kv_stage_wait_seconds``."""
        return self._ostats.snapshot()
