"""OffloadSession: owns the offload lifecycle and executes StreamPlans.

Port of the serve mode of ``src/repro/core/session.py``.  One session = one
open store/allocator/pool/swapper stack over an
:class:`~repro_torch.core.offload_engine.OffloadableModel`; a context
manager, so the pinned arena and in-flight SSD reads are always drained and
returned, success or error.

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

Cached decode (``prefill`` / ``decode_step``) runs over a paged spill-able
KV cache (:mod:`repro_torch.core.kv_cache`) whose page slots come from the
same pool arena.  Training (``mode="train"``) comes with the training slice.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from .buffer_pool import KV_CLASS
from .dtypes import cast_host, to_host, to_torch, torch_dtype
from .kv_cache import DecodeSpec, SpillableKVCache
from .memory_tracker import MemoryTracker
from .overlap import DeviceSlots, OverlapStats, SerialWorker
from .stream_plan import (ComputeOp, FetchOp, KVReadOp, KVWriteOp, ReleaseOp,
                          StreamPlan, compile_decode_cached, compile_prefill)
from .swapper import ParameterSwapper

COMPUTE_SUFFIX = ".compute"    # store key suffix of compute-precision weights


class _ExecState:
    """Per-plan-run bindings and carried activations."""

    __slots__ = ("tokens", "h", "logits", "live", "live_slots", "h2d",
                 "kv", "kv_live", "kv_append", "kv_stage", "kv_slots",
                 "kv_time", "cache_len", "last_pos", "stage_seq")

    def __init__(self, tokens: torch.Tensor):
        self.tokens = tokens
        self.h = self.logits = None
        self.live: dict[str, dict] = {}     # unit -> device params
        self.live_slots: dict[str, tuple] = {}  # unit -> device-slot tokens
        self.h2d: dict[str, deque] = {}     # unit -> staged-fetch futures
        self.kv: SpillableKVCache | None = None
        self.kv_live: dict[str, tuple] = {}    # unit -> device (k, v) window
        self.kv_append: dict[str, tuple] = {}  # unit -> device (k, v) to land
        self.kv_stage: dict[str, Future] = {}  # unit -> staged-KV future
        self.kv_slots: dict[str, tuple] = {}   # unit -> kv device-slot tokens
        self.kv_time = 0          # device-cache bucket extent this run
        self.cache_len = None     # device int: tokens already cached
        self.last_pos = None      # device int (1,): last prompt index
        # (kind, unit) per staging-worker submission, in FIFO order —
        # "w" weight stages and "kv" window stages interleave on ONE
        # worker, so the abort path must drain them in this exact order
        self.stage_seq: list[tuple[str, str]] = []


class OffloadSession:
    """Executes StreamPlans over one open offload stack (context manager)."""

    def __init__(self, model, policy, *, tracker: MemoryTracker | None = None,
                 mode: str = "serve",
                 decode: DecodeSpec | None = None) -> None:
        if mode == "train":
            raise NotImplementedError(
                "mode='train' is not ported yet: the PyTorch port's "
                "training step comes with the training slice")
        if mode != "serve":
            raise ValueError(f"mode must be 'serve' (or 'train'), got "
                             f"{mode!r}")
        self.model = model
        self.policy = policy
        self.device = torch.device(model.device)
        self.tracker = tracker or MemoryTracker()
        self.store = policy.store_factory()
        # The store is open from here on: if any later construction step
        # fails, __enter__ never runs and no caller can close() — release
        # whatever was acquired before re-raising.
        self._closed = False
        try:
            self._construct(model, policy, decode)
        except BaseException:
            self.close()
            raise

    # pre-share: runs inside __init__, before any worker thread exists
    def _construct(self, model, policy,  # analyze: pre-share
                   decode: DecodeSpec | None) -> None:
        # The backing follows the device, explicitly: page-locked host
        # memory when the weights go to a CUDA device, plain numpy on CPU.
        self.allocator = policy.allocator_cls(
            tracker=self.tracker, component="pinned",
            backing="cuda" if self.device.type == "cuda" else "numpy")
        cd_host = policy.adam.compute_np_dtype
        self.compute_dtype = torch_dtype(policy.adam.compute_dtype)
        census = model.census(policy.inflight_blocks,
                              bytes_per_elem=cd_host.itemsize)
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
        self.swapper = ParameterSwapper(self.store, self.pool, class_of={
            f"{unit.name}/{key}{COMPUTE_SUFFIX}": model.class_of(key)
            for unit in model.units for key in unit.params})
        lookahead = policy.lookahead or policy.inflight_blocks
        self.lookahead = max(1, min(lookahead, policy.inflight_blocks))

        self._ostats = OverlapStats()
        self._device_slots: DeviceSlots | None = None
        self._h2d: SerialWorker | None = None
        if self.device.type == "cuda":
            self._compute_stream = torch.cuda.current_stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
        if policy.overlap in ("h2d", "full"):
            per_unit: dict[str, int] = {}
            for unit in model.units:
                counts: dict[str, int] = {}
                for key in unit.params:
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
            self._device_slots = DeviceSlots(depths)
            # latch=False: every staging future is awaited by the executor
            # (the wait half, or the abort path), which delivers failures.
            self._h2d = SerialWorker("offload-h2d", latch=False)

        # Serve mode writes only the compute-precision weights.
        self._units: dict[str, tuple] = {}
        for unit in model.units:
            meta = {}
            for key, value in unit.params.items():
                self.store.write(f"{unit.name}/{key}{COMPUTE_SUFFIX}",
                                 cast_host(value, policy.adam.compute_dtype))
                meta[key] = (value.shape, value.size)
            self._units[unit.name] = (unit, meta)
        self._plans: dict[str, StreamPlan] = {}

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "OffloadSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:  # thread: executor
        """Drain in-flight reads and the staging worker, return the arena,
        close the store.  Idempotent; runs on the error path via
        ``__exit__`` and on partially-constructed sessions (attributes may
        not exist yet).  The staging worker goes first (its queued jobs
        own swapper tickets), then the swapper drain sweeps any ticket
        nobody claimed."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        steps = []
        if getattr(self, "_kv_cache", None) is not None:
            steps.append(self._kv_cache.close)
        if getattr(self, "_h2d", None) is not None:
            steps.append(self._h2d.close)
        if getattr(self, "swapper", None) is not None:
            steps.append(self.swapper.drain)
        if getattr(self, "pool", None) is not None:
            steps.append(self.pool.close)
        steps.append(self.store.close)
        # every step must run even if an earlier one raises — otherwise the
        # arena/store leak with no way to retry; first failure re-raises.
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
        """Wait until the device finished every queued kernel and copy.
        (Serving has no cross-step host pipeline to drain.)"""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- plans --------------------------------------------------------------

    def plan(self, name: str) -> StreamPlan:
        """The session's compiled plan for ``name`` (prefill/decode_cached)."""
        if name not in self._plans:
            compiler = {"prefill": compile_prefill,
                        "decode_cached": compile_decode_cached}[name]
            self._plans[name] = compiler(self.model)
        return self._plans[name]

    # -- weight streaming ----------------------------------------------------

    def _param_keys(self, unit_name: str):
        unit, meta = self._units[unit_name]
        cd = self.policy.adam.compute_np_dtype
        for key, (shape, _size) in meta.items():
            yield key, f"{unit.name}/{key}{COMPUTE_SUFFIX}", cd, shape

    def _prefetch_unit(self, unit_name: str) -> None:
        for _key, skey, cd, shape in self._param_keys(unit_name):
            self.swapper.prefetch(skey, cd, shape)

    def _unit_in_flight(self, unit_name: str) -> bool:
        return any(self.swapper.in_flight(skey)
                   for _key, skey, _cd, _shape in
                   self._param_keys(unit_name))

    def _h2d_copy(self, host_view: np.ndarray) -> torch.Tensor:  # thread: executor, h2d-worker
        """Device copy of a host view (a pool slot or a gathered window).

        When this returns, the copy has landed: the caller may release the
        slot and the next SSD read may overwrite it.  On CUDA the copy is
        a DMA on the side stream, synchronised here on the calling thread
        (the staging worker, or in sync mode the executor that was going to
        wait anyway), never on an overlapped compute."""
        src = to_torch(host_view, self.compute_dtype)
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
        try:
            for op in plan.ops:
                if isinstance(op, FetchOp):
                    limit = min(fetch_pos + self.lookahead, len(fetch_order))
                    while next_prefetch < limit:
                        unit = fetch_order[next_prefetch]
                        head = next_prefetch == fetch_pos
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
                elif isinstance(op, ReleaseOp):
                    state.live.pop(op.unit, None)
                    tokens = state.live_slots.pop(op.unit, None)
                    if tokens:
                        self._device_slots.release_all(tokens)
                    kv_tokens = state.kv_slots.pop(op.unit, None)
                    if kv_tokens:
                        self._device_slots.release_all(kv_tokens)
                else:   # validated plans of this session hold no others
                    raise ValueError(f"op {op!r} is not a serving op")
        except BaseException:
            self._abort_execute(state)
            raise
        return state

    def _abort_execute(self, state: _ExecState) -> None:
        """Error path: nothing may leak.  Device-slot tokens are returned
        (resident units first, so a staging worker blocked on a slot can
        finish), staged fetches waited out in submission order, and
        outstanding reads drained back to the pool.  (KV pool slots belong
        to the SpillableKVCache, whose owner — generate()'s finally —
        closes it.)"""
        for tokens in state.live_slots.values():
            self._device_slots.release_all(tokens)
        state.live_slots.clear()
        for tokens in state.kv_slots.values():
            self._device_slots.release_all(tokens)
        state.kv_slots.clear()
        state.live.clear()
        # Staged fetches and KV windows must settle before the swapper
        # drain: a queued staging job that ran *after* the drain would
        # re-issue its reads and leak device slots.  Both kinds interleave
        # on ONE FIFO worker, so waits follow stage_seq's order — waiting a
        # later weight future while an earlier KV task still blocks on a kv
        # device slot would deadlock.
        for kind, unit in state.stage_seq:
            if kind == "w":
                pending = state.h2d.get(unit)
                if not pending:
                    continue
                fut = pending.popleft()
                try:
                    _params, tokens = fut.result()
                except BaseException:
                    continue      # the worker released its own claims
                self._device_slots.release_all(tokens)
            else:   # "kv"
                fut = state.kv_stage.pop(unit, None)
                if fut is None:
                    continue
                try:
                    fut.result()
                except BaseException:
                    continue      # the worker released its own slot
                self._device_slots.release_all([KV_CLASS])
        state.stage_seq.clear()
        state.h2d.clear()
        state.kv_live.clear()
        state.kv_append.clear()
        self.swapper.drain()

    def _compute(self, op: ComputeOp, state: _ExecState) -> None:
        params = state.live[op.unit]
        model = self.model
        if op.kind == "embed":
            state.h = model.embed_apply(params, state.tokens)
        elif op.kind == "head_logits":
            state.logits = model.head_logits(params, state.h)
        elif op.kind == "head_logits_last":
            # the last valid prompt position of the padded bucket, picked
            # by a device index (no host sync, one code path per length)
            state.logits = model.head_logits(
                params, state.h.index_select(1, state.last_pos))
        elif op.kind == "block_prefill":
            state.h, k, v = model.block_prefill(params, state.h)
            state.kv_append[op.unit] = (k, v)
        elif op.kind == "block_step":
            k_dev, v_dev = state.kv_live.pop(op.unit)
            state.h, k, v = model.block_step(
                params, state.h, k_dev, v_dev, state.cache_len,
                chunk=self.decode_spec.bucket)
            state.kv_append[op.unit] = (k, v)
        else:  # validated at plan build; defensive
            raise ValueError(f"unknown serving compute kind {op.kind!r}")

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
        stream): one token appended to the tail page (``step``) or the
        whole padded prompt window scattered across pages (``prefill``);
        the cache spills dirty pages onward past the residency budget."""
        k, v = state.kv_append.pop(op.unit)
        if op.mode == "prefill":
            state.kv.write_prefill(op.unit, to_host(k), to_host(v))
        elif op.mode == "step":
            state.kv.append(op.unit, to_host(k), to_host(v))
        else:
            raise ValueError(f"KV write mode {op.mode!r} is not ported yet")

    # -- cached decode (spill-able KV) ---------------------------------------

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)

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

    def prefill(self, kv: SpillableKVCache, tokens: np.ndarray) -> np.ndarray:
        """Prompt pass: cache every block's K/V, return the last prompt
        position's logits as fp32 (batch, vocab).  Every lane carries the
        same prompt length and the cache must be empty.  Prompts are
        right-padded to the spec's time bucket."""
        spec = self._decode_state(kv)
        tokens = np.asarray(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != spec.batch:
            raise ValueError(f"prompts must be (batch={spec.batch}, time), "
                             f"got {tokens.shape}")
        if kv.length != 0:
            raise RuntimeError("prefill on a non-empty KV cache; open a "
                               "fresh one per generation")
        t0 = tokens.shape[1]
        padded = np.zeros((spec.batch, spec.bucket_len(t0)), np.int64)
        padded[:, :t0] = tokens
        state = _ExecState(self._tokens(padded))
        state.kv = kv
        state.last_pos = torch.tensor([t0 - 1], dtype=torch.int64,
                                      device=self.device)
        state = self.execute(self.plan("prefill"), state)
        kv.set_length(t0)
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

    def overlap_snapshot(self) -> dict:
        """Point-in-time copy of the overlap-pipeline stall counters
        (:class:`~repro_torch.core.overlap.OverlapStats`), including the
        staged-KV numbers serving cares about: ``kv_stage_gets`` /
        ``_hits`` and ``kv_stage_wait_seconds``."""
        return self._ostats.snapshot()
