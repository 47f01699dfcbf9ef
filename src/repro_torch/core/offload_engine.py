"""The model-side offload interface and the policy layer.

Port of ``src/repro/core/offload_engine.py``: :class:`OffloadUnit`,
:class:`OffloadableModel` (with its pool census), :class:`OffloadPolicy`
(a validated, registry-addressable description of which allocator, pool,
overflow screen and store to run), :class:`PolicyBuilder` and the three
presets, and the :class:`OffloadedTrainer` shim over the session that
executes a policy, :class:`repro_torch.core.session.OffloadSession`.

Policies are selected by name through the registry::

    policy = OffloadPolicy.preset("memascend").with_store(root).build()

Two presets package the paper's comparison: ``zero-infinity`` (fixed pool +
pow2 pinned allocator + chained overflow check + per-tensor-file store) vs
``memascend`` (adaptive pool + alignment-free allocator + fused check +
direct NVMe engine); ``memascend-bf16`` adds the half-precision optimizer.
The activation-checkpoint fields (``offload_checkpoints``, ``act_policy``)
pick each block's checkpoint tier as in the reference: ``host`` by default,
``ssd``, ``recompute``, or ``device`` with ``offload_checkpoints=False``.
``expert_paging`` / ``expert_page_slots`` pick MoE expert residency
(``off``, ``all`` or ``routed``, see :mod:`repro_torch.core.paged`).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .buffer_pool import (AdaptiveBufferPool, BufferPoolBase, FixedBufferPool,
                          PoolCensus, ShapeClass)
from .nvme import DirectNVMeEngine, FilesystemEngine, TensorStore
from .memory_tracker import MemoryTracker
from .optimizer import AdamConfig
from .pinned_alloc import (AlignmentFreeAllocator, PinnedAllocatorBase,
                           PowerOfTwoCachingAllocator)
from .session import OffloadSession


# ---------------------------------------------------------------------------
# Model-side interface
# ---------------------------------------------------------------------------

@dataclass
class OffloadUnit:
    """One streamable unit: the embedding, one transformer block, or the head.

    ``params`` are the fp32 initial values (numpy); ``kind`` is
    "standalone" or "block" (block units share shape classes; standalone
    units get dedicated pool slots, per paper §IV-B).
    """

    name: str
    kind: str                       # "standalone" | "block"
    params: dict[str, np.ndarray]


@dataclass
class OffloadableModel:
    """Pure-function model description consumed by the session.

    apply signatures (``params`` is {name: tensor on ``device``}):
      embed_apply(params, tokens)              -> h
      block_apply(params, h)                   -> h (training forward;
                                                  differentiable)
      head_loss(params, h, labels)             -> scalar fp32 loss
      head_logits(params, h)                   -> fp32 logits
      block_prefill(params, h)                 -> h, k, v (cached decode
                                                  prompt pass)
      block_step(params, h, k_cache, v_cache, cache_len, *, chunk)
                                               -> h, k_new, v_new (cached
                                                  decode step)
      block_verify(params, h, k_cache, v_cache, cache_len, *, chunk)
                                               -> h, k_new, v_new (a
                                                  (batch, K) draft window,
                                                  bitwise K chained steps)
    ``class_of(param_key)`` maps a parameter to its pool shape class;
    ``kv_shape(batch, time)`` is one block's host KV-slot shape (leading
    axis 2 packs K and V); ``device`` is where the applies run.
    """

    units: list[OffloadUnit]
    embed_apply: Callable
    class_of: Callable[[str], str]
    device: torch.device
    block_apply: Callable | None = None
    head_loss: Callable | None = None
    head_logits: Callable | None = None
    block_prefill: Callable | None = None
    block_step: Callable | None = None
    block_verify: Callable | None = None
    kv_shape: Callable[[int, int], tuple] | None = None
    # route-aware expert paging (MoE): staged applies splitting one MoE
    # block into a routing half (the device computes the expert assignment
    # the host reads back) and an expert half (consumes the routed expert
    # stacks the ExpertFetchOp staged).  ``expert_meta`` maps MoE unit
    # name -> {"n_experts": E, "experts": [(gate, up, down) param-name
    # triples in stack order]}; units absent from it stream densely.
    #   block_route(params, h)                       -> hmid, idx
    #   block_moe(params, gate, up, down, idx, hmid) -> h
    #   block_moe_bwd(params, gate, up, down, idx, h, dh)
    #                        -> dparams, dgate, dup, ddown, dh_in
    #   block_{prefill,step,verify}_route(...)       -> hmid, k, v, idx
    block_route: Callable | None = None
    block_moe: Callable | None = None
    block_moe_bwd: Callable | None = None
    block_prefill_route: Callable | None = None
    block_step_route: Callable | None = None
    block_verify_route: Callable | None = None
    expert_meta: dict | None = None

    def expert_params(self, unit_name: str) -> list[str]:
        """Per-expert param names of one paged-MoE unit ([] if dense)."""
        if not self.expert_meta or unit_name not in self.expert_meta:
            return []
        return [name for triple in self.expert_meta[unit_name]["experts"]
                for name in triple]

    def census(self, inflight_blocks: int = 2, bytes_per_elem: int = 2, *,
               expert_page_slots: int | None = None) -> PoolCensus:
        """Shape-class census over the units (drives both pool designs).

        With ``expert_page_slots`` set (expert paging on), paged-MoE
        units' routed-expert tensors leave the per-block streaming counts
        — they are individually fetched pages, not per-fetch streams —
        and their class gains that many standalone page slots instead
        (the expert-residency budget, mirroring ``PoolCensus.with_kv``).
        """
        per_block: dict[str, int] = {}
        standalone: dict[str, int] = {}
        nbytes: dict[str, int] = {}
        for unit in self.units:
            counts: dict[str, int] = {}
            paged = set(self.expert_params(unit.name)) \
                if expert_page_slots is not None else set()
            for key, value in unit.params.items():
                cls = self.class_of(key)
                compute_nbytes = value.size * bytes_per_elem  # compute dtype
                nbytes[cls] = max(nbytes.get(cls, 0), compute_nbytes)
                if key in paged:
                    continue    # paged tensors get standalone slots below
                counts[cls] = counts.get(cls, 0) + 1
            if unit.kind == "block":
                for cls, c in counts.items():
                    per_block[cls] = max(per_block.get(cls, 0), c)
            else:
                for cls, c in counts.items():
                    standalone[cls] = standalone.get(cls, 0) + c
        if expert_page_slots is not None:
            from .paged import EXPERT_PAGE_CLASS
            if EXPERT_PAGE_CLASS not in nbytes:
                raise ValueError("expert_page_slots set but no unit has "
                                 "expert-class tensors")
            standalone[EXPERT_PAGE_CLASS] = \
                standalone.get(EXPERT_PAGE_CLASS, 0) + expert_page_slots
        classes = []
        for cls in sorted(nbytes):
            classes.append(ShapeClass(cls, nbytes[cls],
                                      per_block.get(cls, 0),
                                      standalone.get(cls, 0)))
        return PoolCensus(tuple(classes), inflight_blocks)


# ---------------------------------------------------------------------------
# Policies (baseline vs MemAscend): validated dataclass + named registry
# ---------------------------------------------------------------------------

_POLICY_REGISTRY: dict[str, Callable[..., "OffloadPolicy"]] = {}


def register_policy(name: str):
    """Decorator: make ``factory(root, **kw) -> OffloadPolicy`` addressable
    as ``OffloadPolicy.preset(name)``."""
    def deco(factory):
        _POLICY_REGISTRY[name] = factory
        return factory
    return deco


def policy_names() -> list[str]:
    return sorted(_POLICY_REGISTRY)


@dataclass
class OffloadPolicy:
    """Which allocator/pool/overflow/store to run, validated on build.

    ``inflight_blocks`` is the prefetch depth N that sizes the pool (§IV-B);
    ``lookahead`` bounds how many upcoming plan fetches the session issues
    asynchronously (None → inflight_blocks; 1 → synchronous per-unit
    fetches).

    ``overlap`` selects how much of the Fig. 6 pipeline runs on background
    threads (numerics are identical across modes):

    * ``"sync"`` — SSD reads still prefetch under compute, but H2D blocks
      inside each FetchOp and KVReadOp,
    * ``"h2d"``  — adds the H2D staging worker + double-buffered device
      slots: weight and KV-window copies hide under the previous block's
      compute,
    * ``"full"`` — adds the gradient writer thread (backward D2H overlaps
      the next block's re-fetch/recompute) and runs the optimizer stage on
      its own worker so step *k*'s host Adam interleaves with step *k+1*'s
      forward prefetch window; in serving, the same as ``"h2d"``.

    ``offload_checkpoints`` / ``act_policy`` pick where each block's
    activation checkpoint lives between forward and backward (see
    :func:`repro_torch.core.stream_plan.resolve_act_policy`);
    ``offload_checkpoints=False`` keeps every checkpoint on the device.
    """

    name: str
    allocator_cls: type
    pool_cls: type
    fused_overflow: bool
    store_factory: Callable[[], TensorStore]
    adam: AdamConfig = field(default_factory=AdamConfig)
    inflight_blocks: int = 2
    lookahead: int | None = None
    offload_checkpoints: bool = True   # offloaded gradient checkpointing
    overlap: str = "full"              # "sync" | "h2d" | "full" (Fig. 6)
    act_policy: object = "host"        # "host" | "ssd" | "recompute" |
    #                                    dict/sequence of per-block tiers
    expert_paging: str = "off"         # "off" | "all" | "routed": MoE
    #                                    expert residency (see paged.py) —
    #                                    "routed" fetches only the experts
    #                                    the router selected; "all" pages
    #                                    every expert; "off" streams
    #                                    experts densely with the block
    expert_page_slots: int | None = None  # host expert-page budget (pages);
    #                                       None -> every page resident

    def __post_init__(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise ValueError("policy name must be a non-empty string")
        if not (isinstance(self.allocator_cls, type)
                and issubclass(self.allocator_cls, PinnedAllocatorBase)):
            raise ValueError(f"allocator_cls must be a PinnedAllocatorBase "
                             f"subclass, got {self.allocator_cls!r}")
        if not (isinstance(self.pool_cls, type)
                and issubclass(self.pool_cls, BufferPoolBase)):
            raise ValueError(f"pool_cls must be a BufferPoolBase subclass, "
                             f"got {self.pool_cls!r}")
        if not callable(self.store_factory):
            raise ValueError("store_factory must be callable")
        if self.inflight_blocks < 1:
            raise ValueError(f"inflight_blocks must be >= 1, got "
                             f"{self.inflight_blocks}")
        if self.lookahead is not None and not (
                1 <= self.lookahead <= self.inflight_blocks):
            raise ValueError(
                f"lookahead must be in [1, inflight_blocks="
                f"{self.inflight_blocks}], got {self.lookahead} — a deeper "
                f"window would oversubscribe the pool (§IV-B sizing)")
        if self.overlap not in ("sync", "h2d", "full"):
            raise ValueError(f"overlap must be one of 'sync'|'h2d'|'full', "
                             f"got {self.overlap!r}")
        _act_tiers = ("host", "ssd", "recompute")
        if isinstance(self.act_policy, str):
            if self.act_policy not in _act_tiers:
                raise ValueError(
                    f"act_policy must be one of {_act_tiers} (or a "
                    f"per-block dict/sequence), got {self.act_policy!r} — "
                    f"device-resident checkpoints are selected via "
                    f"offload_checkpoints=False")
        elif isinstance(self.act_policy, dict):
            bad = sorted(t for t in self.act_policy.values()
                         if t not in _act_tiers)
            if bad:
                raise ValueError(f"act_policy has unknown tier(s) {bad}; "
                                 f"expected {_act_tiers}")
        else:
            try:
                tiers = list(self.act_policy)
            except TypeError:
                raise ValueError(f"act_policy must be a tier name, dict, or "
                                 f"sequence, got {self.act_policy!r}") from None
            bad = sorted(t for t in tiers if t not in _act_tiers)
            if bad:
                raise ValueError(f"act_policy has unknown tier(s) {bad}; "
                                 f"expected {_act_tiers}")
        if self.expert_paging not in ("off", "all", "routed"):
            raise ValueError(f"expert_paging must be one of "
                             f"'off'|'all'|'routed', got "
                             f"{self.expert_paging!r}")
        if self.expert_page_slots is not None:
            if self.expert_paging == "off":
                raise ValueError("expert_page_slots needs expert_paging="
                                 "'all'|'routed' (no page pool exists "
                                 "under 'off')")
            if self.expert_page_slots < 2:
                raise ValueError(
                    f"expert_page_slots must be >= 2 (one page pinned for "
                    f"a copy, one turning over), got "
                    f"{self.expert_page_slots}")
        if self.adam.state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"state_dtype must be float32|bfloat16, got "
                             f"{self.adam.state_dtype!r}")
        if self.adam.compute_dtype not in ("float32", "float16", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32|float16|"
                             f"bfloat16, got {self.adam.compute_dtype!r}")

    # -- registry access -----------------------------------------------------

    @staticmethod
    def preset(name: str, **kwargs) -> "PolicyBuilder":
        """A builder seeded from the named registry preset."""
        try:
            factory = _POLICY_REGISTRY[name]
        except KeyError:
            raise KeyError(f"unknown offload policy {name!r}; registered: "
                           f"{policy_names()}") from None
        return PolicyBuilder(name, factory, **kwargs)

    @staticmethod
    def names() -> list[str]:
        return policy_names()

    def replace(self, **changes) -> "OffloadPolicy":
        """A validated copy with ``changes`` applied (re-runs validation)."""
        return dataclasses.replace(self, **changes)


# with_adam/with_store route through one factory-kwargs dict; these names
# let each method reject options that belong to the other group.
_ADAM_FIELDS = frozenset(f.name for f in dataclasses.fields(AdamConfig))


class PolicyBuilder:
    """Fluent, validated construction of an :class:`OffloadPolicy`.

    ``OffloadPolicy.preset("memascend").with_store(root)
    .with_adam(compute_dtype="float32").with_lookahead(2).build()`` — every
    ``with_*`` returns the builder; :meth:`build` runs the preset factory
    and then the dataclass validation.
    """

    def __init__(self, name: str, factory: Callable, **factory_kwargs):
        self._name = name
        self._factory = factory
        self._factory_kwargs = dict(factory_kwargs)
        self._root: str | None = None
        self._store_factory: Callable[[], TensorStore] | None = None
        self._overrides: dict = {}

    def with_store(self, root: str | None = None, *,
                   factory: Callable[[], TensorStore] | None = None,
                   **store_kwargs) -> "PolicyBuilder":
        """Point the policy at SSD storage: a root directory for the
        preset's engine (``store_kwargs`` are forwarded to the preset
        factory, e.g. ``n_devices=`` for memascend), or an explicit
        zero-arg store factory."""
        if (root is None) == (factory is None):
            raise ValueError("with_store needs exactly one of root=/factory=")
        if factory is not None and store_kwargs:
            raise ValueError(
                f"store option(s) {sorted(store_kwargs)} only apply with "
                f"root= (they configure the preset's store engine); an "
                f"explicit factory= is already fully configured")
        misrouted = sorted(set(store_kwargs) & _ADAM_FIELDS)
        if misrouted:
            raise ValueError(f"with_store got Adam option(s) {misrouted}; "
                             f"use with_adam()")
        self._root = root
        self._store_factory = factory
        self._factory_kwargs.update(store_kwargs)
        return self

    def with_adam(self, **adam_kwargs) -> "PolicyBuilder":
        unknown = sorted(set(adam_kwargs) - _ADAM_FIELDS)
        if unknown:
            raise ValueError(
                f"with_adam got non-Adam option(s) {unknown}; AdamConfig "
                f"fields: {sorted(_ADAM_FIELDS)} (preset/store options go "
                f"via preset() or with_store())")
        self._factory_kwargs.update(adam_kwargs)
        return self

    def with_inflight_blocks(self, n: int) -> "PolicyBuilder":
        self._overrides["inflight_blocks"] = n
        return self

    def with_lookahead(self, n: int | None) -> "PolicyBuilder":
        self._overrides["lookahead"] = n
        return self

    def with_overlap(self, mode: str) -> "PolicyBuilder":
        """Pipeline-overlap ablation level: 'sync' | 'h2d' | 'full'."""
        self._overrides["overlap"] = mode
        return self

    def with_activations(self, policy) -> "PolicyBuilder":
        """Per-block activation-checkpoint tier: 'host' | 'ssd' |
        'recompute', or a dict/sequence of per-block tiers (see
        OffloadPolicy.act_policy)."""
        self._overrides["act_policy"] = policy
        return self

    def with_expert_paging(self, mode: str, *,
                           page_slots: int | None = None) -> "PolicyBuilder":
        """MoE expert residency: 'off' | 'all' | 'routed', with an
        optional host page budget (see OffloadPolicy.expert_paging)."""
        self._overrides["expert_paging"] = mode
        self._overrides["expert_page_slots"] = page_slots
        return self

    def with_overrides(self, **field_overrides) -> "PolicyBuilder":
        """Override any OffloadPolicy field post-factory (validated)."""
        self._overrides.update(field_overrides)
        return self

    def build(self) -> OffloadPolicy:
        if self._root is None and self._store_factory is None:
            raise ValueError(
                f"policy {self._name!r} has no store: call .with_store(root)")
        root = self._root if self._root is not None else "unused"
        try:
            policy = self._factory(root, **self._factory_kwargs)
        except TypeError as e:
            # Unknown kwargs would otherwise surface deep inside the preset
            # (e.g. AdamConfig), far from the with_store()/with_adam() call
            # that introduced them.
            raise ValueError(
                f"preset {self._name!r} rejected option(s) passed via "
                f"preset()/with_store()/with_adam(): {e}") from e
        changes = dict(self._overrides)
        if self._store_factory is not None:
            changes["store_factory"] = self._store_factory
        return policy.replace(**changes) if changes else policy


@register_policy("zero-infinity")
def zero_infinity_policy(root: str, **adam_kw) -> OffloadPolicy:
    return OffloadPolicy(
        name="zero-infinity",
        allocator_cls=PowerOfTwoCachingAllocator,
        pool_cls=FixedBufferPool,
        fused_overflow=False,
        store_factory=lambda r=root: FilesystemEngine(os.path.join(r, "fs_store")),
        adam=AdamConfig(**adam_kw),
    )


@register_policy("memascend")
def memascend_policy(root: str, *, bf16_optimizer: bool = False,
                     n_devices: int = 2, **adam_kw) -> OffloadPolicy:
    adam_kw.setdefault("state_dtype",
                       "bfloat16" if bf16_optimizer else "float32")
    return OffloadPolicy(
        name="memascend",
        allocator_cls=AlignmentFreeAllocator,
        pool_cls=AdaptiveBufferPool,
        fused_overflow=True,
        store_factory=lambda r=root: DirectNVMeEngine(
            os.path.join(r, "raw_store"), n_devices=n_devices),
        adam=AdamConfig(**adam_kw),
    )


@register_policy("memascend-bf16")
def memascend_bf16_policy(root: str, **kw) -> OffloadPolicy:
    kw.setdefault("bf16_optimizer", True)
    return memascend_policy(root, **kw).replace(name="memascend-bf16")


# ---------------------------------------------------------------------------
# Back-compat shim over OffloadSession
# ---------------------------------------------------------------------------

class OffloadedTrainer:
    """Thin shim: the seed trainer API, delegating to an OffloadSession.

    Prefer the session directly (context management, StreamPlans, lookahead
    control, serve mode); this class keeps the historical surface —
    ``train_step`` / ``eval_loss`` / ``master_param`` / ``close`` plus the
    ``store``/``pool``/``swapper``/``optimizer``/``scaler``/``flat``
    attributes — for existing callers and checkpoints.
    """

    def __init__(self, model: OffloadableModel, policy: OffloadPolicy,
                 *, tracker: MemoryTracker | None = None) -> None:
        self.session = OffloadSession(model, policy, tracker=tracker)

    def train_step(self, tokens: np.ndarray, labels: np.ndarray) -> dict:
        return self.session.train_step(tokens, labels)

    def eval_loss(self, tokens: np.ndarray, labels: np.ndarray) -> float:
        return self.session.eval_loss(tokens, labels)

    def master_param(self, unit_name: str, key: str) -> np.ndarray:
        return self.session.master_param(unit_name, key)

    def close(self) -> None:
        self.session.close()

    def __getattr__(self, name: str):
        # model/policy/tracker/store/pool/swapper/optimizer/scaler/flat/
        # total_params/metrics/synchronize/... all live on the session.
        if name == "session":   # session construction itself failed
            raise AttributeError(name)
        return getattr(self.session, name)
