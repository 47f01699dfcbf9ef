"""StreamPlan: a declarative schedule IR for SSD-offloaded execution.

The paper's pipeline (§IV-A, Fig. 5/6) is a *lifecycle* — pool-slot checkout
→ async SSD read → H2D → compute → release — that the seed code hard-coded
inside ``OffloadedTrainer.train_step``.  This module lifts that lifecycle
into data: a :class:`StreamPlan` is a linear sequence of twelve op kinds

* :class:`FetchOp`    — stream one unit's compute weights SSD→pool→device,
* :class:`ComputeOp`  — run one jitted stage against the resident weights,
* :class:`GradWriteOp`— spill the stage's parameter grads into the fp32
                        host flat buffer (ZeRO-Infinity's partition buffer),
* :class:`ReleaseOp`  — drop the unit's device weights,
* :class:`KVReadOp`   — make the unit's KV cache device-resident (waiting
                        out an SSD refill if the layer had spilled),
* :class:`KVWriteOp`  — land freshly produced K/V in the unit's host slot,
                        spilling onward past the residency budget,
* :class:`ActSaveOp`  — offload one block's activation checkpoint: D2H on
                        the gradient-writer thread (hidden under the next
                        block's forward compute) and, for the ``ssd``
                        tier, an onward store write that frees the host
                        copy (SSDTrain's activation leg, arXiv 2408.10013),
* :class:`ActFetchOp` — make an offloaded checkpoint device-resident for
                        its ``block_bwd``: the SSD read + H2D are issued
                        inside the lookahead window so block *i−1*'s
                        checkpoint streams back under block *i*'s backward,
* :class:`OverflowCheckOp` — drain the gradient write-back queue, screen
                        the flat buffer for Inf/NaN, update the loss
                        scaler (decides whether the step applies),
* :class:`ExpertFetchOp` / :class:`ExpertReleaseOp`
                      — the expert-paged MoE pair: stage the unit's
                        *routed* expert weights (chosen by its
                        ``block_route`` stage, predicted one step ahead by
                        the executor) as device (E, ...) stacks out of the
                        generalized page pool, and drop them after the
                        ``block_moe`` / ``block_moe_bwd`` stage consumed
                        them,
* :class:`OptimStepOp`— stream one unit's (master, m, v) subgroups through
                        the host Adam.  Inside the plan — rather than after
                        it — so the full-overlap executor can run step *k*'s
                        optimizer interleaved with step *k+1*'s forward
                        prefetch window (SSDTrain-style cross-step
                        pipelining, arXiv 2408.10013),

compiled once per workload from an ``OffloadableModel``:

* :func:`compile_train`  — forward + head loss/cotangent + reverse-streamed
                           backward with offloaded gradient checkpointing,
* :func:`compile_eval`   — forward + head loss only,
* :func:`compile_decode` — forward + head logits (weight-streamed serving;
                           uncached full-prefix pass),
* :func:`compile_prefill` / :func:`compile_decode_cached`
                         — the cached-decode pair: prompt pass landing
                           every layer's K/V in the spill-able cache, then
                           O(1)-context steps (checkout → fetch → KV read →
                           attend-with-cache → KV append → release/spill),
* :func:`compile_decode_verify`
                         — the speculative-decode verify step: identical
                           stream structure to ``decode_cached`` but each
                           block runs ``block_verify`` over a (B, K) draft
                           window and appends all K tokens' K/V at once
                           (host accept/rollback happens between plans).

Because the schedule is explicit, the executor (:class:`~repro_torch.core.session.
OffloadSession`) can *look ahead*: while block *i* computes, the SSD reads
for blocks *i+1 … i+N−1* are already in flight, with N bounded by
``policy.inflight_blocks`` — the prefetch depth that sizes the buffer pool
per §IV-B but that the seed engine never exploited.  SSDTrain
(arXiv 2408.10013) and 10Cache (arXiv 2511.14124) structure offloading the
same way: an explicit prefetch/eviction schedule rather than inline calls.
"""

from __future__ import annotations

from dataclasses import dataclass

# ComputeOp stage kinds understood by the session executor.
COMPUTE_KINDS = frozenset({
    "embed",         # h = embed_apply(params, tokens)
    "block",         # h = block_apply(params, h)   [save_input => checkpoint]
    "head_loss_grad",  # loss, head grads, dh = vjp(head_loss)
    "head_loss",     # loss = head_loss(params, h, labels)        (eval)
    "head_logits",   # logits = head_logits(params, h)            (decode)
    "head_logits_last",  # logits = head_logits(params, h[:, last])  (prefill)
    "block_bwd",     # dparams, dh = vjp(block_apply)(restored checkpoint)
    "embed_bwd",     # dembed = vjp(embed_apply)(tokens cotangent)
    "block_prefill",  # h, k, v = block_prefill(params, h)   -> kv append
    "block_step",    # h, k, v = block_step(params, h, kc, vc, len)
    "block_verify",  # h, k, v = block_verify(params, h, kc, vc, len)
                     #   (B, K) spec-decode draft window; K-token append
    "block_recompute",  # ckpt[recompute_for] = block_apply(params, ckpt[unit])
                     #   re-derive a dropped checkpoint from the previous
                     #   block's (peeked, not consumed) checkpoint
    # --- expert-paged MoE stages (route half / expert half split) ---
    "block_route",   # hmid, idx = mixer + router top-k; idx leaves the
                     #   device so the host can fetch the routed experts
    "block_moe",     # h = block_moe(params, gate, up, down, idx, hmid):
                     #   the routed FFN against staged expert stacks
    "block_moe_bwd",  # dparams, dgate, dup, ddown, dh = vjp(full block)
                     #   with the forward's expert assignment pinned
    "block_prefill_route",  # hmid, k, v, idx  (cached-decode prompt pass)
    "block_step_route",     # hmid, k, v, idx  (one-token cached step)
    "block_verify_route",   # hmid, k, v, idx  (spec-decode draft window)
})

# Activation-checkpoint tiers a block can be assigned (`act_policy`):
#   host       D2H into pinned host memory, H2D back for block_bwd
#   ssd        D2H + SSD write on the save side; SSD read + H2D prefetched
#              under the backward pass (SSDTrain-style streamed activations)
#   recompute  no checkpoint saved: backward re-runs `block` from the
#              previous block's checkpoint (trade FLOPs for bytes)
#   device     keep the device array (offload_checkpoints=False)
ACT_TIERS = frozenset({"host", "ssd", "recompute", "device"})
# Tiers an ActSaveOp can carry (the offloaded ones).
_ACT_SAVE_TIERS = frozenset({"host", "ssd"})

_GRAD_KINDS = frozenset({"head_loss_grad", "block_bwd", "embed_bwd",
                         "block_moe_bwd"})
_KV_PRODUCING_KINDS = frozenset({"block_prefill", "block_step",
                                 "block_verify", "block_prefill_route",
                                 "block_step_route", "block_verify_route"})
# KVWriteOp.mode required for each KV-producing compute kind
_KV_WRITE_MODES = {"block_prefill": "prefill", "block_step": "step",
                   "block_verify": "verify",
                   "block_prefill_route": "prefill",
                   "block_step_route": "step",
                   "block_verify_route": "verify"}
# Compute kinds that read the paged KV cache (consume a prior KVReadOp).
_KV_CONSUMING_KINDS = frozenset({"block_step", "block_verify",
                                 "block_step_route", "block_verify_route"})
# Compute kinds that emit an expert routing decision (set the unit's
# "routed" flag an ExpertFetchOp requires).
_ROUTE_KINDS = frozenset({"block_route", "block_prefill_route",
                          "block_step_route", "block_verify_route"})
# Compute kinds that consume staged expert stacks (require ExpertFetchOp).
_EXPERT_CONSUMING_KINDS = frozenset({"block_moe", "block_moe_bwd"})


@dataclass(frozen=True)
class FetchOp:
    """Check pool slots out, read the unit's weights from SSD, put on device."""

    unit: str


@dataclass(frozen=True)
class ComputeOp:
    """Run one jitted stage; ``save_input`` checkpoints the stage's
    activation input, which the unit's ``block_bwd`` stage restores.

    ``recompute_for`` is set only on ``block_recompute`` stages: run
    ``block_apply`` with *this* unit's weights against its own (peeked,
    not consumed) checkpoint and store the output as ``recompute_for``'s
    checkpoint — the recompute leg of the per-block activation policy."""

    unit: str
    kind: str
    save_input: bool = False
    recompute_for: str | None = None


@dataclass(frozen=True)
class GradWriteOp:
    """D2H-spill the unit's parameter grads into the fp32 flat buffer."""

    unit: str


@dataclass(frozen=True)
class ReleaseOp:
    """Drop the unit's device weights (its pool slots returned at H2D time)."""

    unit: str


@dataclass(frozen=True)
class KVReadOp:
    """Make the unit's attended KV window device-resident for its
    ``block_step``: gather the window's pages out of the paged cache
    (waiting out / issuing SSD refills for spilled pages) and H2D the
    current time-bucket extent.  Like :class:`FetchOp`, the executor
    splits this into an issue half (a gather + H2D task queued on the
    staging worker inside the lookahead window, under the previous
    block's compute) and a wait half (this op, which only blocks on the
    staged device K/V) whenever ``policy.overlap`` enables the staging
    worker."""

    unit: str


@dataclass(frozen=True)
class KVWriteOp:
    """Land the unit's freshly produced K/V in its host pages, spilling
    dirty pages onward past the residency budget.  ``mode`` is validated
    against the producing compute kind: ``"step"`` appends one token to
    the tail page (``block_step``), ``"prefill"`` scatters the whole
    padded prompt window across pages (``block_prefill``), ``"verify"``
    appends a whole K-token draft window past each slot's length without
    advancing it (``block_verify`` — the host commits or rolls the
    window back after the accept decision)."""

    unit: str
    mode: str = "step"


@dataclass(frozen=True)
class OverflowCheckOp:
    """Combine the step's Inf/NaN verdict and update the loss scaler.  The
    executor first drains the asynchronous gradient writer — this op is
    the barrier that makes every GradWriteOp's D2H visible — then decides
    whether the step's OptimStepOps apply.

    ``regions`` selects the **per-subgroup screen**: each named unit's
    flat-buffer region is screened (fused bitwise pass) as its GradWriteOp
    lands — on the writer thread under full overlap — and this op only ORs
    the per-region verdicts.  The OR over any partition of the flat buffer
    equals the whole-buffer verdict (property-tested), so the barrier no
    longer pays a whole-buffer scan.  The validator requires ``regions``
    to name every grad-written unit exactly once, in gradient write order
    (screens happen at write time, so region order IS write order).  An
    empty ``regions`` keeps the legacy whole-buffer scan at the barrier
    (the chained-baseline policy measures exactly that cost)."""

    regions: tuple[str, ...] = ()


@dataclass(frozen=True)
class ActSaveOp:
    """Offload the unit's just-saved activation checkpoint: D2H into host
    memory and — for ``tier="ssd"`` — write it onward to the store, after
    which the host copy is freed.  The executor runs the body on the
    gradient-writer thread under full overlap (the forward's save D2H
    hides under the next block's compute) and inline otherwise.  A failed
    SSD write degrades gracefully: the host copy is re-marked live and
    the checkpoint serves from the host tier."""

    unit: str
    tier: str = "host"


@dataclass(frozen=True)
class ActFetchOp:
    """Make the unit's offloaded checkpoint device-resident for its
    ``block_bwd`` (or for a successor's ``block_recompute``).  Like
    FetchOp, the executor splits this: SSD reads + H2D staging for
    upcoming act fetches are issued inside the lookahead window — block
    *i−1*'s checkpoint streams back under block *i*'s ``block_bwd`` —
    and this op only waits for the staged device array."""

    unit: str


@dataclass(frozen=True)
class ExpertFetchOp:
    """Make the unit's routed expert weights device-resident as staged
    (E, ...) stacks.  The executor resolves the actual routed set from the
    unit's ``block_route`` indices (or all experts under
    ``expert_paging="all"``), ensures those pages in the expert page cache
    (SSD refills for spilled pages), memcpys them into zero-initialized
    host stacks, and H2Ds under a ``__expert__`` device slot.  Like
    FetchOp, the issue half runs inside the lookahead window against the
    *previous* step's routing (a prediction); this op verifies the staged
    set covers the actual routed set and restages on a miss."""

    unit: str


@dataclass(frozen=True)
class ExpertReleaseOp:
    """Drop the unit's staged expert stacks (the ``__expert__`` device
    slot rotates back to the staging worker).  The cached host-side pages
    stay in the expert page cache for future steps."""

    unit: str


@dataclass(frozen=True)
class OptimStepOp:
    """Stream one unit's (master, m, v) subgroups through the host Adam
    and emit fresh compute weights.  Skipped when the overflow check
    rejected the step.  The executor may run it on the optimizer worker;
    per-unit readiness then gates the *next* step's FetchOp for the same
    unit (the weights on SSD must be post-update before they are re-read)
    and the next step's GradWriteOp (the flat-buffer region must be
    consumed before it is overwritten)."""

    unit: str


Op = (FetchOp | ComputeOp | GradWriteOp | ReleaseOp | KVReadOp | KVWriteOp
      | ActSaveOp | ActFetchOp | OverflowCheckOp | OptimStepOp
      | ExpertFetchOp | ExpertReleaseOp)


class PlanError(ValueError):
    """A StreamPlan violates the checkout→compute→release lifecycle."""


@dataclass(frozen=True)
class StreamPlan:
    """A validated linear schedule over a model's offload units."""

    name: str
    ops: tuple[Op, ...]

    def __post_init__(self):
        self.validate()

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def fetch_order(self) -> tuple[str, ...]:
        """Unit names in SSD-read order — the lookahead window walks this."""
        return tuple(op.unit for op in self.ops if isinstance(op, FetchOp))

    def validate(self) -> None:
        """Enforce the §IV-A lifecycle statically.

        * a unit's weights must be resident (fetched, not yet released)
          for every ComputeOp that names it,
        * no double fetch while resident, no release of a non-resident unit,
        * every fetch is eventually released (pool capacity is returned),
        * GradWriteOp must follow a grad-producing ComputeOp for its unit,
        * checkpoints walk a per-unit lifecycle ``saved`` (a ``save_input``
          compute) → ``offloaded`` (ActSaveOp, at most once, tier host|ssd)
          → ``ready`` (ActFetchOp, at most once) → consumed (the unit's
          ``block_bwd``).  ``block_bwd`` may consume a ``saved`` checkpoint
          directly (device/host-resident modes have no Act ops) but never
          an ``offloaded`` one — the bytes are on the SSD;
          ``block_recompute`` peeks (does not consume) its own unit's
          ``saved``/``ready`` checkpoint and produces ``recompute_for``'s,
          which must not already exist.  Every checkpoint is eventually
          consumed and every ActSaveOp eventually fetched (host checkpoint
          memory and store staging are returned),
        * ``block_step`` / ``block_verify`` consume a prior KVReadOp for
          their unit, every KVReadOp is consumed, and every KV-producing
          compute is landed by a KVWriteOp whose ``mode`` matches the
          producing kind (one-token append vs draft-window append vs
          whole-window prefill scatter — device K/V is never silently
          dropped, nor landed at the wrong page granularity),
        * expert stacks walk their own lifecycle: an ExpertFetchOp needs
          its unit resident *and* routed earlier in the plan (a
          ``block_route`` / ``*_route`` compute — the flag persists, so
          the backward's re-fetch reuses the forward's routing), and may
          not double-stage; ``block_moe`` / ``block_moe_bwd`` *require*
          staged stacks; ExpertReleaseOp drops them; a ReleaseOp (and the
          plan end) with stacks still staged is an error — the
          ``__expert__`` device slot would leak,
        * at most one OverflowCheckOp, after every GradWriteOp (it is the
          barrier that makes the flat buffer whole); when it names
          ``regions`` they must cover every grad-written unit exactly
          once, in gradient write order (the per-region screens run at
          write time — a region out of order or missing would leave a
          gradient unscreened); and every OptimStepOp follows it, names a
          unit whose grads were written, runs at most once per unit, and
          never touches a still-resident unit (the device copy would go
          stale mid-plan).
        """
        resident: set[str] = set()
        pending_grads: set[str] = set()
        # unit -> checkpoint state: "saved" | "offloaded" | "ready"
        ckpt: dict[str, str] = {}
        kv_loaded: set[str] = set()
        pending_kv: dict[str, str] = {}   # unit -> producing compute kind
        routed: set[str] = set()          # units with a route decision
        expert_staged: set[str] = set()   # units with staged expert stacks
        grads_written: set[str] = set()
        grad_write_order: list[str] = []
        optim_stepped: set[str] = set()
        overflow_seen = False
        for i, op in enumerate(self.ops):
            where = f"{self.name}[{i}]"
            if isinstance(op, FetchOp):
                if op.unit in resident:
                    raise PlanError(f"{where}: fetch of already-resident "
                                    f"unit {op.unit!r}")
                resident.add(op.unit)
            elif isinstance(op, ComputeOp):
                if op.kind not in COMPUTE_KINDS:
                    raise PlanError(f"{where}: unknown compute kind "
                                    f"{op.kind!r}")
                if op.unit not in resident:
                    raise PlanError(f"{where}: compute on non-resident unit "
                                    f"{op.unit!r}")
                if op.save_input:
                    if op.kind == "block_recompute":
                        raise PlanError(f"{where}: block_recompute must not "
                                        f"save_input (it *produces* "
                                        f"{op.recompute_for!r}'s checkpoint)")
                    if op.unit in ckpt:
                        raise PlanError(f"{where}: {op.unit!r} already has a "
                                        f"saved checkpoint")
                    ckpt[op.unit] = "saved"
                if op.recompute_for is not None and \
                        op.kind != "block_recompute":
                    raise PlanError(f"{where}: recompute_for on a "
                                    f"{op.kind!r} compute (only "
                                    f"block_recompute produces a successor "
                                    f"checkpoint)")
                if op.kind == "block_recompute":
                    if op.recompute_for is None:
                        raise PlanError(f"{where}: block_recompute for "
                                        f"{op.unit!r} with no recompute_for "
                                        f"target")
                    if op.recompute_for == op.unit:
                        raise PlanError(f"{where}: block_recompute target is "
                                        f"the source unit {op.unit!r}")
                    # peeks (does not consume) its own checkpoint: the bytes
                    # must be device-reachable — saved, or fetched back
                    if ckpt.get(op.unit) not in ("saved", "ready"):
                        raise PlanError(
                            f"{where}: block_recompute for {op.unit!r} with "
                            f"no device-reachable checkpoint (state: "
                            f"{ckpt.get(op.unit)!r} — an offloaded "
                            f"checkpoint needs its ActFetchOp first)")
                    if op.recompute_for in ckpt:
                        raise PlanError(f"{where}: block_recompute target "
                                        f"{op.recompute_for!r} already has a "
                                        f"checkpoint")
                    ckpt[op.recompute_for] = "saved"
                if op.kind in ("block_bwd", "block_moe_bwd"):
                    state = ckpt.get(op.unit)
                    if state is None:
                        raise PlanError(f"{where}: {op.kind} for {op.unit!r} "
                                        f"with no saved checkpoint")
                    if state == "offloaded":
                        raise PlanError(f"{where}: {op.kind} for {op.unit!r} "
                                        f"before its ActFetchOp (the "
                                        f"checkpoint bytes are offloaded)")
                    del ckpt[op.unit]
                if op.kind in _GRAD_KINDS:
                    pending_grads.add(op.unit)
                if op.kind in _KV_CONSUMING_KINDS:
                    if op.unit not in kv_loaded:
                        raise PlanError(f"{where}: {op.kind} for {op.unit!r}"
                                        f" with no KV read")
                    kv_loaded.discard(op.unit)
                if op.kind in _ROUTE_KINDS:
                    routed.add(op.unit)
                if op.kind in _EXPERT_CONSUMING_KINDS and \
                        op.unit not in expert_staged:
                    raise PlanError(f"{where}: {op.kind} for {op.unit!r} "
                                    f"with no staged expert stacks (needs "
                                    f"an ExpertFetchOp)")
                if op.kind in _KV_PRODUCING_KINDS:
                    if op.unit in pending_kv:
                        raise PlanError(f"{where}: {op.unit!r} already has "
                                        f"unwritten K/V")
                    pending_kv[op.unit] = op.kind
            elif isinstance(op, ActSaveOp):
                if op.tier not in _ACT_SAVE_TIERS:
                    raise PlanError(f"{where}: unknown activation save tier "
                                    f"{op.tier!r} (expected one of "
                                    f"{sorted(_ACT_SAVE_TIERS)})")
                state = ckpt.get(op.unit)
                if state is None:
                    raise PlanError(f"{where}: activation save for "
                                    f"{op.unit!r} with no saved checkpoint")
                if state != "saved":
                    raise PlanError(f"{where}: duplicate activation save "
                                    f"for {op.unit!r} (state: {state!r})")
                ckpt[op.unit] = "offloaded"
            elif isinstance(op, ActFetchOp):
                state = ckpt.get(op.unit)
                if state is None:
                    raise PlanError(f"{where}: activation fetch for "
                                    f"{op.unit!r} with no checkpoint")
                if state != "offloaded":
                    raise PlanError(f"{where}: activation fetch for "
                                    f"{op.unit!r} without an ActSaveOp "
                                    f"(state: {state!r})")
                ckpt[op.unit] = "ready"
            elif isinstance(op, KVReadOp):
                if op.unit in kv_loaded:
                    raise PlanError(f"{where}: double KV read for "
                                    f"{op.unit!r}")
                kv_loaded.add(op.unit)
            elif isinstance(op, KVWriteOp):
                kind = pending_kv.pop(op.unit, None)
                if kind is None:
                    raise PlanError(f"{where}: KV write for {op.unit!r} "
                                    f"with no K/V produced")
                if op.mode not in ("step", "prefill", "verify"):
                    raise PlanError(f"{where}: unknown KV write mode "
                                    f"{op.mode!r}")
                expected = _KV_WRITE_MODES[kind]
                if op.mode != expected:
                    raise PlanError(
                        f"{where}: KV write mode {op.mode!r} for "
                        f"{op.unit!r} does not match its producing kind "
                        f"{kind!r} (expected {expected!r}: a step appends "
                        f"one token, a verify appends the draft window, "
                        f"a prefill scatters the whole prompt window)")
            elif isinstance(op, ExpertFetchOp):
                if op.unit not in resident:
                    raise PlanError(f"{where}: expert fetch for non-resident"
                                    f" unit {op.unit!r}")
                if op.unit not in routed:
                    raise PlanError(f"{where}: expert fetch for {op.unit!r} "
                                    f"with no routing decision (needs a "
                                    f"block_route/*_route compute first)")
                if op.unit in expert_staged:
                    raise PlanError(f"{where}: double expert fetch for "
                                    f"{op.unit!r}")
                expert_staged.add(op.unit)
            elif isinstance(op, ExpertReleaseOp):
                if op.unit not in expert_staged:
                    raise PlanError(f"{where}: expert release for "
                                    f"{op.unit!r} with no staged stacks")
                expert_staged.discard(op.unit)
            elif isinstance(op, GradWriteOp):
                if op.unit not in pending_grads:
                    raise PlanError(f"{where}: grad write for {op.unit!r} "
                                    f"with no grads produced")
                if overflow_seen:
                    raise PlanError(f"{where}: grad write for {op.unit!r} "
                                    f"after the overflow check (the check "
                                    f"must see every gradient)")
                pending_grads.discard(op.unit)
                grads_written.add(op.unit)
                grad_write_order.append(op.unit)
            elif isinstance(op, OverflowCheckOp):
                if overflow_seen:
                    raise PlanError(f"{where}: duplicate overflow check")
                if not grads_written:
                    raise PlanError(f"{where}: overflow check with no "
                                    f"grads written")
                if pending_grads:
                    raise PlanError(f"{where}: overflow check with "
                                    f"unwritten grads: "
                                    f"{sorted(pending_grads)}")
                if op.regions and list(op.regions) != grad_write_order:
                    raise PlanError(
                        f"{where}: per-region screen order "
                        f"{list(op.regions)} != gradient write order "
                        f"{grad_write_order} (every written region must "
                        f"be screened exactly once, as its write lands)")
                overflow_seen = True
            elif isinstance(op, OptimStepOp):
                if not overflow_seen:
                    raise PlanError(f"{where}: optimizer step for "
                                    f"{op.unit!r} before the overflow "
                                    f"check")
                if op.unit not in grads_written:
                    raise PlanError(f"{where}: optimizer step for "
                                    f"{op.unit!r} with no written grads")
                if op.unit in optim_stepped:
                    raise PlanError(f"{where}: duplicate optimizer step "
                                    f"for {op.unit!r}")
                if op.unit in resident:
                    raise PlanError(f"{where}: optimizer step while "
                                    f"{op.unit!r} is resident (its device "
                                    f"weights would go stale)")
                optim_stepped.add(op.unit)
            elif isinstance(op, ReleaseOp):
                if op.unit not in resident:
                    raise PlanError(f"{where}: release of non-resident unit "
                                    f"{op.unit!r}")
                if op.unit in expert_staged:
                    raise PlanError(f"{where}: release of {op.unit!r} with "
                                    f"expert stacks still staged (its "
                                    f"ExpertReleaseOp must come first)")
                resident.discard(op.unit)
            else:
                raise PlanError(f"{where}: unknown op {op!r}")
        if resident:
            raise PlanError(f"{self.name}: units never released: "
                            f"{sorted(resident)}")
        if pending_grads:
            raise PlanError(f"{self.name}: grads never written: "
                            f"{sorted(pending_grads)}")
        unfetched = sorted(u for u, s in ckpt.items() if s == "offloaded")
        if unfetched:
            raise PlanError(f"{self.name}: activation saves never fetched: "
                            f"{unfetched}")
        if ckpt:
            raise PlanError(f"{self.name}: checkpoints never restored: "
                            f"{sorted(ckpt)}")
        if kv_loaded:
            raise PlanError(f"{self.name}: KV reads never consumed: "
                            f"{sorted(kv_loaded)}")
        if pending_kv:
            raise PlanError(f"{self.name}: K/V never written: "
                            f"{sorted(pending_kv)}")
        if expert_staged:
            raise PlanError(f"{self.name}: expert stacks never released: "
                            f"{sorted(expert_staged)}")


# ---------------------------------------------------------------------------
# Compilers: OffloadableModel -> StreamPlan
# ---------------------------------------------------------------------------

def _unit_names(model) -> tuple[str, list[str], str]:
    """(embed, [blocks...], head) unit names, seed layout order."""
    names = [u.name for u in model.units]
    if len(names) < 2:
        raise PlanError("model needs at least an embedding and a head unit")
    return names[0], names[1:-1], names[-1]


def resolve_act_policy(blocks: list[str], spec) -> tuple[str, ...]:
    """Resolve an ``act_policy`` spec into one tier per block.

    ``spec`` may be:

    * ``None`` — every block checkpoints to pinned host memory (``host``,
      the pre-activation-streaming behaviour),
    * a single tier name — uniform, except ``"recompute"``, which becomes
      the classic checkpoint-every-other ladder (even-index blocks save to
      SSD, odd-index blocks recompute from them): a chain where *no* block
      kept a checkpoint would have nothing to recompute from,
    * a ``dict`` block-name → tier (missing blocks default to ``host``),
    * a sequence of tiers, positional, one per block.

    Chain rules (violations raise :class:`PlanError`):

    * block 0 cannot be ``recompute`` — the embedding output is not
      checkpointed, so there is no predecessor checkpoint to re-run from,
    * two consecutive ``recompute`` blocks are rejected — block *i*'s
      recompute runs from block *i−1*'s checkpoint, which must exist.
    """
    n = len(blocks)
    if spec is None:
        spec = "host"
    if isinstance(spec, str):
        if spec not in ACT_TIERS:
            raise PlanError(f"unknown act_policy tier {spec!r} (expected "
                            f"one of {sorted(ACT_TIERS)})")
        if spec == "recompute":
            tiers = tuple("ssd" if i % 2 == 0 else "recompute"
                          for i in range(n))
        else:
            tiers = (spec,) * n
    elif isinstance(spec, dict):
        unknown = sorted(set(spec) - set(blocks))
        if unknown:
            raise PlanError(f"act_policy names unknown blocks: {unknown}")
        tiers = tuple(spec.get(b, "host") for b in blocks)
    else:
        tiers = tuple(spec)
        if len(tiers) != n:
            raise PlanError(f"act_policy has {len(tiers)} entries for "
                            f"{n} blocks")
    for i, t in enumerate(tiers):
        if t not in ACT_TIERS:
            raise PlanError(f"unknown act_policy tier {t!r} for block "
                            f"{blocks[i]!r} (expected one of "
                            f"{sorted(ACT_TIERS)})")
        if t == "recompute":
            if i == 0:
                raise PlanError(f"block 0 ({blocks[0]!r}) cannot be "
                                f"'recompute': the embedding output is not "
                                f"checkpointed, so there is no predecessor "
                                f"checkpoint to re-run from")
            if tiers[i - 1] == "recompute":
                raise PlanError(
                    f"consecutive 'recompute' blocks {blocks[i - 1]!r}, "
                    f"{blocks[i]!r}: block {blocks[i]!r}'s recompute runs "
                    f"from {blocks[i - 1]!r}'s checkpoint, which "
                    f"'recompute' drops")
    return tiers


def _moe_units(model) -> frozenset:
    """Units whose expert weights live in the expert page cache (their
    ``block`` compute splits into ``block_route`` + ``block_moe``)."""
    return frozenset(getattr(model, "expert_meta", None) or ())


def _forward_ops(model, *, checkpoint: bool) -> list[Op]:
    embed, blocks, _head = _unit_names(model)
    moe = _moe_units(model)
    ops: list[Op] = [FetchOp(embed), ComputeOp(embed, "embed"),
                     ReleaseOp(embed)]
    for b in blocks:
        if b in moe:
            ops += [FetchOp(b),
                    ComputeOp(b, "block_route", save_input=checkpoint),
                    ExpertFetchOp(b), ComputeOp(b, "block_moe"),
                    ExpertReleaseOp(b), ReleaseOp(b)]
        else:
            ops += [FetchOp(b),
                    ComputeOp(b, "block", save_input=checkpoint),
                    ReleaseOp(b)]
    return ops


def compile_train(model, act_policy=None) -> StreamPlan:
    """Forward (checkpointing block inputs) + loss/cotangent + reverse
    backward + embedding backward + overflow screen + per-unit optimizer —
    the whole training step as data.

    ``act_policy`` (see :func:`resolve_act_policy`) picks each block's
    checkpoint tier.  ``host``/``ssd`` blocks get an ActSaveOp after their
    forward compute and an ActFetchOp before their ``block_bwd``
    (ssd-tier saves free the host copy once the store write lands — the
    forward's resident-checkpoint footprint stops growing with depth);
    ``recompute`` blocks save nothing and instead re-run the *previous*
    block forward from its (fetched-back, peeked-not-consumed) checkpoint
    just before their own ``block_bwd``; ``device`` blocks keep the
    device array (``offload_checkpoints=False``).

    The OptimStepOps come last, ordered by the *next* step's fetch order
    (embed, blocks, head): under full overlap each unit's Adam write-back
    unblocks that unit's step-*k+1* prefetch, so the earliest-needed
    weights are refreshed first and the cross-step pipeline never stalls
    longer than one subgroup.
    """
    embed, blocks, head = _unit_names(model)
    tiers = resolve_act_policy(blocks, act_policy)
    moe = _moe_units(model)
    if moe and "recompute" in tiers:
        raise PlanError(
            "act_policy 'recompute' is not supported for expert-paged MoE "
            "blocks: block_recompute re-runs block_apply, which needs the "
            "stacked expert weights the page cache replaced")
    ops: list[Op] = [FetchOp(embed), ComputeOp(embed, "embed"),
                     ReleaseOp(embed)]
    for b, tier in zip(blocks, tiers):
        if b in moe:
            ops += [FetchOp(b),
                    ComputeOp(b, "block_route", save_input=True),
                    ExpertFetchOp(b), ComputeOp(b, "block_moe")]
            if tier in _ACT_SAVE_TIERS:
                ops.append(ActSaveOp(b, tier))
            ops += [ExpertReleaseOp(b), ReleaseOp(b)]
            continue
        ops += [FetchOp(b),
                ComputeOp(b, "block", save_input=(tier != "recompute"))]
        if tier in _ACT_SAVE_TIERS:
            ops.append(ActSaveOp(b, tier))
        ops.append(ReleaseOp(b))
    ops += [FetchOp(head), ComputeOp(head, "head_loss_grad"),
            ReleaseOp(head), GradWriteOp(head)]
    # a block fetched back early to seed a successor's recompute keeps its
    # checkpoint device-resident ("ready") for its own block_bwd later —
    # no second ActFetchOp
    fetched_early: set[str] = set()
    for i in reversed(range(len(blocks))):
        b = blocks[i]
        if tiers[i] == "recompute":
            p = blocks[i - 1]
            ops.append(FetchOp(p))
            if tiers[i - 1] in _ACT_SAVE_TIERS and p not in fetched_early:
                ops.append(ActFetchOp(p))
                fetched_early.add(p)
            ops += [ComputeOp(p, "block_recompute", recompute_for=b),
                    ReleaseOp(p)]
        ops.append(FetchOp(b))
        if tiers[i] in _ACT_SAVE_TIERS and b not in fetched_early:
            ops.append(ActFetchOp(b))
        if b in moe:
            # the backward re-fetches the forward's routed experts (the
            # executor remembered the idx) and recomputes under vjp
            ops += [ExpertFetchOp(b), ComputeOp(b, "block_moe_bwd"),
                    ExpertReleaseOp(b), ReleaseOp(b), GradWriteOp(b)]
        else:
            ops += [ComputeOp(b, "block_bwd"),
                    ReleaseOp(b), GradWriteOp(b)]
    ops += [FetchOp(embed), ComputeOp(embed, "embed_bwd"),
            ReleaseOp(embed), GradWriteOp(embed)]
    # per-subgroup screen: each unit's flat region is checked as its write
    # lands; the barrier only ORs the verdicts (regions in write order)
    ops.append(OverflowCheckOp(
        regions=(head, *reversed(blocks), embed)))
    for unit in [embed, *blocks, head]:
        ops.append(OptimStepOp(unit))
    return StreamPlan("train", tuple(ops))


def compile_eval(model) -> StreamPlan:
    """Forward + head loss; no checkpointing, no grads."""
    _embed, _blocks, head = _unit_names(model)
    ops = _forward_ops(model, checkpoint=False)
    ops += [FetchOp(head), ComputeOp(head, "head_loss"), ReleaseOp(head)]
    return StreamPlan("eval", tuple(ops))


def compile_decode(model) -> StreamPlan:
    """Forward + head logits: one weight-streamed decode step (serving)."""
    if getattr(model, "head_logits", None) is None:
        raise PlanError("model has no head_logits apply; decode plans need "
                        "one (see model_adapter.make_offloadable_lm)")
    _embed, _blocks, head = _unit_names(model)
    ops = _forward_ops(model, checkpoint=False)
    ops += [FetchOp(head), ComputeOp(head, "head_logits"), ReleaseOp(head)]
    return StreamPlan("decode", tuple(ops))


def _require_cached_applies(model) -> None:
    attrs = ["head_logits", "block_prefill", "block_step"]
    if _moe_units(model):
        attrs += ["block_prefill_route", "block_step_route", "block_moe"]
    for attr in attrs:
        if getattr(model, attr, None) is None:
            raise PlanError(
                f"model has no {attr} apply; cached decode plans need one "
                f"(see model_adapter.make_offloadable_lm — attention-mixer "
                f"families only)")


def compile_prefill(model) -> StreamPlan:
    """Prompt pass of cached decode: every block streams once, computes
    full-sequence attention, and lands its K/V in the spill-able cache;
    the head emits logits at the last prompt position only."""
    _require_cached_applies(model)
    embed, blocks, head = _unit_names(model)
    ops: list[Op] = [FetchOp(embed), ComputeOp(embed, "embed"),
                     ReleaseOp(embed)]
    moe = _moe_units(model)
    for b in blocks:
        if b in moe:
            # K/V lands right after the route half; the expert fetch's
            # SSD reads overlap the KV write
            ops += [FetchOp(b), ComputeOp(b, "block_prefill_route"),
                    KVWriteOp(b, "prefill"), ExpertFetchOp(b),
                    ComputeOp(b, "block_moe"), ExpertReleaseOp(b),
                    ReleaseOp(b)]
        else:
            ops += [FetchOp(b), ComputeOp(b, "block_prefill"),
                    KVWriteOp(b, "prefill"), ReleaseOp(b)]
    ops += [FetchOp(head), ComputeOp(head, "head_logits_last"),
            ReleaseOp(head)]
    return StreamPlan("prefill", tuple(ops))


def compile_decode_cached(model) -> StreamPlan:
    """One O(1)-context decode step: per block, checkout → fetch weights →
    KV read (refill from SSD if spilled) → attend-with-cache → KV append →
    release/spill.  The (batch, 1) shapes are fixed, so every stage
    compiles once per time bucket."""
    _require_cached_applies(model)
    embed, blocks, head = _unit_names(model)
    ops: list[Op] = [FetchOp(embed), ComputeOp(embed, "embed"),
                     ReleaseOp(embed)]
    moe = _moe_units(model)
    for b in blocks:
        if b in moe:
            ops += [FetchOp(b), KVReadOp(b),
                    ComputeOp(b, "block_step_route"), KVWriteOp(b, "step"),
                    ExpertFetchOp(b), ComputeOp(b, "block_moe"),
                    ExpertReleaseOp(b), ReleaseOp(b)]
        else:
            ops += [FetchOp(b), KVReadOp(b), ComputeOp(b, "block_step"),
                    KVWriteOp(b, "step"), ReleaseOp(b)]
    ops += [FetchOp(head), ComputeOp(head, "head_logits"), ReleaseOp(head)]
    return StreamPlan("decode_cached", tuple(ops))


def compile_decode_verify(model) -> StreamPlan:
    """One speculative-decode verify step: same stream structure as
    :func:`compile_decode_cached`, but each block runs ``block_verify``
    over a (batch, K) window of draft tokens and its KVWriteOp appends
    all K tokens' K/V past the slot lengths *without advancing them* —
    the host inspects the verify logits afterwards, then commits the
    accepted prefix (advance + drop the rejected tail's pages) via
    ``SpillableKVCache.rollback``.  K is time-bucketed by the session, so
    the per-(K, extent) trace set stays bounded."""
    _require_cached_applies(model)
    if getattr(model, "block_verify", None) is None:
        raise PlanError(
            "model has no block_verify apply; spec-decode verify plans "
            "need one (see model_adapter.make_offloadable_lm — "
            "attention-mixer families only)")
    moe = _moe_units(model)
    if moe and getattr(model, "block_verify_route", None) is None:
        raise PlanError(
            "model has no block_verify_route apply; expert-paged spec-"
            "decode verify plans need one "
            "(see model_adapter.make_offloadable_lm)")
    embed, blocks, head = _unit_names(model)
    ops: list[Op] = [FetchOp(embed), ComputeOp(embed, "embed"),
                     ReleaseOp(embed)]
    for b in blocks:
        if b in moe:
            ops += [FetchOp(b), KVReadOp(b),
                    ComputeOp(b, "block_verify_route"),
                    KVWriteOp(b, "verify"), ExpertFetchOp(b),
                    ComputeOp(b, "block_moe"), ExpertReleaseOp(b),
                    ReleaseOp(b)]
        else:
            ops += [FetchOp(b), KVReadOp(b), ComputeOp(b, "block_verify"),
                    KVWriteOp(b, "verify"), ReleaseOp(b)]
    ops += [FetchOp(head), ComputeOp(head, "head_logits"), ReleaseOp(head)]
    return StreamPlan("decode_verify", tuple(ops))


PLAN_COMPILERS = {
    "train": compile_train,
    "eval": compile_eval,
    "decode": compile_decode,
    "prefill": compile_prefill,
    "decode_cached": compile_decode_cached,
    "decode_verify": compile_decode_verify,
}
