"""Training a Kimi Linear model (KDA layers beside MLA ones with no rope,
the sigmoid gate with its selection bias over 256 experts of which this
chip holds a share, a shared expert, a leading dense layer) through the
port's whole offloaded trainer: ``OffloadSession.train_step``, the plan
executor and streams, routed expert paging, the pinned pool and
allocator, the fused overflow screen and the host Adam, over the
host-arena store.

Set-up and window as ``drivers/train.py`` runs them (its
:func:`~drivers.train.setup_steps` drives the first steps and reads the
port's first gradients and changes).  Over the window the driver records
the differences of the session's counters (``overlap_snapshot()``: the
route stages' readback seconds, the routed, dropped and unheld (token,
choice) pairs, and KDA's chunked forwards, tokens and device seconds) and
of the expert page cache's ``PageStats``.  The step's FLOPs count the
routed experts' pairs that were computed, those within capacity.

The port's ``ModelConfig`` is built first: a port without KDA or a held
share of the experts refuses it before anything is drawn.  Afterwards
the plain reference (``reference/kimi_linear.py``) replays the set-up
steps in float32 from the same weights and batches, its tensors on the
device and Adam's moments on the host, whose memory the closed session
has given back.  Beside the numbers every training cell compares,
``kda_grad_gap`` is the widest first-gradient gap over the KDA leaves.
"""

from __future__ import annotations

import gc
import time

import torch

import compare
import count
import layout_kimi_linear as layout
import port
import tracing
import weights
from drivers.train import arena_bytes, setup_steps
from drivers.train_deepseek_v3 import PAGES, _diff, offloadable
from reference import kimi_linear
from stores.host_arena import HostArenaStore

from repro_torch.kernels.overflow_check import overflow_flag_cuda_

# overlap_snapshot()'s counters the window records
COUNTERS = ("expert_route_readback_seconds", "expert_routed_pairs",
            "expert_dropped_pairs", "expert_unheld_pairs", "kda_calls",
            "kda_tokens", "kda_device_seconds")


def reference(cfg: dict, mix: dict, seed: int, device, leaves,
              drawn: float, batches: list, *, fp8: bool = False,
              rows: int | None = None, log=None) -> dict:
    """The plain float32 replay of the set-up steps on ``device``: each
    leaf's first gradient norm and its change's norm over the steps.
    ``fp8`` computes it one precision below the port's bf16 (the
    control); ``rows`` keeps that many rows of each batch (a fault);
    ``log`` is told when each phase ends."""
    log = log or (lambda msg: None)
    flat = layout.draw(leaves, seed, device)
    if weights.checksum(flat) != drawn:
        raise RuntimeError("the redraw from the seed gave other weights")
    tree = {n: t if t._base is None else t.clone()
            for n, t in weights.reference_tree(leaves, flat).items()}
    del flat
    dev = [tuple(torch.from_numpy(a[:rows]).to(device) for a in b)
           for b in batches]
    grad_norms: dict = {}

    def first(grads):
        log("reference: first gradients")
        grad_norms.update({leaf.name: compare.norm(
            weights.leaf_of(grads, leaf)) for leaf in leaves})

    with kimi_linear.exact_fp32():
        losses = kimi_linear.train(
            kimi_linear.Model(cfg, fp8=fp8), tree, dev, lr=mix["lr"],
            weight_decay=mix["weight_decay"], on_first_grads=first,
            state_device="cpu" if device.type == "cuda" else None)
    log(f"reference: {len(losses)} steps")
    flat = layout.draw(leaves, seed, device)
    change = {}
    for leaf, off in weights.offsets(leaves):
        start = flat[off:off + leaf.size].view(leaf.shape)
        change[leaf.name] = compare.norm(weights.leaf_of(tree, leaf) - start)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def numbers(prog: dict, ref: dict, leaves) -> dict:
    """The training cell's numbers, and ``kda_grad_gap``."""
    out = compare.train_numbers(
        prog, ref, [leaf.name for leaf in leaves if leaf.is_expert])
    gaps = compare.leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    out["kda_grad_gap"] = max(g for n, g in gaps.items()
                              if n.split("/", 1)[1].startswith("kda."))
    return out


def run(ctx) -> dict:
    cfg, mix = ctx.cfg, ctx.mix
    pcfg = layout.model_config(cfg)
    leaves = layout.layout(cfg, mix["expert_paging"])
    holder = {}
    policy = port.policy(mix, lambda: holder["store"])
    store = HostArenaStore(arena_bytes(
        leaves, policy.adam.state_np_dtype.itemsize,
        policy.adam.compute_np_dtype.itemsize))
    holder["store"] = store
    ctx.log(f"host arena {store.nbytes} B; {weights.n_params(leaves)} "
            f"parameters in {len(leaves)} leaves")
    flat = layout.draw(leaves, ctx.seed, ctx.device)
    drawn = weights.checksum(flat)
    units = weights.host_units(leaves, flat)
    del flat
    model = offloadable(pcfg, units, ctx.device)
    ctx.log("weights drawn and copied to the host")
    b, s, vocab = mix["batch"], mix["seq"], cfg["vocab_size"]

    def batch(i: int):
        return weights.train_batch(ctx.seed, i, b, s, vocab)

    tracker = port.MemoryTracker()
    prof = tracing.profiler() if ctx.trace else None
    with port.OffloadSession(model, policy, tracker=tracker) as session:
        ctx.log("session open, store filled")
        prog = setup_steps(ctx, session, store, leaves, units, batch)
        launches0 = overflow_flag_cuda_.launches
        counters0 = session.overlap_snapshot()
        pages0 = session.expert_cache_stats()
        if prof is not None:
            prof.start()
        steps, ends, i = [], [], mix["setup_steps"]
        t0 = time.perf_counter()
        with ctx.spans("window"):
            while True:
                i += 1
                with ctx.spans("train_step"):
                    steps.append(dict(session.train_step(*batch(i))))
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= ctx.seconds:
                    break
            t_sync = time.perf_counter()
            with ctx.spans("synchronize"):
                session.synchronize()
            t1 = time.perf_counter()
        peak = ctx.rss.stop()
        if prof is not None:
            prof.stop()
        counters = _diff(session.overlap_snapshot(), counters0, COUNTERS)
        pages = _diff(session.expert_cache_stats(), pages0, PAGES)
        device = port.device_info(ctx.device)
        launches = overflow_flag_cuda_.launches - launches0
        breakdown = tracker.breakdown()
        io = store.stats.snapshot()
    n, window_s = len(steps), t1 - t0
    kept = counters.get("expert_routed_pairs", 0) - \
        counters.get("expert_dropped_pairs", 0)
    sums = {k: sum(m[k] for m in steps)
            for k in ("fetch_wait_s", "optim_gate_s", "expert_fetch_wait_s")}
    ctx.log(f"window: {n} steps, ending at {ends} s, in {window_s!r} s "
            f"(synchronize {t1 - t_sync!r} s), losses "
            f"{[m['loss'] for m in steps]}, waits {sums}, counters "
            f"{counters}, pages {pages}, overflow launches {launches}, "
            f"store {io}, device {device}")
    record = {
        "steps": n, "window_s": window_s, "tokens": n * b * s,
        "sums": sums, "sync_tail_s": t1 - t_sync,
        "expert_paging": mix["expert_paging"] != "off",
        "counters": counters, "pages": pages,
        "tracker": breakdown,
        "step_flops": layout.train_step_flops(cfg, b, s, kept / n),
        "screen_bytes_per_step": count.overflow_screen_bytes(
            [leaf.size for leaf in leaves]),
        "screen_launches": launches, "leaves": len(leaves),
        "trace": tracing.reduce(prof) if prof is not None else None}
    end_to_end = {"train_tokens_per_s": n * b * s / window_s,
                  "peak_host_gib": (peak - store.nbytes) / port.GIB,
                  "setup_s": t0 - ctx.t_start}
    ctx.log(f"end to end {end_to_end}")

    del model, units, session, store
    holder.clear()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cfg, mix, ctx.seed, ctx.device, leaves, drawn,
                    [batch(j) for j in range(1, mix["setup_steps"] + 1)],
                    log=ctx.log)
    nums = numbers(prog, ref, leaves)
    ctx.log(f"losses port {prog['losses']} reference {ref['losses']}; "
            f"worst leaves {compare.worst_leaves(prog, ref)}")
    return {"end_to_end": end_to_end, "record": record, "numbers": nums,
            "attempted": n, "failed": sum(not m["applied"] for m in steps),
            "device": device}
