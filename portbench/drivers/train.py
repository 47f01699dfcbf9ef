"""Training: ``OffloadSession.train_step`` through the port's whole
offloaded trainer (the plan executor and streams, the pinned pool and
allocator, the fused overflow screen, the host Adam) over the host-arena
store.

Set-up draws the model from the seed, opens one session and drives it
through the mix's first ``setup_steps`` steps by the window's own call:
after step 1 the pipeline is drained and each leaf's first gradient is
read back from the optimizer's first moment; after the last set-up step
each leaf's change is read from the masters.  The window then runs more
steps of the same session, with no synchronisation between them, and
closes when ``synchronize()`` returns after the first step to end past
``--seconds``.  Afterwards the plain reference replays the set-up steps
in float32 from the same weights and batches.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

import compare
import count
import port
import tracing
import weights
from reference import qwen3
from stores.host_arena import ALIGN, HostArenaStore

from repro_torch.kernels.overflow_check import overflow_flag_cuda_

def arena_bytes(leaves, state_bytes: int, compute_bytes: int) -> int:
    """Master, m and v in the state dtype and the compute copy, each
    placed on its own aligned extent."""
    def extent(n: int) -> int:
        return -(-n // ALIGN) * ALIGN
    return sum(3 * extent(state_bytes * leaf.size)
               + extent(compute_bytes * leaf.size) for leaf in leaves)


def _state_norms(store, leaves, suffix: str, device, *, minus=None,
                 scale: float = 1.0) -> dict:
    """Each leaf's norm of a stored fp32 state (less ``minus``'s array of
    the leaf), on the device."""
    out = {}
    for leaf in leaves:
        t = torch.from_numpy(store.view(leaf.name + suffix, np.float32,
                                        leaf.shape)).to(device)
        if minus is not None:
            t = t - torch.from_numpy(minus[leaf.unit][leaf.key]).to(device)
        out[leaf.name] = compare.norm(t) * scale
    return out


def reference(cfg: dict, mix: dict, seed: int, device, leaves,
              drawn: float, batches: list, *, fp8: bool = False,
              rows: int | None = None) -> dict:
    """The plain float32 replay of the set-up steps on ``device``, the
    readings the port's are compared with.  ``fp8`` computes it one
    precision below the port's bf16 (the control); ``rows`` keeps only
    that many rows of each batch (a fault of the control's kind)."""
    flat = weights.draw(leaves, seed, device)
    if weights.checksum(flat) != drawn:
        raise RuntimeError("the redraw from the seed gave other weights")
    tree = weights.reference_tree(leaves, flat)
    dev = [tuple(torch.from_numpy(a[:rows]).to(device) for a in b)
           for b in batches]
    with qwen3.exact_fp32():
        out = qwen3.train(qwen3.Model(cfg, fp8=fp8), tree, dev,
                          lr=mix["lr"], weight_decay=mix["weight_decay"])
    return {"losses": out["losses"],
            "grad_norms": {leaf.name: compare.norm(
                weights.leaf_of(out["grads"], leaf)) for leaf in leaves},
            "change_norms": {leaf.name: compare.norm(
                weights.leaf_of(out["params"], leaf)
                - weights.leaf_of(tree, leaf)) for leaf in leaves}}


def setup_steps(ctx, session, store, leaves, units, batch) -> dict:
    """The first steps through ``train_step``, and the port's readings
    of them."""
    beta1 = session.policy.adam.beta1
    losses = []
    grad_norms = None
    for i in range(1, ctx.mix["setup_steps"] + 1):
        with ctx.spans("train_step"):
            m = session.train_step(*batch(i))
        if not m["applied"]:
            raise RuntimeError(f"set-up step {i} was skipped (overflow)")
        losses.append(m["loss"])
        if i == 1:
            session.synchronize()
            grad_norms = _state_norms(store, leaves, ".m", ctx.device,
                                      scale=1.0 / (1.0 - beta1))
        ctx.log(f"set-up step {i}: loss {m['loss']!r}")
    session.synchronize()
    change = _state_norms(store, leaves, ".master", ctx.device, minus=units)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def run(ctx) -> dict:
    cfg, mix = ctx.cfg, ctx.mix
    leaves = weights.layout(cfg, mix["expert_paging"])
    holder = {}
    policy = port.policy(mix, lambda: holder["store"])
    store = HostArenaStore(arena_bytes(
        leaves, policy.adam.state_np_dtype.itemsize,
        policy.adam.compute_np_dtype.itemsize))
    holder["store"] = store
    ctx.log(f"host arena {store.nbytes} B; {weights.n_params(leaves)} "
            f"parameters in {len(leaves)} leaves")
    flat = weights.draw(leaves, ctx.seed, ctx.device)
    drawn = weights.checksum(flat)
    units = weights.host_units(leaves, flat)
    del flat
    model = port.offloadable(cfg, units, ctx.device)
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
        device = port.device_info(ctx.device)
        launches = overflow_flag_cuda_.launches - launches0
        breakdown = tracker.breakdown()
        io = store.stats.snapshot()
    n, window_s = len(steps), t1 - t0
    sums = {k: sum(m[k] for m in steps)
            for k in ("fetch_wait_s", "optim_gate_s", "expert_fetch_wait_s")}
    ctx.log(f"window: {n} steps, ending at {ends} s, in {window_s!r} s "
            f"(synchronize "
            f"{t1 - t_sync!r} s), losses {[m['loss'] for m in steps]}, "
            f"waits {sums}, overflow launches {launches}, store {io}")
    record = {
        "steps": n, "window_s": window_s, "tokens": n * b * s,
        "sums": sums, "sync_tail_s": t1 - t_sync,
        "expert_paging": mix["expert_paging"] != "off",
        "tracker": breakdown,
        "step_flops": count.train_step_flops(cfg, b, s),
        "screen_bytes_per_step": count.overflow_screen_bytes(
            [leaf.size for leaf in leaves]),
        "screen_launches": launches, "leaves": len(leaves),
        "trace": tracing.reduce(prof) if prof is not None else None}
    end_to_end = {"train_tokens_per_s": n * b * s / window_s,
                  "peak_host_gib": (peak - store.nbytes) / port.GIB,
                  "setup_s": t0 - ctx.t_start}
    ctx.log(f"end to end {end_to_end}")

    del model, units, session
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cfg, mix, ctx.seed, ctx.device, leaves, drawn,
                    [batch(j) for j in range(1, mix["setup_steps"] + 1)])
    numbers = compare.train_numbers(
        prog, ref, [leaf.name for leaf in leaves if leaf.is_expert])
    ctx.log(f"losses port {prog['losses']} reference {ref['losses']}; "
            f"worst leaves {compare.worst_leaves(prog, ref)}")
    return {"end_to_end": end_to_end, "record": record, "numbers": numbers,
            "attempted": n, "failed": sum(not m["applied"] for m in steps),
            "device": device}
