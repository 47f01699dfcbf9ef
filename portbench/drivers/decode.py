"""Offloaded cached decode: closed batches of greedy requests through
``OffloadedDecoder.generate`` on a serve-mode ``OffloadSession`` (its
``open_kv_cache`` -> ``prefill`` -> ``decode_step`` loop), the weights
streamed from the port's direct-NVMe store.

Set-up draws the model from the seed (bf16, the type it is served in),
opens the session, which writes the store, and serves one batch to warm
every shape.  The window serves batches back to back, one client, and
closes when the first batch to end past ``--seconds`` ends.  Afterwards
the plain reference runs once over each served request's prompt and
tokens, and each served token's logit is compared with the reference's
best at its position.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

import compare
import port
import tracing
import weights
from reference import qwen3

from repro_torch.core import DecodeSpec, DirectNVMeEngine
from repro_torch.serve.offloaded import OffloadedDecoder

SPANNED = ("open_kv_cache", "prefill", "decode_step")
# requests the reference reads at once: (batch, prompt + new, vocab) fp32
REF_ROWS = 4


def _spanned(ctx, session) -> None:
    """Record a span around each of the session's decode entry points."""
    for name in SPANNED:
        fn = getattr(session, name)

        def call(*a, _fn=fn, _name=name, **kw):
            with ctx.spans(_name):
                return _fn(*a, **kw)
        setattr(session, name, call)


def store_capacity(cfg: dict, n_params: int, mix: dict) -> int:
    """Bytes a striped device region needs: the bf16 weights and every
    KV page, split over the devices, with room to spare."""
    kv = 2 * 2 * mix["batch"] * mix["max_seq"] * cfg["num_key_value_heads"] \
        * cfg["head_dim"] * cfg["num_hidden_layers"]
    return -(-(2 * n_params + kv) // mix["store_devices"]) + (256 << 20)


def reference_tree(seed: int, device, leaves, drawn: float) -> dict:
    """The served weights again from the seed, as the reference's fp32."""
    flat = weights.draw(leaves, seed, device)
    if weights.checksum(flat) != drawn:
        raise RuntimeError("the redraw from the seed gave other weights")
    return weights.reference_tree(leaves, flat, round_bf16=True)


def served_logits(model, tree, prompts: np.ndarray, tokens: np.ndarray,
                  device):
    """Blocks of ``REF_ROWS`` requests: (rows of logits at each served
    token's position (rows, new, vocab), those rows' tokens), one
    forward over each prompt and its served tokens."""
    p_len, new = prompts.shape[1], tokens.shape[1]
    for lo in range(0, len(prompts), REF_ROWS):
        seq = np.concatenate([prompts[lo:lo + REF_ROWS],
                              tokens[lo:lo + REF_ROWS, :-1]], axis=1)
        logits = model.logits(tree, torch.from_numpy(seq).to(device))
        yield (logits[:, p_len - 1:p_len - 1 + new],
               torch.from_numpy(tokens[lo:lo + REF_ROWS]).to(device))


def reference_gaps(cfg: dict, seed: int, device, leaves, drawn: float,
                   served: list) -> torch.Tensor:
    """Each served token's gap below the reference's best logit."""
    tree = reference_tree(seed, device, leaves, drawn)
    model = qwen3.Model(cfg)
    prompts = np.concatenate([p for p, _ in served])
    tokens = np.concatenate([t for _, t in served])
    with torch.no_grad(), qwen3.exact_fp32():
        gaps = [compare.served_gaps(at, tok).cpu() for at, tok in
                served_logits(model, tree, prompts, tokens, device)]
    return torch.cat(gaps)


def run(ctx) -> dict:
    cfg, mix = ctx.cfg, ctx.mix
    leaves = weights.layout(cfg)
    n_params = weights.n_params(leaves)
    flat = weights.draw(leaves, ctx.seed, ctx.device)
    drawn = weights.checksum(flat)
    units = weights.host_units(leaves, flat, "bfloat16")
    del flat
    model = port.offloadable(cfg, units, ctx.device)
    b, p_len, new = mix["batch"], mix["prompt"], mix["new_tokens"]
    vocab = cfg["vocab_size"]
    spec = DecodeSpec(batch=b, max_seq=mix["max_seq"], bucket=mix["bucket"])
    root = tempfile.mkdtemp(prefix="portbench-store-")
    try:
        capacity = store_capacity(cfg, n_params, mix)
        policy = port.policy(mix, lambda: DirectNVMeEngine(
            os.path.join(root, "raw_store"), n_devices=mix["store_devices"],
            device_capacity=capacity))
        tracker = port.MemoryTracker()
        prof = tracing.profiler() if ctx.trace else None
        with port.OffloadSession(model, policy, mode="serve", decode=spec,
                                 tracker=tracker) as session:
            ctx.log("session open, store written")
            if ctx.trace:
                _spanned(ctx, session)
            dec = OffloadedDecoder(model, policy, session=session)
            warm = dec.generate(weights.prompts(ctx.seed, 0, b, p_len, vocab),
                                new)
            ctx.log(f"warm batch served {warm.shape}")
            wait0 = session.swapper.stats.wait_seconds
            if prof is not None:
                prof.start()
            served, ends, index = [], [], 0
            t0 = time.perf_counter()
            with ctx.spans("window"):
                while True:
                    index += 1
                    prompts = weights.prompts(ctx.seed, index, b, p_len,
                                              vocab)
                    served.append((prompts, dec.generate(prompts, new)))
                    ends.append(time.perf_counter() - t0)
                    if ends[-1] >= ctx.seconds:
                        break
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
                t1 = time.perf_counter()
            peak = ctx.rss.stop()
            if prof is not None:
                prof.stop()
            device = port.device_info(ctx.device)
            wait_s = session.swapper.stats.wait_seconds - wait0
            breakdown = tracker.breakdown()
            io = session.store.stats.snapshot()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    batches, window_s = len(served), t1 - t0
    ctx.log(f"window: {batches} batches, ending at {ends} s, in "
            f"{window_s!r} s, swapper wait "
            f"{wait_s!r} s, store {io}")
    record = {"batches": batches, "window_s": window_s,
              "token_steps": batches * new, "tokens": batches * b * new,
              "swap_wait_s": wait_s, "tracker": breakdown,
              "store_bytes_written": io["bytes_written"],
              "trace": tracing.reduce(prof) if prof is not None else None}
    end_to_end = {"decode_tokens_per_s": batches * b * new / window_s,
                  "peak_host_gib": peak / port.GIB,
                  "setup_s": t0 - ctx.t_start}
    ctx.log(f"end to end {end_to_end}")

    del model, units, session, dec
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = reference_gaps(cfg, ctx.seed, ctx.device, leaves, drawn, served)
    ctx.log(f"served-token gaps over {gaps.numel()} tokens: widest "
            f"{float(gaps.max())!r}, mean {float(gaps.mean())!r}")
    bad = sum(int(t.shape != (b, new)) for _, t in served)
    return {"end_to_end": end_to_end, "record": record,
            "numbers": {"served_logit_gap": float(gaps.max())},
            "attempted": batches * b, "failed": bad * b, "device": device}
