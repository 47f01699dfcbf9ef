"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--layers N] [--new-tokens N] [--seed S]

Phases (each raises on failure; the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` with
   nvcc (one process per source, all at once);
3. hold each kernel against its plain PyTorch version on the card: the
   reference sweeps, ``causal=False``, lengths no tile divides, and the
   main path's shape;
4. time each kernel at the main path's shape (CUDA events, median), its
   plain version, one PyTorch library call computing the same function
   (a yardstick only: the port never calls it) and the bound, the larger
   of bytes over 3.35 TB/s and operations over 989 TFLOP/s (H100 SXM,
   dense bf16);
5. the main path: SSD-offloaded cached decode of qwen3-4b at full width
   and ``--layers`` depth (random weights from ``--seed``) through
   ``OffloadedDecoder.generate`` under the ``memascend`` policy with full
   overlap; the kernel launch counts are zeroed just before and read just
   after; then the first-token logits are held against a device-resident
   forward of the same weights through the plain attention;
6. print the ``kernels`` JSON line, the card line, and the result line.

Needs one CUDA device.  Kernel builds and the SSD store live under
``build/`` next to this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DecodeSpec, OffloadPolicy  # noqa: E402
from repro_torch.core.dtypes import cast_host, to_torch  # noqa: E402
from repro_torch.core.model_adapter import make_offloadable_lm  # noqa: E402
from repro_torch.core.nvme import DirectNVMeEngine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.swa_attention import (  # noqa: E402
    swa_attention_cuda, swa_attention_plain)
from repro_torch.models.attention import gqa_project_qkv  # noqa: E402
from repro_torch.models.layers import (dense, embed_lookup,  # noqa: E402
                                       lm_logits, rms_norm)
from repro_torch.models.transformer import apply_ffn  # noqa: E402
from repro_torch.serve import OffloadedDecoder  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
# first-token logits vs the device-resident plain forward: 8 bf16 ULPs of
# each row's max logit, the repo's teacher-forced decode audit bound
# (benchmarks/bench_decode.py); a kernel or cache fault moves logits at
# row-max scale, far past it
LOGIT_TOL = 8.0 * 2.0 ** -8
BATCH, PROMPT, BUCKET = 4, 512, 64


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of one call over ``reps`` event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 3 + 4: the attention kernel ---------------------------------------

def _qkv(gen, b, h, kh, s, d, dtype):
    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    return rnd(b, h, s, d), rnd(b, kh, s, d), rnd(b, kh, s, d)


def check_attention(gen) -> float:
    """Kernel vs plain on the card; returns the max error at the main
    path's shape.  Tolerances are the reference sweep's: fp32 2e-5 (same
    math, other summation order), bf16 3e-2 (one output rounding)."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for h, kh in ((4, 4), (4, 2), (8, 1)):
            for window in (0, 64, 128):
                cases.append((dtype, (2, h, kh, 256, 32), window, True))
    cases += [(torch.float32, (1, 2, 2, 128, 16), 0, False),
              (torch.bfloat16, (2, 8, 2, 200, 64), 0, True),
              (torch.float32, (1, 4, 2, 77, 128), 32, True),
              (torch.bfloat16, (1, 4, 1, 130, 256), 0, False)]
    main_shape = (BATCH, 32, 8, PROMPT, 128)
    cases.append((torch.bfloat16, main_shape, 0, True))
    main_err = None
    for dtype, (b, h, kh, s, d), window, causal in cases:
        q, k, v = _qkv(gen, b, h, kh, s, d, dtype)
        out = swa_attention_cuda(q, k, v, window=window, causal=causal)
        torch.cuda.synchronize()
        ref = swa_attention_plain(q, k, v, window=window, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        print(f"  swa_attention {str(dtype)[6:]:8s} B{b} H{h} KH{kh} S{s} "
              f"D{d} window {window} causal {causal}: max err {err:.3e} "
              f"(tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"swa_attention disagrees with its plain "
                                 f"version: {err} > {tol}")
        if (b, h, kh, s, d) == main_shape:
            main_err = err
    return main_err


def time_attention(gen) -> dict:
    """Times at the main path's prefill shape (bf16, causal, window 0)."""
    b, h, kh, s, d = BATCH, 32, 8, PROMPT, 128
    q, k, v = _qkv(gen, b, h, kh, s, d, torch.bfloat16)
    ms = cuda_ms(lambda: swa_attention_cuda(q, k, v))
    plain_ms = cuda_ms(lambda: swa_attention_plain(q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * b * h * s * d + 2 * b * kh * s * d)   # q, o, k, v
    live_pairs = s * (s + 1) // 2                           # causal band
    flops = 4 * d * live_pairs * b * h                      # QK^T and PV
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    flops_ms = 1e3 * flops / BF16_FLOPS_PER_S
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


# -- phase 5: the main path ----------------------------------------------------

def resident_first_logits(cfg, units, prompts) -> np.ndarray:
    """Last-position logits of a plain device-resident forward of the same
    bf16 weights: no streaming, no KV cache, plain attention."""
    dev = torch.device("cuda")

    def load(params):
        return {k: to_torch(cast_host(v, "bfloat16"),
                            torch.bfloat16).to(dev)
                for k, v in params.items()}

    tokens = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    b, s = prompts.shape
    h = embed_lookup(load(units[0].params)["embed"], tokens)
    positions = torch.arange(s, device=dev).expand(b, s)
    for unit in units[1:-1]:
        p = load(unit.params)
        hn = rms_norm(h, p["norm_mixer"], cfg.rms_eps)
        q, k, v = gqa_project_qkv(p, hn, cfg, positions)
        att = swa_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
        mix = dense(att.transpose(1, 2).reshape(b, s, -1), p["attn.w_o"])
        h = apply_ffn(cfg, "dense", p, h + mix)
    p = load(units[-1].params)
    hl = rms_norm(h[:, -1:], p["final_norm"], cfg.rms_eps)
    return lm_logits(hl, p["head"])[:, 0].cpu().numpy()


def run_main_path(args, workdir: str) -> dict:
    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=args.layers)
    print(f"main path: {cfg.name} d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab}, depth {cfg.n_layers} of 36 "
          f"(--layers), batch {BATCH}, prompt {PROMPT}, "
          f"{args.new_tokens} new tokens")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device="cuda")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, size=(BATCH, PROMPT), dtype=np.int64)
    spec = DecodeSpec(batch=BATCH, max_seq=PROMPT + args.new_tokens + 32,
                      bucket=BUCKET)
    # the memascend store (two striped raw regions), sized to hold the bf16
    # weights plus every KV page with room to spare
    n_params = sum(v.size for u in model.units for v in u.params.values())
    kv_bytes = 2 * 2 * BATCH * spec.max_seq * cfg.n_kv_heads * \
        cfg.head_dim * cfg.n_layers
    capacity = -(-(2 * n_params + kv_bytes) // 2) + (256 << 20)
    policy = OffloadPolicy.preset("memascend").with_store(
        factory=lambda: DirectNVMeEngine(os.path.join(workdir, "raw_store"),
                                         n_devices=2,
                                         device_capacity=capacity)).build()
    with OffloadedDecoder(model, policy, decode=spec) as dec:
        session = dec.session
        setup_s = time.perf_counter() - t0
        slot = torch.from_numpy(session.pool.arena[:4096])
        pinned = slot.is_pinned()
        torch.cuda.synchronize()

        swa_attention_cuda.launches = 0
        t1 = time.perf_counter()
        tokens = dec.generate(prompts, args.new_tokens)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t1
        launches = swa_attention_cuda.launches

        if launches != cfg.n_layers:
            raise AssertionError(f"swa_attention launched {launches} times "
                                 f"in one prefill of {cfg.n_layers} blocks")
        if tokens.shape != (BATCH, args.new_tokens) or \
                tokens.min() < 0 or tokens.max() >= cfg.vocab:
            raise AssertionError(f"bad generated tokens {tokens.shape}")
        fetch = dec.fetch_stats
        io = session.store.stats.snapshot()
        kvo = dec.kv_overlap_stats
        ostats = session.overlap_snapshot()

        # the same entry points again, timed per phase: prefill, then the
        # greedy steps; the tokens must repeat the generate() run exactly
        kv = session.open_kv_cache()
        try:
            t2 = time.perf_counter()
            logits = session.prefill(kv, prompts)
            prefill_s = time.perf_counter() - t2
            first_logits = logits
            steps, t3 = [], time.perf_counter()
            for i in range(args.new_tokens):
                nxt = np.argmax(logits, axis=-1).astype(np.int32)
                steps.append(nxt)
                if not np.isfinite(logits).all():
                    raise AssertionError(f"non-finite logits at step {i}")
                if i + 2 < args.new_tokens:
                    logits = session.decode_step(kv, nxt[:, None])
                elif i + 1 < args.new_tokens:
                    # the last step under the profiler: device busy share
                    t_step = time.perf_counter()
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        logits = session.decode_step(kv, nxt[:, None])
                        torch.cuda.synchronize()
                    step_ms = 1e3 * (time.perf_counter() - t_step)
            decode_s = time.perf_counter() - t3
        finally:
            kv.close()
        if not np.array_equal(np.stack(steps, axis=1), tokens):
            raise AssertionError("a second run of the same prompts gave "
                                 "other tokens")
        pinned_stats = session.tracker.component("pinned")
        requested, reserved = pinned_stats.live_requested, \
            pinned_stats.live_allocated

    ref = resident_first_logits(cfg, model.units, prompts)
    scale = np.maximum(np.abs(ref).max(-1, keepdims=True), 1.0)
    rel = float((np.abs(first_logits - ref) / scale).max())
    print(f"  first-token logits vs device-resident plain forward: max "
          f"row-scaled diff {rel:.3e} (tol {LOGIT_TOL:.3e}), argmax agree "
          f"{int((first_logits.argmax(-1) == ref.argmax(-1)).sum())}/"
          f"{BATCH}")
    if not rel <= LOGIT_TOL:
        raise AssertionError(f"offloaded first-token logits differ from the "
                             f"resident forward: {rel} > {LOGIT_TOL}")
    # the profiled step is timed on its own and left out of the rate
    plain_steps = args.new_tokens - 2
    decode_s -= step_ms / 1e3
    per_token_ms = 1e3 * decode_s / plain_steps
    # device-side events only (kernels and copies): the host ops that
    # launched them carry the same time again
    device_events = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device_events) / 1e3
    print("  profiled decode step, device time by kernel/copy (top 8):")
    for e in sorted(device_events,
                    key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.key[:60]:60s} {e.self_device_time_total / 1e3:9.3f} "
              f"ms x{e.count}")
    out = {
        "layers": cfg.n_layers, "setup_s": setup_s,
        "generate_s": generate_s, "prefill_s": prefill_s,
        "per_token_ms": per_token_ms,
        "tokens_per_s": BATCH * plain_steps / decode_s,
        "fetch_wait_s": fetch["wait_seconds"],
        # summed over concurrent reads, so an upper bound of the busy time
        "store_read_GB": io["bytes_read"] / 1e9,
        "store_read_s": io["read_seconds"],
        "h2d_wait_s": ostats["h2d_wait_seconds"],
        "prefetch_hits": f"{fetch['prefetch_hits']}/{fetch['n_gets']}",
        "kv_stage_hits": f"{kvo['kv_stage_hits']}/{kvo['kv_stage_gets']}",
        "pinned_requested_bytes": requested,
        "pinned_reserved_bytes": reserved,
        "slot_is_pinned": pinned, "swa_launches": launches,
        "logit_max_rel_diff": rel,
        # device time of one profiled step (kernels + copies, summed over
        # the compute and copy streams) over an unprofiled step's wall time
        # (the profiler's own start-up inflates the profiled one); None
        # where the profiler saw no device time
        "step_device_busy_ms": busy_ms or None,
        "device_idle_share": (1.0 - busy_ms / per_token_ms) if busy_ms
        else None,
    }
    for k, v in out.items():
        print(f"  {k}: {v}")
    if not pinned:
        raise AssertionError("pool slots are not page-locked: non_blocking "
                             "H2D would silently be a staged copy")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4,
                    help="qwen3-4b depth (the full model has 36)")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.new_tokens < 3 or args.layers < 1:
        ap.error("needs --new-tokens >= 3 and --layers >= 1")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 checks in fp32
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {sorted(reports) or 'cached'} in "
          f"{time.perf_counter() - t:.2f} s")
    for name, report in reports.items():
        regs = [int(w) for line in report.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(int(line.split()[4]) for line in report.splitlines()
                     if "spill stores" in line)
        print(f"  {name}: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers a thread, {spills} bytes "
              f"of spill stores")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    print("kernel vs plain:")
    max_err = check_attention(gen)
    timing = time_attention(gen)
    print(f"  swa_attention at B{BATCH} H32 KH8 S{PROMPT} D128 bf16 causal: "
          f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, "
          f"sdpa {timing['library_ms']:.4f} ms, bound "
          f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_store_") as workdir:
        main_path = run_main_path(args, workdir)

    kernels = [{
        "name": "swa_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa_attention.py:104",
        "launches": main_path["swa_launches"], "max_abs_err": max_err,
        **timing}]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
