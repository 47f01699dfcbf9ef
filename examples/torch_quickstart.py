"""Quickstart over the PyTorch port: MemAscend's four optimizations at the
paper's scale, in accounting mode (no pinned memory is taken).

On the card (the default) the fused overflow check also runs as the
port's Hopper kernel over a device copy of the gradient buffer; with
``--device cpu`` it runs on the host only.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import PAPER_MODELS
from repro_torch.core import (AdaptiveBufferPool, AlignmentFreeAllocator,
                              DirectNVMeEngine, FixedBufferPool,
                              MemoryTracker, PowerOfTwoCachingAllocator,
                              baseline_overflow_check, fmt_bytes,
                              fused_overflow_check)
from repro_torch.kernels import ops
from repro_torch.models.layers import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    device = resolve_device(args.device)    # raises where no card is
    cfg = PAPER_MODELS["llama3.1-8b"]
    print(f"model: {cfg.name} ({cfg.param_count() / 1e9:.2f}B params)\n")

    # 1) Adaptive buffer pool (paper SIV-B) --------------------------------
    census = cfg.pool_census(inflight_blocks=1, shards=2)
    fixed = FixedBufferPool(census, AlignmentFreeAllocator(
        tracker=MemoryTracker(), component="p"))
    adaptive = AdaptiveBufferPool(census, AlignmentFreeAllocator(
        tracker=MemoryTracker(), component="p"))
    print(f"[1] parameter buffer pool: fixed {fmt_bytes(fixed.pool_bytes)}"
          f" -> adaptive {fmt_bytes(adaptive.pool_bytes)}"
          f"  (-{1 - adaptive.pool_bytes / fixed.pool_bytes:.1%})")

    # 2) Alignment-free pinned allocation (SIV-C) --------------------------
    req = int(2.1 * 2**30)
    t1, t2 = MemoryTracker(), MemoryTracker()
    PowerOfTwoCachingAllocator(tracker=t1, component="x").alloc(req)
    AlignmentFreeAllocator(tracker=t2, component="x").alloc(req)
    print(f"[2] pinned alloc of {fmt_bytes(req)}: pow2 reserves "
          f"{fmt_bytes(t1.live_allocated)}, alignment-free "
          f"{fmt_bytes(t2.live_allocated)}")

    # 3) Fused overflow check (SIV-D) --------------------------------------
    grads = np.random.default_rng(0).standard_normal(20_000_000).astype(
        np.float32)
    t = MemoryTracker()
    baseline_overflow_check(grads, tracker=t)
    peak_chained = t.component("overflow_tmp").peak_allocated
    t = MemoryTracker()
    fused_overflow_check(grads, tracker=t)
    peak_fused = t.component("overflow_tmp").peak_allocated
    print(f"[3] overflow check temps on a {fmt_bytes(grads.nbytes)} buffer: "
          f"chained {fmt_bytes(peak_chained)} vs fused {fmt_bytes(peak_fused)}")
    if device.type == "cuda":
        g = torch.from_numpy(grads).to(device)
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        clean = bool(ops.overflow_flag_(g, flag).item())
        g[12345] = float("inf")
        flag.zero_()
        caught = bool(ops.overflow_flag_(g, flag).item())
        print(f"    on {torch.cuda.get_device_name(device)}: the Hopper "
              f"kernel flags the clean buffer {clean}, with one Inf "
              f"{caught}, no host temporary")

    # 4) Direct NVMe engine (SIV-E) ----------------------------------------
    with tempfile.TemporaryDirectory() as root:
        eng = DirectNVMeEngine(root, n_devices=2, device_capacity=1 << 28)
        x = np.random.default_rng(1).standard_normal((1024, 1024)).astype(
            np.float32)
        eng.write("layer0/w_q", x)
        y = eng.read_new("layer0/w_q", np.float32, x.shape)
        assert np.array_equal(x, y)
        ext = eng._locations["layer0/w_q"][2]
        print(f"[4] direct NVMe engine: {fmt_bytes(x.nbytes)} striped across "
              f"{len(ext)} raw devices at LBAs "
              f"{[(e.device, e.offset) for e in ext]}")
        eng.close()

    fixed.close()
    adaptive.close()
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
