"""Weight-streamed offloaded decode over the PyTorch port: generate from a
model whose weights live on the (raw-file) NVMe store, streamed
block-by-block per token through the OffloadSession/StreamPlan machinery
into page-locked slots and on to the card (``--device cpu`` for the
CPU) — serving on a host that cannot hold the model in DRAM.

By default generation runs the cached path: a paged spill-able KV cache in
the same pinned pool arena as the weight staging slots.  K/V lives in
fixed-size time-axis pages (``--page-tokens``, default: the bucket size);
``--kv-resident`` layer-equivalents (or ``--resident-pages`` page slots)
stay host-resident and colder pages round-trip through the SSD store —
only dirty pages pay a spill write, and each block's attended window is
gathered + H2D'd on the staging worker under the previous block's compute.
``--no-cache`` falls back to the O(T²) full-prefix re-run for comparison.

With ``--requests N`` the example becomes a continuous-batching server:
N requests with ragged prompt lengths arrive as a seeded Poisson process
(``--arrival-rate`` per second) and stream through the ServingEngine —
each finishing request's slot and KV pages are reclaimed and handed to
the next queued request mid-flight, and per-request TTFT / queue-wait /
throughput metrics are printed at the end.

Run:  PYTHONPATH=src python examples/torch_serve_offloaded_decode.py \
          [--policy memascend|zero-infinity] [--new-tokens 16] \
          [--device cuda|cpu] \
          [--kv-resident 2 | --resident-pages 4] [--bucket 16] \
          [--page-tokens 16] [--no-cache] [--lookahead 2] \
          [--requests 8 --arrival-rate 50]
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import OffloadPolicy, fmt_bytes
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.serve import (DecodeSpec, OffloadedDecoder, Request,
                               ServingEngine)

CFG = ModelConfig(name="serve-20m", family="dense", n_layers=4, d_model=256,
                  n_heads=8, n_kv_heads=4, d_ff=1024, vocab=8192)


def serve_requests(dec, args) -> None:
    """Continuous-batching demo: ragged Poisson arrivals through the
    per-slot request lifecycle (join / prefill-scatter / decode / retire)."""
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                         size=args.requests))
    reqs = []
    for i in range(args.requests):
        n = int(rng.integers(max(1, args.prompt_len // 2),
                             args.prompt_len + 1))
        reqs.append(Request(
            rid=f"r{i:02d}",
            prompt=rng.integers(3, CFG.vocab, size=n, dtype=np.int32),
            max_new_tokens=args.new_tokens,
            arrival=float(arrivals[i])))
    report = ServingEngine(dec).run(reqs)
    print(f"served {len(report.completed)}/{args.requests} requests "
          f"({len(report.refused)} refused) in {report.duration_s:.2f}s: "
          f"{report.tokens_per_s:.1f} tok/s aggregate, "
          f"occupancy {report.occupancy:.2f} over "
          f"{report.decode_steps} steps / {report.prefills} prefills")
    if report.completed:
        print(f"ttft p50 {report.ttft_percentile(50) * 1e3:.1f}ms  "
              f"p99 {report.ttft_percentile(99) * 1e3:.1f}ms")
    kv = dec.kv_stats
    print(f"kv: reclaims {kv['reclaims']} "
          f"({kv['reclaim_bytes'] / 1e6:.2f}MB dropped spill-free)  "
          f"dirty spills {kv['spills']}  refills {kv['refills']}")
    for r in report.requests[:3]:
        m = r.metrics
        print(f"  {r.rid} [{r.state.value}] prompt {r.prompt_len:3d}  "
              f"out {m.tokens_out:3d}  wait {1e3 * (m.queue_wait_s or 0):6.1f}ms  "
              f"ttft {1e3 * (m.ttft_s or 0):6.1f}ms  "
              f"tokens: {r.output[:8]} ...")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="memascend",
                    choices=OffloadPolicy.names())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--lookahead", type=int, default=None,
                    help="prefetch window (default: policy inflight depth)")
    ap.add_argument("--no-cache", action="store_true",
                    help="O(T^2) full-prefix re-run (the PR-1 behaviour)")
    ap.add_argument("--bucket", type=int, default=16,
                    help="KV time-bucket granularity (fixed shapes per bucket)")
    ap.add_argument("--kv-resident", type=int, default=None,
                    help="host KV budget in layer-equivalents "
                         "(default: all pages resident)")
    ap.add_argument("--page-tokens", type=int, default=None,
                    help="KV spill page size in tokens (default: bucket; "
                         "must align with it)")
    ap.add_argument("--resident-pages", type=int, default=None,
                    help="host KV budget directly in page slots "
                         "(overrides --kv-resident)")
    ap.add_argument("--requests", type=int, default=None,
                    help="serve N ragged requests through the continuous-"
                         "batching engine instead of one joint generate")
    ap.add_argument("--arrival-rate", type=float, default=50.0,
                    help="Poisson arrival rate for --requests, per second")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs an NVIDIA GPU; pass --device cpu")
    if args.requests is not None and args.no_cache:
        ap.error("--requests needs the paged KV cache (drop --no-cache)")

    model = make_offloadable_lm(CFG, 0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(3, CFG.vocab, size=(args.batch, args.prompt_len),
                           dtype=np.int32)
    decode = None
    if not args.no_cache:
        max_seq = args.prompt_len + args.new_tokens
        decode = DecodeSpec(batch=args.batch, max_seq=max_seq,
                            bucket=min(args.bucket, max_seq),
                            resident_blocks=(None if args.resident_pages
                                             else args.kv_resident),
                            page_tokens=args.page_tokens,
                            resident_pages=args.resident_pages)

    with tempfile.TemporaryDirectory(prefix="serve_offload_") as root:
        policy = (OffloadPolicy.preset(args.policy).with_store(root)
                  .with_lookahead(args.lookahead).build())
        with OffloadedDecoder(model, policy, decode=decode) as dec:
            print(f"policy {policy.name}  device {dec.session.device}  "
                  f"lookahead {dec.session.lookahead}  "
                  f"pool {fmt_bytes(dec.session.pool.pool_bytes)}  "
                  f"cache {'KV (spill-able)' if decode else 'none (O(T^2))'}")
            if args.requests is not None:
                serve_requests(dec, args)
                print("offloaded serve OK")
                return
            dec.generate(prompts, args.new_tokens)   # warmup/compile
            t0 = time.time()
            gen = dec.generate(prompts, args.new_tokens)
            dt = time.time() - t0
            stats = dec.fetch_stats
            print(f"generated {gen.shape} tokens in {dt:.2f}s "
                  f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
            print(f"fetches: {stats['n_gets']}  prefetch hits: "
                  f"{stats['prefetch_hits']}  fetch-wait: "
                  f"{stats['wait_seconds'] * 1e3:.1f}ms")
            if dec.kv_stats is not None:
                kv = dec.kv_stats
                ov = dec.kv_overlap_stats
                print(f"kv: dirty spills {kv['spills']} "
                      f"({kv['spill_bytes'] / 1e6:.2f}MB)  clean drops "
                      f"{kv['clean_drops']}  refills {kv['refills']}  "
                      f"prefetched {kv['prefetch_refills']}  "
                      f"kv-wait {kv['wait_seconds'] * 1e3:.1f}ms")
                print(f"kv-overlap: staged windows {ov['kv_stage_gets']}  "
                      f"ready-on-arrival {ov['kv_stage_hits']}  "
                      f"staged-wait {ov['kv_stage_wait_s'] * 1e3:.1f}ms")
            for i in range(min(args.batch, 2)):
                print(f"  request {i}: {gen[i][:16].tolist()} ...")
    print("offloaded serve OK")


if __name__ == "__main__":
    main()
