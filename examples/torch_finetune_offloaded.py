"""End-to-end example over the PyTorch port: fine-tune a ~100M-parameter LM
with full SSD offloading, ZeRO-Infinity baseline vs MemAscend.

Every piece of the paper's pipeline runs for real: weights and optimizer
state live on the (raw-file) NVMe store, the host pool streams compute
weights per block with lookahead prefetch into page-locked slots, the
blocks run on the card (``--device cpu`` for the CPU), gradients land in
the fp32 flat buffer, the overflow screen checks them (on the card under
memascend, the chained host check under zero-infinity), and the
subgroup-streamed host Adam updates the SSD-resident state.

Policies come from the registry and execution runs through OffloadSession
(StreamPlan schedules + lookahead pipelining).

Run:  PYTHONPATH=src python examples/torch_finetune_offloaded.py \
          [--steps 200] [--policy memascend|zero-infinity|memascend-bf16|both]
          [--device cuda|cpu] [--layers 12] [--vocab 32000] \
          [--seq-len 512] [--batch 4]
"""

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import OffloadPolicy, OffloadSession, fmt_bytes
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.data import DataLoader, SyntheticTextDataset

# ~100M params: 12 layers, d=512, ffn 2048, vocab 32k
CFG = ModelConfig(name="ft-100m", family="dense", n_layers=12, d_model=512,
                  n_heads=8, n_kv_heads=4, d_ff=2048, vocab=32_000)


def run(policy, cfg, steps: int, device: str, seq_len: int = 512,
        batch: int = 4) -> None:
    print(f"\n=== policy: {policy.name} (state dtype "
          f"{policy.adam.state_dtype}) ===")
    model = make_offloadable_lm(cfg, 0, device=device)
    with OffloadSession(model, policy) as s:
        print(f"params: {s.total_params / 1e6:.1f}M  "
              f"pool: {fmt_bytes(s.pool.pool_bytes)}  "
              f"flat buffer: {fmt_bytes(s.flat.nbytes)}  "
              f"lookahead: {s.lookahead}  device: {s.device}")
        dl = DataLoader(SyntheticTextDataset(vocab=cfg.vocab, seed=0),
                        batch=batch, seq_len=seq_len)
        t0 = time.time()
        for step in range(1, steps + 1):
            b = dl.next_batch()
            m = s.train_step(b["tokens"], b["labels"])
            if step % 20 == 0 or step == 1:
                tput = step * batch * seq_len / (time.time() - t0)
                print(f"step {step:4d}  loss {m['loss']:.4f}  "
                      f"scale {m['loss_scale']:.0f}  "
                      f"opt-io {fmt_bytes(m['optimizer_io_bytes'])}/step  "
                      f"fetch-wait {m['fetch_wait_s'] * 1e3:.0f}ms  "
                      f"{tput:.0f} tok/s")
        print(f"peak host memory: {fmt_bytes(s.tracker.peak_allocated)}")
        print(f"pool fragmentation: {s.pool.fragmentation():.1%}")
        print(f"SSD io: written {fmt_bytes(s.store.stats.bytes_written)}, "
              f"read {fmt_bytes(s.store.stats.bytes_read)}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--policy", default="both",
                    choices=OffloadPolicy.names() + ["both"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=CFG.n_layers)
    ap.add_argument("--vocab", type=int, default=CFG.vocab)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs an NVIDIA GPU; pass --device cpu")
    cfg = dataclasses.replace(CFG, n_layers=args.layers, vocab=args.vocab)
    names = (["zero-infinity", "memascend"] if args.policy == "both"
             else [args.policy])
    with tempfile.TemporaryDirectory(prefix="ft_offload_") as root:
        for i, name in enumerate(names):
            policy = (OffloadPolicy.preset(name)
                      .with_store(f"{root}/{i}")
                      .with_adam(lr=args.lr).build())
            run(policy, cfg, args.steps, args.device, args.seq_len,
                args.batch)


if __name__ == "__main__":
    main()
