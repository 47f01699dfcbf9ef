"""Training launcher: the device-resident path and the SSD-offloaded path.

Port of ``src/repro/launch/train.py`` for one card.  Without
``--offload`` it runs the resident train step (:func:`repro_torch.train.
build_train_step`: loss, gradients and the overflow screen on the device)
with the dynamic loss scaler and plain SGD on the gradients, as the
reference's demo loop does.  ``--offload POLICY`` instead runs the arch
through the SSD-offloaded ``OffloadSession`` (StreamPlan schedules,
lookahead prefetch, host Adam on NVMe-resident state), with the policy
selected by registry name.  ``--device`` (default ``cuda``) is the port's
addition.

Meshes (:mod:`repro_torch.launch.mesh`): ``--production-mesh`` runs the
resident step over the 16x16 ("data", "model") mesh, as the reference's
flag does; it needs a process group of world size 256 — under
``torchrun`` (its ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` environment),
one rank a card — and raises without one.  ``--host-mesh`` runs it over
the 1x1 mesh of a one-rank group opened here (``nccl`` on the card,
``gloo`` on the CPU).  With neither flag the resident loop runs on plain
tensors, one card: the one difference from the reference, whose default
is the host mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --steps 20 [--reduced] [--batch 4] [--seq 128] [--offload memascend] \\
      [--device cpu] [--host-mesh | --production-mesh]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.loss_scale import DynamicLossScaler
from repro_torch.core.offload_engine import OffloadPolicy
from repro_torch.core.session import OffloadSession
from repro_torch.data import DataLoader, SyntheticTextDataset
from repro_torch.models import build
from repro_torch.models.layers import resolve_device
from repro_torch.train.step import build_train_step, tree_map


def run_offloaded(cfg, args) -> None:
    """The SSD-offloaded path: registry policy + OffloadSession."""
    from repro_torch.core.model_adapter import make_offloadable_lm
    model = make_offloadable_lm(cfg, 0, device=args.device)
    b, s = args.batch, args.seq
    dl = DataLoader(SyntheticTextDataset(vocab=cfg.vocab, seed=0),
                    batch=b, seq_len=s)
    with tempfile.TemporaryDirectory(prefix="launch_offload_") as root:
        policy = (OffloadPolicy.preset(args.offload)
                  .with_store(root).with_adam(lr=args.lr)
                  .with_overlap(args.overlap).build())
        with OffloadSession(model, policy) as sess:
            print(f"offload policy {policy.name}: "
                  f"{sess.total_params / 1e6:.1f}M params, "
                  f"lookahead {sess.lookahead}, overlap {policy.overlap}")
            t0 = time.time()
            for i in range(1, args.steps + 1):
                hb = dl.next_batch()
                m = sess.train_step(hb["tokens"], hb["labels"])
                if i % 5 == 0 or i == 1:
                    tput = i * b * s / (time.time() - t0)
                    print(f"step {i:4d} loss {m['loss']:.4f} "
                          f"fetch-wait {m['fetch_wait_s'] * 1e3:.0f}ms "
                          f"optim-gate {m['optim_gate_s'] * 1e3:.0f}ms "
                          f"optim-prefetch-wait "
                          f"{m['optim_prefetch_wait_s'] * 1e3:.0f}ms "
                          f"overflow-screen "
                          f"{m['overflow_screen_s'] * 1e3:.1f}ms "
                          f"{tput:.0f} tok/s")
            sess.synchronize()   # close the timing window on the last Adam
    print("offloaded train loop done")


def sgd_update(params, grads, lr: float, scale: float):
    """``p - lr / scale * g`` on every leaf, in the leaf's dtype: SGD on the
    unscaled gradients of a scaled loss."""
    inv = 1.0 / scale
    return tree_map(lambda p, g: (p - lr * inv * g.to(p.dtype)).to(p.dtype),
                    params, grads)


def resident_loop(step, params, batches, *, lr: float,
                  scaler: DynamicLossScaler, on_step=None):
    """The resident path's loop: one ``step(params, batch, scale)`` a batch,
    the scaler fed its overflow flag, and SGD applied only to the steps it
    admits.  ``on_step(i, loss, overflow)`` sees each step.  Returns the
    final params."""
    for i, batch in enumerate(batches, start=1):
        loss, grads, overflow = step(params, batch, scaler.scale)
        overflowed = bool(overflow)
        if scaler.update(overflowed):
            params = sgd_update(params, grads, lr, scaler.scale)
        del grads
        if on_step is not None:
            on_step(i, loss, overflowed)
    return params


def run_resident(cfg, args) -> None:
    """The device-resident path: build, train step, loss scaler, SGD (over
    a mesh when a flag asks for one)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh,
                                         one_rank_group)
    dev = resolve_device(args.device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if args.host_mesh:
        with one_rank_group(backend):
            _resident(cfg, args, dev, make_host_mesh(device_type=dev.type))
        return
    if not args.production_mesh:
        _resident(cfg, args, dev, None)
        return
    # under torchrun: one rank a card, the group from its environment
    opened = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    if opened:
        dist.init_process_group(backend)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    try:
        _resident(cfg, args, dev, make_production_mesh(device_type=dev.type))
    finally:
        if opened:
            dist.destroy_process_group()


def _resident(cfg, args, dev, mesh) -> None:
    from repro_torch.launch.sharding import place
    from repro_torch.models.registry import TensorSpec
    hint = None
    if mesh is not None:
        from repro_torch.train.step import make_act_hint
        hint = make_act_hint(mesh)
    impl = build(cfg, device=dev, hint=hint)
    params = impl.init_params(0)
    scaler = DynamicLossScaler(scale=1.0)   # bf16 compute
    b, s = args.batch, args.seq
    extra = {}
    if cfg.prefix_len:
        extra["image_embeds"] = torch.ones((b, cfg.prefix_len, cfg.d_model),
                                           dtype=torch.bfloat16, device=dev)
    if cfg.family == "audio":        # the stub frontend's frame embeddings
        extra["frames"] = torch.ones((b, cfg.encoder_seq, cfg.d_model),
                                     dtype=torch.bfloat16, device=dev)
    dl = DataLoader(SyntheticTextDataset(vocab=cfg.vocab, seed=0),
                    batch=b, seq_len=s)
    if mesh is None:
        step = build_train_step(impl)
    else:
        batch_shape = {"tokens": TensorSpec((b, s), torch.int32),
                       "labels": TensorSpec((b, s), torch.int32),
                       **{k: TensorSpec(tuple(v.shape), v.dtype)
                          for k, v in extra.items()}}
        step, in_placements, _out = build_train_step(
            impl, mesh, batch_shape=batch_shape)
        params = place(params, in_placements[0], mesh)
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"({mesh.device_type})")

    def batches():
        for _ in range(args.steps):
            hb = dl.next_batch()
            yield {"tokens": torch.from_numpy(hb["tokens"]).to(dev),
                   "labels": torch.from_numpy(hb["labels"]).to(dev),
                   **extra}

    t0 = time.time()

    def report(i, loss, overflow):
        if i % 5 == 0 or i == 1:
            tput = i * b * s / (time.time() - t0)
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"overflow={overflow} {tput:.0f} tok/s")

    resident_loop(step, params, batches(), lr=args.lr, scaler=scaler,
                  on_step=report)
    print("train loop done")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--offload", default=None,
                    choices=OffloadPolicy.names(),
                    help="run SSD-offloaded via this registry policy "
                         "instead of the resident path")
    ap.add_argument("--overlap", default="full",
                    choices=["sync", "h2d", "full"],
                    help="offload pipeline overlap level (the Fig. 6 "
                         "ablation): sync H2D/gradwrite/optimizer, "
                         "async H2D only, or the full pipeline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    meshes = ap.add_mutually_exclusive_group()
    meshes.add_argument("--production-mesh", action="store_true",
                        help="the 16x16 mesh (a process group of 256 "
                             "ranks, e.g. under torchrun)")
    meshes.add_argument("--host-mesh", action="store_true",
                        help="the 1x1 mesh of a one-rank group")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.offload:
        run_offloaded(cfg, args)
        return
    run_resident(cfg, args)


if __name__ == "__main__":
    main()
