"""The readings that set a cell's limits, away from the benchmark's runs.

    python3 portbench/control.py --workload <cell> --seeds a,b,c \
        [--out <file.json>]

For each seed, at the cell's own sizes, the plain reference is put in the
port's place and read with the numbers a run compares:

* ``control``: the reference computed one precision below the port's
  bf16, every matrix product from fp8 operands (``reference.qwen3``);
* training, ``half_batch``: the reference fed half of each batch, its
  mean taken over the rest;
* training, ``unchanged``: a step that returns its state unchanged
  (every leaf's change 0) reads 1 on ``change_norm_gap`` by definition;
* serving, ``altered_token``: each served token replaced by another id.

For serving the reference decodes the prompts greedily itself, and the
control's reading is the gap of the token that the lower precision puts
first at each of those positions.  The port is not run here: the lower
readings come from the benchmark's own runs, which print their numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (HERE, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
import compare  # noqa: E402
import weights  # noqa: E402
from reference import qwen3  # noqa: E402


def train_readings(cell, seed: int, device) -> dict:
    from drivers import train
    cfg, mix = cell.config, cell.mix
    leaves = weights.layout(cfg, mix["expert_paging"])
    drawn = weights.checksum(weights.draw(leaves, seed, device))
    batches = [weights.train_batch(seed, i, mix["batch"], mix["seq"],
                                   cfg["vocab_size"])
               for i in range(1, mix["setup_steps"] + 1)]

    def ref(**kw):
        out = train.reference(cfg, mix, seed, device, leaves, drawn,
                              batches, **kw)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    fp32 = ref()
    unchanged = dict(fp32, change_norms={n: 0.0 for n in
                                         fp32["change_norms"]})
    experts = [leaf.name for leaf in leaves if leaf.is_expert]
    return {
        "control": compare.train_numbers(ref(fp8=True), fp32, experts),
        "half_batch": compare.train_numbers(ref(rows=mix["batch"] // 2),
                                            fp32, experts),
        "unchanged": compare.train_numbers(unchanged, fp32, experts)}


def greedy(model, tree, prompts: np.ndarray, new: int, device) -> np.ndarray:
    """The reference's own greedy continuation, one full forward a
    token."""
    seq = torch.from_numpy(prompts).to(device)
    out = []
    for _ in range(new):
        nxt = model.logits(tree, seq)[:, -1].argmax(-1)
        out.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1).cpu().numpy()


def decode_readings(cell, seed: int, device, batches: int) -> dict:
    from drivers import decode
    cfg, mix = cell.config, cell.mix
    leaves = weights.layout(cfg)
    drawn = weights.checksum(weights.draw(leaves, seed, device))
    tree = decode.reference_tree(seed, device, leaves, drawn)
    ref, low = qwen3.Model(cfg), qwen3.Model(cfg, fp8=True)
    rng = weights.rng(seed, 99)
    control, altered = [], []
    with torch.no_grad(), qwen3.exact_fp32():
        for index in range(1, batches + 1):
            prompts = weights.prompts(seed, index, mix["batch"],
                                      mix["prompt"], cfg["vocab_size"])
            tokens = greedy(ref, tree, prompts, mix["new_tokens"], device)
            p_len, new = prompts.shape[1], tokens.shape[1]
            seq = torch.from_numpy(np.concatenate(
                [prompts, tokens[:, :-1]], axis=1)).to(device)
            at = ref.logits(tree, seq)[:, p_len - 1:p_len - 1 + new]
            low_at = low.logits(tree, seq)[:, p_len - 1:p_len - 1 + new]
            control.append(compare.served_gaps(at, low_at.argmax(-1)))
            tok = torch.from_numpy(tokens).to(device)
            shift = torch.from_numpy(rng.integers(
                1, cfg["vocab_size"], size=tokens.shape)).to(device)
            altered.append(compare.served_gaps(
                at, (tok + shift) % cfg["vocab_size"]))
    return {"control": {"served_logit_gap": float(torch.cat(
                [c.flatten() for c in control]).max())},
            "altered_token": {"served_logit_gap": float(torch.cat(
                [a.flatten() for a in altered]).max())}}


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, three or more")
    p.add_argument("--batches", type=int, default=3,
                   help="serving: batches of requests read a seed")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = bench.load_cell(args.workload)
    device = torch.device(args.device)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.mix["driver"] == "train":
            readings = train_readings(cell, seed, device)
        else:
            readings = decode_readings(cell, seed, device, args.batches)
        row = {"workload": args.workload, "seed": seed,
               "seconds": time.perf_counter() - t0, **readings}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
