"""The readings that set a DeepSeek-V3-style training cell's limits, away
from the benchmark's runs (``control.py`` reads the Qwen3 cells; this is
its counterpart over ``reference/deepseek_v3.py``).

    python3 portbench/control_deepseek_v3.py --workload <cell> \
        --seeds a,b,c [--device cuda] [--out <file.json>]

For each seed, at the cell's own sizes, the plain reference is put in the
port's place and read with the numbers a run compares:

* ``control``: the reference computed one precision below the port's
  bf16, every matrix product from fp8 operands;
* ``half_batch``: the reference fed half of each batch;
* ``unchanged``: a step that returns its state unchanged (every leaf's
  change 0).

The port is not run here: its readings come from the benchmark's runs.
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

import torch  # noqa: E402

import bench  # noqa: E402
import compare  # noqa: E402
import layout_deepseek_v3 as layout  # noqa: E402
import weights  # noqa: E402
from drivers import train_deepseek_v3 as driver  # noqa: E402


def readings(cell, seed: int, device) -> dict:
    cfg, mix = cell.config, cell.mix
    leaves = layout.layout(cfg, mix["expert_paging"])
    drawn = weights.checksum(weights.draw(leaves, seed, device))
    batches = [weights.train_batch(seed, i, mix["batch"], mix["seq"],
                                   cfg["vocab_size"])
               for i in range(1, mix["setup_steps"] + 1)]

    def ref(**kw):
        out = driver.reference(cfg, mix, seed, device, leaves, drawn,
                               batches, **kw)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    fp32 = ref()
    unchanged = dict(fp32, change_norms={n: 0.0 for n in
                                         fp32["change_norms"]})
    experts = [leaf.name for leaf in leaves if leaf.is_expert]
    return {
        "losses": fp32["losses"],
        "control": compare.train_numbers(ref(fp8=True), fp32, experts),
        "half_batch": compare.train_numbers(ref(rows=mix["batch"] // 2),
                                            fp32, experts),
        "unchanged": compare.train_numbers(unchanged, fp32, experts)}


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, three or more")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = bench.load_cell(args.workload)
    device = torch.device(args.device)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed,
               **readings(cell, seed, device),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
