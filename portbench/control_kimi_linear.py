"""The readings that set a Kimi Linear training cell's limits, away from
the benchmark's runs (the counterpart of ``control_deepseek_v3.py`` over
``reference/kimi_linear.py``).

    python3 portbench/control_kimi_linear.py --workload <cell> \
        --seeds a,b,c [--device cuda] [--out <file.json>]

For each seed, at the cell's own sizes, the plain reference is put in the
port's place and read with the numbers a run compares:

* ``control``: the reference computed one precision below the port's
  bf16, every projection from fp8 operands;
* ``half_batch``: the reference fed half of each batch;
* ``unchanged``: a step that returns its state unchanged (every leaf's
  change 0);
* ``no_decay`` and ``no_delta``: KDA's recurrence without its decay
  (alpha = 1) or without its delta correction (no -beta k k^T S term),
  the faults ``kda_grad_gap`` is there to catch.

The port is not run here: its readings come from the benchmark's runs.
"""

from __future__ import annotations

import argparse
import contextlib
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
from torch.utils.checkpoint import checkpoint  # noqa: E402

import bench  # noqa: E402
import layout_kimi_linear as layout  # noqa: E402
import weights  # noqa: E402
from drivers import train_kimi_linear as driver  # noqa: E402
from reference import kimi_linear  # noqa: E402


def _no_delta(q, k, v, g, beta, state=None):
    """The recurrence without its delta correction (no -beta k k^T S
    term)."""
    b, n, h, dk = k.shape
    if state is None:
        state = k.new_zeros((b, h, dk, v.shape[-1]))
    outs = []
    for t in range(n):
        state = state * torch.exp(g[:, t])[..., None] + \
            beta[:, t, :, None, None] * k[:, t][..., None] * \
            v[:, t][..., None, :]
        outs.append(torch.einsum("bhcv,bhc->bhv", state, q[:, t])
                    * dk ** -0.5)
    return torch.stack(outs, dim=1), state


@contextlib.contextmanager
def faulty_recurrence(fault: str):
    """``kimi_linear.delta_rule`` with ``fault`` ("no_decay" or
    "no_delta") for the block; the faulty recurrence without a written
    gradient runs in segments under ``torch.utils.checkpoint``."""
    whole = kimi_linear.delta_rule

    def no_delta(q, k, v, g, beta):
        outs, state = [], None
        for lo in range(0, k.shape[1], kimi_linear.SEGMENT):
            part = [t[:, lo:lo + kimi_linear.SEGMENT]
                    for t in (q, k, v, g, beta)]
            o, state = checkpoint(_no_delta, *part, state,
                                  use_reentrant=False)
            outs.append(o)
        return torch.cat(outs, dim=1)

    kimi_linear.delta_rule = (
        no_delta if fault == "no_delta" else
        lambda q, k, v, g, beta: whole(q, k, v, g * 0, beta))
    try:
        yield
    finally:
        kimi_linear.delta_rule = whole


def readings(cell, seed: int, device) -> dict:
    cfg, mix = cell.config, cell.mix
    leaves = layout.layout(cfg, mix["expert_paging"])
    drawn = weights.checksum(layout.draw(leaves, seed, device))
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
    out = {"losses": fp32["losses"],
           "control": driver.numbers(ref(fp8=True), fp32, leaves),
           "half_batch": driver.numbers(ref(rows=mix["batch"] // 2), fp32,
                                        leaves),
           "unchanged": driver.numbers(unchanged, fp32, leaves)}
    for fault in ("no_decay", "no_delta"):
        with faulty_recurrence(fault):
            out[fault] = driver.numbers(ref(), fp32, leaves)
    return out


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
