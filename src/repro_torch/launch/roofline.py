"""Roofline of the dry run's records (:mod:`.dryrun`).

Port of ``src/repro/launch/roofline.py`` for NVIDIA H100 80GB HBM3 (SXM)
cards: three terms per (arch x shape), in seconds per step, per card,

    compute    = flops / PEAK_FLOPS          (989e12, dense bf16 tensor cores)
    memory     = bytes accessed / HBM_BW     (3.35e12 B/s)
    collective = link bytes / LINK_BW        (450e9 B/s; 0 on one card)

with ``link bytes`` the reference's weighting of rank 0's collective
result bytes (an all-reduce twice), and the floor, the largest of the
three, the least time the step could take.  On one card (``h100``) the
collective term is 0.  On the production meshes (``pod``: 16x16 = 256
cards, ``multipod``: 2x16x16 = 512) every number is rank 0's.  A 16x16
mesh of H100s spans 32 eight-GPU nodes: NVLink joins the 8 cards of a
node only, so the one NVLink figure is an upper bound on the link the
cross-node axis sees, and the collective term a lower bound on its time.
No interconnect model is added; the reference has none either.  The
constants are the card's data-sheet peaks, not measurements; ``bytes
accessed`` is the eager program's op-by-op traffic (see :mod:`.dryrun`),
so the memory term is the unfused program's.

``fits``: the step's predicted peak — argument + temp + output bytes — is
at most the card's memory, :data:`HBM_BYTES` (``total_memory`` of an
NVIDIA H100 80GB HBM3 at 700 W as torch reports it).

MODEL_FLOPS uses 6*N*D (train), 2*N*D (prefill), 2*N*B (decode) with N the
active parameters; useful ratio = MODEL_FLOPS / counted flops.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.roofline \
      [--mesh h100|pod|multipod] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass

from repro_torch.configs import ARCHS, INPUT_SHAPES

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16 tensor cores
HBM_BW = 3.35e12             # H100 SXM HBM3, B/s
LINK_BW = 450e9              # NVLink 4, one direction, B/s
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 at a 700 W power limit, as chip_smoke.py prints it
HBM_BYTES = 85_017_493_504

GiB = 1 << 30


def link_bytes(coll: dict) -> float:
    b = coll["bytes"]
    return (b.get("all-gather", 0)
            + 2 * b.get("all-reduce", 0)
            + b.get("reduce-scatter", 0)
            + b.get("all-to-all", 0)
            + b.get("collective-permute", 0))


def model_flops(arch: str, shape_name: str) -> float:
    cfg = ARCHS[arch]
    shape = INPUT_SHAPES[shape_name]
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per request


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    fits: bool
    temp_gib_per_chip: float
    note: str
    peak_gib: float = 0.0

    @property
    def floor_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.compute_s:.3e} | "
                f"{self.memory_s:.3e} | {self.collective_s:.3e} | "
                f"**{self.dominant}** | {self.useful_ratio:.2f} | "
                f"{self.temp_gib_per_chip:.1f} | {self.peak_gib:.1f} | "
                f"{'yes' if self.fits else 'no'} | {self.note} |")


def _recommendation(r: "Roofline") -> str:
    if not r.fits:
        if r.mesh != "1":
            return "does not fit per card: shard further or offload"
        return ("does not fit on one card: the SSD-offloaded path "
                "(OffloadSession) streams what the card cannot hold")
    if r.dominant == "collective":
        return "collective-bound: cut link volume"
    if r.dominant == "memory":
        return ("HBM-bound: shrink activation traffic (fusion, smaller "
                "remat working set, bf16 intermediates)")
    return ("compute-bound: gains come from cutting remat recompute or "
            "larger per-card batches")


def analyze(record: dict, *, hbm_bytes: int = HBM_BYTES) -> Roofline | None:
    if record.get("status") != "ok":
        return None
    chips = record["n_chips"]
    flops = record["cost"].get("flops", 0.0)
    bytes_acc = record["cost"].get("bytes accessed", 0.0)
    lb = link_bytes(record["collectives"])
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    collective_s = lb / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(record["arch"], record["shape"])
    hlo_global = flops * chips
    ratio = mf / hlo_global if hlo_global else 0.0
    mem = record["memory"]
    temp = mem.get("temp_size_in_bytes", 0)
    peak = (mem.get("argument_size_in_bytes", 0) + temp
            + mem.get("output_size_in_bytes", 0))
    r = Roofline(record["arch"], record["shape"], record["mesh"],
                 compute_s, memory_s, collective_s, dominant, mf,
                 hlo_global, ratio, peak <= hbm_bytes, temp / GiB, "",
                 peak / GiB)
    r.note = _recommendation(r)
    return r


def load_records(out_dir: str) -> list[dict]:
    recs = []
    for f in sorted(os.listdir(out_dir)):
        if f.endswith(".json"):
            with open(os.path.join(out_dir, f)) as fh:
                recs.append(json.load(fh))
    return recs


MESH_TITLES = {
    "h100": "one NVIDIA H100 80GB HBM3",
    "pod": "a 16x16 mesh of NVIDIA H100 80GB HBM3 (256 cards, rank 0; "
           "32 eight-GPU nodes: the NVLink rate bounds the cross-node link "
           "from above)",
    "multipod": "a 2x16x16 mesh of NVIDIA H100 80GB HBM3 (512 cards, "
                "rank 0; 64 eight-GPU nodes: the NVLink rate bounds the "
                "cross-node link from above)",
}


def report(out_dir: str, mesh: str = "h100") -> str:
    """The table of the records in ``out_dir`` (one mesh's directory)."""
    lines = [
        f"### Roofline — {MESH_TITLES[mesh]} (989 TFLOP/s bf16, 3.35 TB/s, "
        f"{LINK_BW / 1e9:.0f} GB/s a link; computed, not measured)",
        "",
        "| arch | shape | compute (s) | memory (s) | collective (s) | "
        "dominant | useful ratio | temp GiB/chip | peak GiB | fits | "
        "what would move it |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    skipped = []
    for rec in load_records(out_dir):
        r = analyze(rec)
        if r is None:
            why = rec.get("reason", rec.get("error", "?"))[:90]
            took = f" ({rec['seconds']} s)" if "seconds" in rec else ""
            skipped.append(f"{rec['arch']}/{rec['shape']}: "
                           f"{rec['status']}: {why}{took}")
            continue
        lines.append(r.row())
    if skipped:
        lines += ["", "Skipped:"] + [f"- {s}" for s in skipped]
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="h100",
                    choices=["h100", "pod", "multipod"])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "build",
        "dryrun_torch"), help="the dry run's root; records under <mesh>/")
    args = ap.parse_args()
    print(report(os.path.abspath(os.path.join(args.out, args.mesh)),
                 args.mesh))


if __name__ == "__main__":
    main()
