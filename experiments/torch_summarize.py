"""Render the PyTorch port's dry-run + roofline tables and splice them into
EXPERIMENTS.md at its ``DRYRUN-TABLE`` and ``ROOFLINE-TABLE`` markers.

The records are ``python -m repro_torch.launch.dryrun``'s, one directory a
mesh under ``build/dryrun_torch/`` (``h100``: one card; ``pod`` /
``multipod``: the production meshes, rank 0).  Every number in them is
computed on the meta device, none measured.

Usage: PYTHONPATH=src python experiments/torch_summarize.py
           [--out build/dryrun_torch] [--experiments EXPERIMENTS.md]
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "..", "src"))

from repro_torch.launch.roofline import load_records, report  # noqa: E402

MESHES = ("h100", "pod", "multipod")
GiB = 1 << 30


def dryrun_table(out_dir: str, mesh: str) -> str:
    lines = [
        f"### Dry-run — {mesh} (PyTorch port, meta device)",
        "",
        "| arch | shape | kind | lower s | args GiB/chip | temp GiB/chip |"
        " flops/chip | coll GB (ag/ar/rs/a2a/cp) | status |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load_records(os.path.join(out_dir, mesh)):
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                         f"| — | skipped: {r['reason'][:60]}… |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                         f"| — | ERROR |")
            continue
        m = r["memory"]
        b = r["collectives"]["bytes"]
        coll = "/".join(f"{b.get(k, 0) / 1e9:.0f}" for k in (
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | "
            f"{r['lower_seconds']:.0f} | "
            f"{m.get('argument_size_in_bytes', 0) / GiB:.2f} | "
            f"{m.get('temp_size_in_bytes', 0) / GiB:.1f} | "
            f"{r['cost'].get('flops', 0):.2e} | {coll} | ok |")
    return "\n".join(lines)


def splice(marker: str, content: str, text: str) -> str:
    tag = f"<!-- {marker} -->"
    if tag not in text:
        raise SystemExit(f"marker {marker} missing")
    return text.replace(tag, tag + "\n\n" + content)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "..", "build",
                                                  "dryrun_torch"),
                    help="the dry run's root; records under <mesh>/")
    ap.add_argument("--experiments",
                    default=os.path.join(ROOT, "..", "EXPERIMENTS.md"))
    args = ap.parse_args()
    with open(args.experiments) as fh:
        text = fh.read()
    # remove previously spliced content: keep everything up to each marker
    for marker in ("DRYRUN-TABLE", "ROOFLINE-TABLE"):
        tag = f"<!-- {marker} -->"
        if tag in text:
            head, _, rest = text.partition(tag)
            # find the next --- separator after the tag
            nxt = rest.find("\n---")
            tail = rest[nxt:] if nxt >= 0 else ""
            text = head + tag + tail
    dr, rf = [], []
    for mesh in MESHES:
        if os.path.isdir(os.path.join(args.out, mesh)):
            dr.append(dryrun_table(args.out, mesh))
            rf.append(report(os.path.join(args.out, mesh), mesh))
    text = splice("DRYRUN-TABLE", "\n\n".join(dr) or "(not yet run)", text)
    text = splice("ROOFLINE-TABLE", "\n\n".join(rf) or "(not yet run)", text)
    with open(args.experiments, "w") as fh:
        fh.write(text)
    print("EXPERIMENTS.md updated")


if __name__ == "__main__":
    main()
