"""Fixtures of the benchmark's own tests: a copy of the benchmark with
tiny cells added as new files, and a runner that drives a cell of that
copy on the CPU in a fresh process.

The tiny cells' limits were set from CPU readings at the seeds the tests
use: the port (bf16) reads below them, the fp8 control and every fault
above at least one of them (``test_portbench_faults.py`` holds both
sides).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "qwen3-tiny": ("qwen3-4b", dict(
        hidden_size=64, intermediate_size=96, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, vocab_size=512)),
    "qwen3-moe-tiny": ("qwen3-30b-a3b", dict(
        hidden_size=64, moe_intermediate_size=24, num_experts=16,
        num_experts_per_tok=2, num_attention_heads=8,
        num_key_value_heads=1, head_dim=8, vocab_size=512)),
}
TINY_MIXES = {
    "train-tiny": ("train-b2s512", dict(seq=32)),
    "train-tiny-routed": ("train-b2s512-routed",
                          dict(seq=32, expert_page_slots=48)),
    "decode-tiny": ("decode-b4p512", dict(prompt=32, new_tokens=4,
                                          max_seq=64, bucket=16)),
}
# cell -> (config, mix, the full-size cell whose metrics it reports, limits)
TINY_CELLS = {
    "qwen3-tiny.train-tiny": (
        "qwen3-tiny", "train-tiny", "qwen3-4b.train-b2s512",
        {"loss_gap": 1e-3, "grad_norm_gap": 8e-3, "change_norm_gap": 0.05}),
    "qwen3-moe-tiny.train-tiny-routed": (
        "qwen3-moe-tiny", "train-tiny-routed",
        "qwen3-30b-a3b.train-b2s512-routed",
        {"loss_gap": 5e-3, "grad_norm_gap": 0.05, "change_norm_gap": 0.1}),
    "qwen3-tiny.decode-tiny": (
        "qwen3-tiny", "decode-tiny", "qwen3-4b.decode-b4p512",
        {"served_logit_gap": 0.1}),
}


def digest(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def add_tiny_cells(root: Path) -> None:
    """New files only under ``portbench/``, and new entries in
    ``BENCHMARK.json``."""
    here = root / "portbench"
    for name, (base, changes) in TINY_CONFIGS.items():
        cfg = json.loads((here / "configs" / f"{base}.json").read_text())
        cfg.update(changes, name=name)
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, (base, changes) in TINY_MIXES.items():
        mix = json.loads((here / "mixes" / f"{base}.json").read_text())
        mix.update(changes)
        (here / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, (config, mix, like, limits) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "a CPU test's tiny cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
        (here / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def bench_copy(tmp_path: Path) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` copied, the port's sources
    linked beside them, and the tiny cells added."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "src", tmp_path / "src")
    add_tiny_cells(tmp_path)
    return tmp_path


RUNNER = """
import sys, time
t_start = time.perf_counter()
sys.path[:0] = ["portbench", "src"]
from rss import RssPeak
rss = RssPeak().start()
{patch}
import bench
rc = bench.main(sys.argv[1:], t_start=t_start, rss=rss, device="cpu")
{after}
sys.exit(rc)
"""


def run_cell(root: Path, workload: str, *, seed: int = 11,
             seconds: float = 0.5, trace: int = 0, patch: str = "",
             after: str = "") -> tuple[int, dict | None, str]:
    """Drive ``workload`` of the copy at ``root`` on the CPU in a fresh
    process (the harness's look for a card skipped), with ``patch`` run
    before the harness is imported.  Returns (exit code, the result
    line's object or None, standard error)."""
    code = RUNNER.format(patch=textwrap.dedent(patch),
                         after=textwrap.dedent(after))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", workload, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, env=env, timeout=300)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, line, proc.stderr
