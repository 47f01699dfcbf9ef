"""The new cells' files run as they are.  A tiny copy of
``moonlight-16b-a3b.train-b2s2048-paged`` (one dense and two MoE layers,
16 experts, 48 page slots for 96 expert pages) goes through ``bench.run``
on the CPU, correct, with every per-layer metric the full cell reports;
its driver refuses a port without the sigmoid gate at once; the control
and the faults read above the tiny cell's limits, which were set from
CPU readings at the seeds used here (the port's bf16 below them).  A
tiny copy of ``qwen3-4b.train-b2s512-sync`` runs too, its rate per
layer."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from conftest import run_cell

FULL = "moonlight-16b-a3b.train-b2s2048-paged"
CELL = "moonlight-tiny.train-tiny-paged"
TINY_CONFIG = dict(
    name="moonlight-tiny", hidden_size=64, intermediate_size=96,
    moe_intermediate_size=24, n_routed_experts=16, num_experts_per_tok=4,
    num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, vocab_size=512,
    num_hidden_layers=3)
TINY_MIX = dict(seq=32, expert_page_slots=48)
# CPU readings, seeds 11-14 / 11-13: the port 0.032-0.27, 0.018-0.030,
# 0.012-0.063, 0.0024-0.015; the fp8 control 0.32-0.71, 0.065-0.38,
# 0.13-0.25, 0.050-0.074
LIMITS = {"grad_norm_gap": 0.5, "change_norm_gap": 0.1,
          "dense_grad_gap": 0.1, "expert_grad_gap_median": 0.03}

# a port whose MoEConfig has no sigmoid gate (the parent of the gate)
NO_GATE = """
import repro_torch.configs.base as base
new = base.MoEConfig
def old(**kw):
    for k in ("scoring", "routed_scale"):
        if k in kw:
            raise TypeError(f"MoEConfig() got an unexpected keyword "
                            f"argument {k!r}")
    return new(**kw)
base.MoEConfig = old
"""
HALF_BATCH = """
from repro_torch.core.session import OffloadSession
whole = OffloadSession.train_step
OffloadSession.train_step = lambda self, tokens, labels: whole(
    self, tokens[:len(tokens) // 2], labels[:len(labels) // 2])
"""


@pytest.fixture
def moon_copy(bench_copy):
    """The benchmark copy with the tiny Moonlight cell added as new files
    and entries, reporting what the full cell reports."""
    here = bench_copy / "portbench"
    cfg = json.loads((here / "configs" / "moonlight-16b-a3b.json")
                     .read_text())
    cfg.update(TINY_CONFIG)
    (here / "configs" / "moonlight-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "mixes" / "train-b2s2048-paged.json")
                     .read_text())
    mix.update(TINY_MIX)
    (here / "mixes" / "train-tiny-paged.json").write_text(json.dumps(mix))
    (here / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "moonlight-tiny",
                               "traffic": "train-tiny-paged", "chips": 1,
                               "why": "a CPU test's tiny cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if FULL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_copy


def test_the_tiny_cell_reports_every_new_metric(moon_copy):
    bench = json.loads((moon_copy / "BENCHMARK.json").read_text())
    layer = {m["name"] for m in bench["per_layer"] if FULL in m["workloads"]}
    assert len(layer) == 7
    rc, line, err = run_cell(moon_copy, CELL, trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == layer, err
    for name in layer - {"expert_drop_share.moonlight"}:
        assert line["metrics"][name]["value"] > 0, name
    assert line["metrics"]["expert_drop_share.moonlight"]["value"] >= 0
    rc, line, err = run_cell(moon_copy, CELL, trace=0)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"peak_host_gib", "setup_s"}


def test_a_port_without_the_gate_fails_at_once(moon_copy):
    t0 = time.perf_counter()
    rc, line, err = run_cell(moon_copy, CELL, patch=NO_GATE)
    assert rc != 0 and line is None
    assert "unexpected keyword argument 'scoring'" in err
    assert "weights drawn" not in err
    assert time.perf_counter() - t0 < 60


def test_half_a_batch_is_not_correct(moon_copy):
    rc, line, err = run_cell(moon_copy, CELL, patch=HALF_BATCH)
    assert rc == 0, err
    assert not line["correct"], line["checks"]


def test_the_control_and_the_faults_read_above_the_limits(moon_copy):
    proc = subprocess.run(
        [sys.executable, "portbench/control_deepseek_v3.py", "--workload",
         CELL, "--seeds", "11,12,13", "--device", "cpu"],
        cwd=moon_copy, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(r) for r in proc.stdout.strip().splitlines()]
    assert len(rows) == 3
    for row in rows:
        for kind in ("control", "half_batch", "unchanged"):
            assert any(row[kind][k] > LIMITS[k] for k in LIMITS), (kind, row)


def test_the_sync_cell_keeps_its_rate_per_layer(bench_copy):
    """A tiny copy of ``qwen3-4b.train-b2s512-sync``: A's tiny cell with
    overlap ``sync``, correct under A's tiny limits, its rate per layer."""
    here = bench_copy / "portbench"
    mix = json.loads((here / "mixes" / "train-b2s512-sync.json").read_text())
    mix.update(seq=32)
    (here / "mixes" / "train-tiny-sync.json").write_text(json.dumps(mix))
    cell = "qwen3-tiny.train-tiny-sync"
    (here / "limits" / f"{cell}.json").write_text(
        (here / "limits" / "qwen3-tiny.train-tiny.json").read_text())
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": "qwen3-tiny",
                               "traffic": "train-tiny-sync", "chips": 1,
                               "why": "a CPU test's tiny cell"})
    for m in bench["per_layer"]:
        if "qwen3-4b.train-b2s512-sync" in m["workloads"]:
            m["workloads"].append(cell)
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, err = run_cell(bench_copy, cell, trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_tokens_per_s.sync"}
    assert line["metrics"]["train_tokens_per_s.sync"]["value"] > 0
    rc, line, err = run_cell(bench_copy, cell, trace=0)
    assert rc == 0, err
    assert set(line["metrics"]) == {"peak_host_gib", "setup_s"}
