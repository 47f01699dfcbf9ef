"""The Kimi Linear cell's files run as they are.  A tiny copy of
``kimi-linear-48b-a3b.train-b2s4096-paged`` (a dense KDA layer, then KDA,
KDA, MLA, KDA over 16 router experts of which 8 are held, 12 page slots
for 96 expert pages) goes through ``bench.run`` on the CPU, correct, with
every per-layer metric the full cell reports but the device seconds of
KDA, which a CPU run does not have; its driver refuses a port without
KDA at once; two faults in the port's KDA (no decay, no delta
correction) read above ``kda_grad_gap``'s limit and are not correct; the
control and the faults read above the tiny cell's limits, which were set
from CPU readings at the seeds used here (the port's bf16 below
them)."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from conftest import run_cell

FULL = "kimi-linear-48b-a3b.train-b2s4096-paged"
CELL = "kimi-tiny.train-tiny-kimi"
TINY_CONFIG = dict(
    name="kimi-tiny", hidden_size=64, intermediate_size=96,
    moe_intermediate_size=24, router_experts=16, num_experts=8,
    held_experts=[0, 8], num_experts_per_token=4, num_attention_heads=4,
    num_key_value_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, kv_lora_rank=32, vocab_size=512,
    linear_attn_config={"full_attn_layers": [4], "head_dim": 16,
                        "kda_layers": [1, 2, 3, 5], "num_heads": 4,
                        "short_conv_kernel_size": 4})
TINY_MIX = dict(seq=96, expert_page_slots=12)
# CPU readings, seeds 11-14 / 11-13, the full cell's numbers: the port's
# grad and kda gaps 0.12-0.34 (block_000's a_log, a sum over every token
# and channel of a head), expert median 0.015-0.020, dense change
# 0.024-0.032; the fp8 control 0.19-0.60, 0.046-0.055, 0.032-0.049; the
# port without decay or without the delta correction at seed 11: kda gap
# 1.0 and 0.74.  The expert change median: the port 0.0059-0.0079 (seeds
# 11-14), the fp8 control 0.0106-0.0124, half a batch 0.0128-0.0131, the
# faults 0.0105-0.0154, unchanged 1.0 (seeds 11-13)
LIMITS = {"grad_norm_gap": 0.5, "dense_grad_gap": 0.5,
          "expert_grad_gap_median": 0.03, "kda_grad_gap": 0.5,
          "dense_change_gap": 0.3, "expert_change_gap_median": 0.01}

# a port whose configs have no KDA (the parent of this cell)
NO_KDA = """
import repro_torch.configs.base as base
del base.KDAConfig
"""
NO_DECAY = """
import torch
from repro_torch.models import kda
whole = kda.chunked_delta_rule
kda.chunked_delta_rule = lambda q, k, v, g, beta: whole(q, k, v, g * 0, beta)
"""
NO_DELTA = """
import torch
from repro_torch.models import kda

def no_delta(q, k, v, g, beta):
    b, s, h, dk = k.shape
    state = k.new_zeros((b, h, dk, v.shape[-1]))
    outs = []
    for t in range(s):
        state = state * torch.exp(g[:, t])[..., None] + \\
            beta[:, t, :, None, None] * k[:, t][..., None] * \\
            v[:, t][..., None, :]
        outs.append(torch.einsum("bhcv,bhc->bhv", state, q[:, t])
                    * dk ** -0.5)
    return torch.stack(outs, dim=1)

kda.chunked_delta_rule = no_delta
"""


@pytest.fixture
def kimi_copy(bench_copy):
    """The benchmark copy with the tiny Kimi Linear cell added as new
    files and entries, reporting what the full cell reports."""
    here = bench_copy / "portbench"
    cfg = json.loads((here / "configs" / "kimi-linear-48b-a3b.json")
                     .read_text())
    cfg.update(TINY_CONFIG)
    (here / "configs" / "kimi-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "mixes" / "train-b2s4096-paged.json")
                     .read_text())
    mix.update(TINY_MIX)
    (here / "mixes" / "train-tiny-kimi.json").write_text(json.dumps(mix))
    (here / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "kimi-tiny",
                               "traffic": "train-tiny-kimi", "chips": 1,
                               "why": "a CPU test's tiny cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if FULL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_copy


def test_the_tiny_cell_reports_every_new_metric(kimi_copy):
    bench = json.loads((kimi_copy / "BENCHMARK.json").read_text())
    layer = {m["name"] for m in bench["per_layer"] if FULL in m["workloads"]}
    assert len(layer) == 12
    rc, line, err = run_cell(kimi_copy, CELL, trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    # the device seconds of KDA and of the overflow screen's kernel are a
    # card's readings only
    card = {"kda_device_s.kimi", "overflow_check_roofline.kimi"}
    assert set(line["metrics"]) == layer - card, err
    shares = {"expert_drop_share.kimi", "pinned_slack_share.kimi"}
    for name in layer - card - shares:
        assert line["metrics"][name]["value"] > 0, name
    for name in shares:
        assert 0 <= line["metrics"][name]["value"] <= 100, name
    rc, line, err = run_cell(kimi_copy, CELL, trace=0)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"peak_host_gib", "setup_s"}


def test_a_port_without_kda_fails_at_once(kimi_copy):
    t0 = time.perf_counter()
    rc, line, err = run_cell(kimi_copy, CELL, patch=NO_KDA)
    assert rc != 0 and line is None
    assert "KDAConfig" in err
    assert "weights drawn" not in err
    assert time.perf_counter() - t0 < 60


@pytest.mark.parametrize("fault", [NO_DECAY, NO_DELTA],
                         ids=["no_decay", "no_delta"])
def test_a_kda_fault_is_not_correct(kimi_copy, fault):
    rc, line, err = run_cell(kimi_copy, CELL, patch=fault)
    assert rc == 0, err
    assert not line["correct"], line["checks"]
    check = line["checks"]["kda_grad_gap"]
    assert check["value"] > check["limit"], line["checks"]


def test_the_control_and_the_faults_read_above_the_limits(kimi_copy):
    proc = subprocess.run(
        [sys.executable, "portbench/control_kimi_linear.py", "--workload",
         CELL, "--seeds", "11,12,13", "--device", "cpu"],
        cwd=kimi_copy, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(r) for r in proc.stdout.strip().splitlines()]
    assert len(rows) == 3
    for row in rows:
        for kind in ("control", "half_batch", "unchanged", "no_decay",
                     "no_delta"):
            assert any(row[kind][k] > LIMITS[k] for k in LIMITS), (kind, row)
