"""The harness is data: a configuration, a traffic mix, a cell and a
per-layer metric are added as new files (and entries in BENCHMARK.json),
and run without an edit to any file the benchmark already has."""

from __future__ import annotations

import json
import re

from conftest import REPO, digest, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_tiny_cells_run_from_new_files_only(bench_copy):
    ours, theirs = digest(REPO), digest(bench_copy)
    ours = {k: v for k, v in ours.items()
            if not k.startswith("portbench/tests/")}
    assert {k: theirs[k] for k in ours} == ours
    (bench_copy / "portbench" / "metrics" / "steps_seen.py").write_text(
        '"""A throwaway metric: the window\'s steps."""\n\n\n'
        'def read(record):\n    return record.get("steps")\n')
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "steps_seen", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "plan executor and streams",
        "moves": "train_tokens_per_s", "workloads": ["qwen3-tiny.train-tiny"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, err = run_cell(bench_copy, "qwen3-tiny.train-tiny", trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert line["metrics"]["steps_seen"]["value"] == line["attempted"] >= 1
    assert line["device"]["window_s"] > 0
    assert list(line)[-1] == "checks"
    rc, line, err = run_cell(bench_copy, "qwen3-tiny.train-tiny", trace=0)
    assert rc == 0, err
    assert set(line["metrics"]) == {"train_tokens_per_s", "peak_host_gib",
                                    "setup_s"}



def test_the_routed_cell_keeps_its_rate_per_layer(bench_copy):
    cell = "qwen3-moe-tiny.train-tiny-routed"
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    layer = {m["name"] for m in bench["per_layer"]
             if cell in m["workloads"]}
    rc, line, err = run_cell(bench_copy, cell, trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) <= layer
    for name in ("train_tokens_per_s.routed", "adam_wait_s.routed",
                 "train_mfu.routed", "expert_fetch_wait_s"):
        assert line["metrics"][name]["value"] > 0, name
    rc, line, err = run_cell(bench_copy, cell, trace=0)
    assert rc == 0, err
    assert set(line["metrics"]) == {"peak_host_gib", "setup_s"}

def test_the_benchmark_file_keeps_to_its_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    here = REPO / "portbench"
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in
                       c["reduced"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (here / "configs" / f"{w['config']}.json").exists()
        mix = json.loads((here / "mixes" / f"{w['traffic']}.json")
                         .read_text())
        assert (here / "drivers" / f"{mix['driver']}.py").exists()
        assert (here / "limits" / f"{w['name']}.json").exists()
        reported = {m["name"] for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in bench["per_layer"]
                 if w["name"] in m["workloads"]]
        assert layer and all(m["moves"] in reported for m in layer)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (here / "metrics" / f"{m['name']}.py").exists()
