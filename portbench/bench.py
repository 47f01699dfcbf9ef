"""The harness: resolve a cell by name, run its driver, print the result.

Everything is found by name, so a later cell, configuration, traffic mix
or per-layer metric is new files only:

* ``BENCHMARK.json`` at the checkout's root: the cell (its ``config``
  and ``traffic``), the end-to-end metrics and the per-layer metrics;
* ``portbench/configs/<config>.json``: the model configuration as run;
* ``portbench/mixes/<traffic>.json``: the traffic mix, which names its
  driver;
* ``portbench/drivers/<driver>.py``: the entry path; ``run(ctx)``
  returns what :func:`result` turns into the line;
* ``portbench/metrics/<metric>.py``: one per-layer metric;
  ``read(record)`` returns a number, or None where it finds nothing;
* ``portbench/limits/<cell>.json``: each number the cell compares with
  the reference, and its limit.

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window
seconds, and the breakdown.  ``correct`` holds when every compared number
is within its limit; the numbers and limits are the line's last key and
the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names the run must not hold: JAX and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    driver: object
    readers: dict = field(default_factory=dict)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with every file it names."""
    here = root / "portbench"
    bench = read_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if len(found) != 1:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    config = read_json(here / "configs" / f"{w['config']}.json")
    mix = read_json(here / "mixes" / f"{w['traffic']}.json")
    limits = read_json(here / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    driver = load_module(here / "drivers" / f"{mix['driver']}.py",
                         f"portbench_driver_{mix['driver']}")
    readers = {m["name"]: load_module(here / "metrics" / f"{m['name']}.py",
                                      f"portbench_metric_{m['name']}")
               for m in layer}
    return Cell(workload, w["chips"], config, mix, limits, e2e, layer,
                driver, readers)


@dataclass
class Context:
    """What a driver is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    t_start: float          # perf_counter at process start
    rss: object             # rss.RssPeak, sampling since process start
    spans: object           # tracing.Spans

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def log(self, msg: str) -> None:
        print(f"[portbench {time.perf_counter() - self.t_start:8.2f}s] "
              f"{msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number the cell's limits name beside its limit; correct when
    each is a finite number within it."""
    missing = sorted(set(limits) - set(numbers))
    if missing or not limits:
        raise KeyError(f"limits {sorted(limits)} name numbers the run did "
                       f"not compute: {missing}")
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in sorted(limits)}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def result(cell: Cell, out: dict, trace: bool) -> dict:
    """The result line's object from a driver's output."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    correct, checks = judge(out["numbers"], cell.limits)
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(out["device"])}
    if trace:
        reduced = out["record"]["trace"]
        line["device"]["busy_s"] = reduced["busy_s"]
        line["device"]["window_s"] = reduced["window_s"]
        line["breakdown"] = {"device_ops": reduced["device_ops"],
                             "idle_gaps": reduced["idle_gaps"]}
    line["checks"] = checks           # last, as the contract asks
    return line


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv: list[str], *, t_start: float, rss, device=None) -> dict:
    """One run; returns the result line's object.  ``device`` None means
    the card, which must be there; tests pass a CPU device."""
    import torch

    import tracing

    args = parse(argv)
    t_torch = time.perf_counter() - t_start
    cell = load_cell(args.workload)
    t_cell = time.perf_counter() - t_start
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{args.workload} needs {cell.chips} cards, "
                             f"this machine has "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device(device), t_start, rss,
                  tracing.Spans(bool(args.trace)))
    ctx.log(f"{cell.name}: config {cell.config['name']}, driver "
            f"{cell.mix['driver']}, seed {args.seed}, {args.seconds} s, "
            f"trace {args.trace}, device {ctx.device}; torch imported at "
            f"{t_torch:.2f} s, the cell and the port at {t_cell:.2f} s")
    out = cell.driver.run(ctx)
    ctx.log(f"numbers not compared in this cell: "
            f"{ {k: v for k, v in out['numbers'].items() if k not in cell.limits} }")
    return result(cell, out, bool(args.trace))


def main(argv: list[str], *, t_start: float, rss, device=None) -> int:
    line = run(argv, t_start=t_start, rss=rss, device=device)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
