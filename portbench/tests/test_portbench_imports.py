"""What the harness and the reference load, and when the harness refuses
to run: no JAX, no JAX package, and a reference free of the program."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from conftest import REPO, run_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SHOW = ("print(sorted(n for n in sys.modules "
        "if n.split('.', 1)[0] in {names}), file=sys.stderr)")


def loaded(err: str) -> list:
    return ast.literal_eval(err.strip().splitlines()[-1])  # printed last


def test_a_run_loads_no_jax_and_no_jax_package(bench_copy):
    rc, line, err = run_cell(bench_copy, "qwen3-tiny.decode-tiny",
                             after=SHOW.format(names=set(FORBIDDEN)))
    assert rc == 0, err
    assert line["correct"]
    assert loaded(err) == []
    rc, line, err = run_cell(bench_copy, "qwen3-moe-tiny.train-tiny-routed",
                             after="print(sorted(n for n in sys.modules if "
                                   "n.split('.', 1)[0] == 'repro_torch')[:1],"
                                   " file=sys.stderr)")
    assert rc == 0, err
    assert loaded(err) == ["repro_torch"]   # the port is what runs


def test_a_forbidden_module_stops_the_run(bench_copy):
    rc, line, err = run_cell(bench_copy, "qwen3-tiny.train-tiny",
                             patch="import types; sys.modules['jax'] = "
                                   "types.ModuleType('jax')")
    assert rc != 0 and line is None
    assert "jax" in err


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"repro_torch", *FORBIDDEN}, (path, tops)
    code = ("import sys, torch; sys.path.insert(0, 'portbench'); "
            "from reference import qwen3; "
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen3-4b.train-b2s512", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(bench_copy):
    os.unlink(bench_copy / "src")            # only the benchmark's files
    shutil.rmtree(bench_copy / "portbench" / "__pycache__",
                  ignore_errors=True)
    rc, line, err = run_cell(bench_copy, "qwen3-tiny.train-tiny")
    assert rc != 0 and line is None
