"""The examples over the PyTorch port (``examples/torch_*.py``) and
``experiments/torch_summarize.py`` run on the CPU with small arguments
and print their reference's lines.  ``torch_quickstart.py`` computes what
``quickstart.py`` does from the same inputs, so the two print the same
four result lines."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCHS

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script: str, *args: str, cwd=None) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(ROOT / script), *args],
                         capture_output=True, text=True, env=env,
                         cwd=cwd or ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_quickstart_prints_the_reference_s_lines():
    port = _run("examples/torch_quickstart.py", "--device", "cpu")
    ref = _run("examples/quickstart.py")
    assert port == ref
    assert port[-1] == "quickstart OK"


def test_finetune_runs_both_policies():
    lines = _run("examples/torch_finetune_offloaded.py", "--device", "cpu",
                 "--steps", "2", "--policy", "both", "--layers", "1",
                 "--vocab", "512", "--seq-len", "32", "--batch", "2")
    text = "\n".join(lines)
    assert [ln for ln in lines if ln.startswith("===")] == [
        "=== policy: zero-infinity (state dtype float32) ===",
        "=== policy: memascend (state dtype float32) ==="]
    for pattern in (r"^params: [\d.]+M  pool: .*  flat buffer: .*  "
                    r"lookahead: 2  device: cpu$",
                    r"^step    1  loss [\d.]+  scale 1  opt-io .*/step  "
                    r"fetch-wait \d+ms  \d+ tok/s$",
                    r"^peak host memory: ", r"^pool fragmentation: ",
                    r"^SSD io: written .*, read "):
        assert len(re.findall(pattern, text, re.M)) == 2, pattern
    losses = re.findall(r"^step    1  loss ([\d.]+)", text, re.M)
    assert losses[0] == losses[1]       # the same step-1 loss either way


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b"])
def test_serve_decode_on_reduced_archs(arch):
    lines = _run("examples/torch_serve_decode.py", "--device", "cpu",
                 "--arch", arch, "--batch", "2", "--prompt-len", "4",
                 "--new-tokens", "4")
    cfg = ARCHS[arch].reduced()
    assert lines[0] == (f"arch {arch} (reduced: {cfg.n_layers}L "
                        f"d={cfg.d_model} vocab={cfg.vocab}, "
                        f"family={cfg.family})")
    assert re.match(r"generated \(2, 4\) tokens in [\d.]+s", lines[1])
    assert lines[2].startswith("  request 0: [")
    assert lines[-1] == "serve OK"


@pytest.mark.parametrize("extra", [[], ["--no-cache"],
                                   ["--requests", "3"]],
                         ids=["cached", "no-cache", "requests"])
def test_serve_offloaded_decode_zero_infinity(extra):
    lines = _run("examples/torch_serve_offloaded_decode.py", "--device",
                 "cpu", "--policy", "zero-infinity", "--batch", "2",
                 "--new-tokens", "4", *extra)
    text = "\n".join(lines)
    assert lines[0].startswith("policy zero-infinity  device cpu  "
                               "lookahead 2  pool ")
    assert lines[-1] == "offloaded serve OK"
    if extra[:1] == ["--requests"]:
        assert text.count(" [done] ") == 3
        assert re.search(r"^served 3/3 requests \(0 refused\)", text, re.M)
    else:
        assert re.search(r"^generated \(2, 4\) tokens in ", text, re.M)
        assert re.search(r"^fetches: \d+  prefetch hits: \d+", text, re.M)
        assert ("kv: dirty spills" in text) == (not extra)


def _record(**over):
    """A dry-run record as ``launch.dryrun.lower_pair`` writes it (the
    keys the tables read; numbers made up)."""
    rec = {"arch": "qwen3-4b", "shape": "train_4k", "status": "ok",
           "kind": "train", "mesh": "1", "n_chips": 1,
           "lower_seconds": 12.5, "compile_seconds": 0.0,
           "cost": {"flops": 3.0e16, "bytes accessed": 8.0e14,
                    "transcendentals": 1.0e12},
           "collectives": {"bytes": {}, "counts": {}, "total_bytes": 0},
           "memory": {"argument_size_in_bytes": 8 << 30,
                      "temp_size_in_bytes": 40 << 30,
                      "output_size_in_bytes": 8 << 30}}
    rec.update(over)
    return rec


def test_summarize_splices_the_port_s_tables(tmp_path):
    (tmp_path / "h100").mkdir()
    (tmp_path / "h100" / "qwen3-4b__train_4k.json").write_text(
        json.dumps(_record()))
    (tmp_path / "h100" / "qwen3-4b__long_500k.json").write_text(
        json.dumps({"arch": "qwen3-4b", "shape": "long_500k",
                    "status": "skipped", "reason": "full attention"}))
    exp = tmp_path / "EXPERIMENTS.md"
    exp.write_text("# Experiments\n\n<!-- DRYRUN-TABLE -->\n\n---\n\n"
                   "<!-- ROOFLINE-TABLE -->\n\n---\nend\n")
    for _ in range(2):      # a second run replaces the first's tables
        lines = _run("experiments/torch_summarize.py", "--out",
                     str(tmp_path), "--experiments", str(exp))
        assert lines == ["EXPERIMENTS.md updated"]
        text = exp.read_text()
        assert text.count("### Dry-run — h100") == 1
        assert text.count("### Roofline — one NVIDIA H100") == 1
        assert re.search(r"^\| qwen3-4b \| train_4k \| train \| 12 \| "
                         r"8\.00 \| 40\.0 \| 3\.00e\+16 \| 0/0/0/0/0 \| ok \|$",
                         text, re.M)
        assert "| qwen3-4b | long_500k | — |" in text
        assert re.search(r"^\| qwen3-4b \| train_4k \| [\d.e+-]+ \| ", text[
            text.index("### Roofline"):], re.M)
        assert text.endswith("---\nend\n")
