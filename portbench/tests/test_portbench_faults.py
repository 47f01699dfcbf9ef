"""``correct`` comes out false when the timed path is broken underneath a
whole run (the harness's look for a card skipped), once for each fault a
cell can have, and true when nothing is broken; the fp8 control, put in
the port's place, reads above the cell's limits.  The cells are the tiny
ones of ``conftest.py`` on the CPU."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import run_cell

TRAIN = ["qwen3-tiny.train-tiny", "qwen3-moe-tiny.train-tiny-routed"]
DECODE = "qwen3-tiny.decode-tiny"

# the optimizer's arithmetic does nothing: every step returns the state
# it was given
UNCHANGED = """
import repro_torch.core.optimizer as optimizer
optimizer.adam_update = lambda *args, **kwargs: None
"""
# the step sees half of each batch and takes its mean over the rest
HALF_BATCH = """
from repro_torch.core.session import OffloadSession
whole = OffloadSession.train_step
OffloadSession.train_step = lambda self, tokens, labels: whole(
    self, tokens[:len(tokens) // 2], labels[:len(labels) // 2])
"""
# one served token altered where the step produces it
ALTERED_TOKEN = """
from repro_torch.core.session import OffloadSession
step = OffloadSession.decode_step
def altered(self, kv, tokens):
    logits = step(self, kv, tokens)
    logits[0, 7] = logits[0].max() + 1.0
    return logits
OffloadSession.decode_step = altered
"""


@pytest.mark.parametrize("workload", TRAIN + [DECODE])
def test_a_sound_run_is_correct(bench_copy, workload):
    rc, line, err = run_cell(bench_copy, workload)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [UNCHANGED, HALF_BATCH],
                         ids=["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(bench_copy, workload, fault):
    rc, line, err = run_cell(bench_copy, workload, patch=fault)
    assert rc == 0, err
    assert not line["correct"], line["checks"]


def test_an_altered_token_is_not_correct(bench_copy):
    rc, line, err = run_cell(bench_copy, DECODE, patch=ALTERED_TOKEN)
    assert rc == 0, err
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", TRAIN + [DECODE])
def test_the_control_and_the_faults_read_above_the_limits(bench_copy,
                                                          workload):
    proc = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", workload,
         "--seeds", "11,12,13", "--device", "cpu"],
        cwd=bench_copy, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    limits = json.loads((bench_copy / "portbench" / "limits" /
                         f"{workload}.json").read_text())
    for row in map(json.loads, proc.stdout.strip().splitlines()):
        for kind in set(row) - {"workload", "seed", "seconds"}:
            assert any(row[kind][k] > limits[k] for k in limits), (kind, row)
