"""``program_trace.program_idle`` on stub event streams, and
``tracing.reduce`` unmoved by the program's spans beside its own."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import REPO

sys.path.insert(0, str(REPO / "portbench"))

import program_trace  # noqa: E402
import tracing  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, WORKER = 1, 2
MS = 1_000_000


class Event:
    """The few methods of a kineto event the reductions call."""

    def __init__(self, name, a, b, device=CPU, thread=MAIN):
        self._name, self._a, self._b = name, a * MS, b * MS
        self._device, self._thread = device, thread

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def start_thread_id(self):
        return self._thread


def prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


# the benchmark's own window and spans around one step, and the device:
# busy 0-10 and 60-70 ms of a 0-100 ms window, so idle 10-60 and 70-100
PARENT = [
    Event("portbench.window", 0, 100),
    Event("portbench.train_step", 0, 70),
    Event("portbench.synchronize", 70, 100),
    Event("portbench.train_step", 5, 65, device=CUDA),   # a span's shadow
    Event("kernel_a", 0, 10, device=CUDA),
    Event("Memcpy HtoD (Pinned -> Device)", 60, 70, device=CUDA),
]
PROGRAM = [
    Event("repro_torch.train_step", 0, 70),
    Event("repro_torch.optim_gate", 20, 50),
    Event("repro_torch.fetch", 55, 65),
    Event("repro_torch.synchronize", 70, 100),
    # worker threads: not the window's thread
    Event("repro_torch.adam.update", 10, 60, thread=WORKER),
    Event("repro_torch.optim_gate", 0, 100, thread=WORKER),
]


def test_a_device_gap_under_the_gate_counts():
    out = program_trace.program_idle(prof(PARENT + PROGRAM))
    assert out["idle_s"] == pytest.approx(0.080)
    by = out["idle_s_by_span"]
    assert by["optim_gate"] == pytest.approx(0.030)       # 20-50
    assert by["fetch"] == pytest.approx(0.005)            # 55-60
    assert by["synchronize"] == pytest.approx(0.030)      # 70-100
    assert by["train_step"] == pytest.approx(0.050)       # 10-60


def test_a_span_on_another_thread_does_not_count():
    out = program_trace.program_idle(prof(PARENT + PROGRAM))
    assert "adam.update" not in out["idle_s_by_span"]
    # the worker's own gate adds nothing to the window thread's
    assert out["idle_s_by_span"]["optim_gate"] == pytest.approx(0.030)
    # but every thread's spans are counted and timed
    assert out["spans"]["optim_gate"] == {"count": 2,
                                          "seconds": pytest.approx(0.130)}
    assert out["spans"]["adam.update"]["seconds"] == pytest.approx(0.050)


def test_the_benchmark_s_own_spans_are_ignored():
    out = program_trace.program_idle(prof(PARENT + PROGRAM))
    assert not [n for n in out["spans"] if n.startswith("portbench")]
    assert out["device_spans"] == 0
    # the benchmark's span shadow on the device is not busy time
    assert out["idle_s"] == pytest.approx(0.080)
    assert program_trace.program_idle(prof(PARENT)) == {
        "idle_s": pytest.approx(0.080), "idle_s_by_span": {}, "spans": {},
        "device_spans": 0}


def test_a_program_span_s_device_shadow_is_not_busy_time():
    shadow = Event("repro_torch.optim_gate", 20, 50, device=CUDA)
    out = program_trace.program_idle(prof(PARENT + PROGRAM + [shadow]))
    assert out["device_spans"] == 1
    assert out["idle_s"] == pytest.approx(0.080)


def test_the_window_must_be_there_once():
    with pytest.raises(RuntimeError, match="0 window spans"):
        program_trace.program_idle(prof(PROGRAM))


def test_reduce_reads_the_same_with_the_program_s_spans():
    before = tracing.reduce(prof(PARENT))
    assert before["busy_s"] == pytest.approx(0.020)
    assert before["window_s"] == pytest.approx(0.100)
    assert before["idle_gaps"] == [["train_step", pytest.approx(0.050)],
                                   ["synchronize", pytest.approx(0.030)]]
    assert tracing.reduce(prof(PARENT + PROGRAM)) == before
