"""Spans from the benchmark's own files, and the reduction of a
``torch.profiler`` trace to what the per-layer metrics read.

Spans are ``record_function`` ranges named ``portbench.<name>`` around
the calls into each layer of the port; the whole measured window is the
span ``portbench.window``.  The reduction reads the profiler's raw events
in memory (no trace file is written): every device activity (kernels,
copies, fills) is clipped to the window, their union is the device's busy
time, its complement the idle gaps, each gap named by the span that
covered most of it on the host.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "portbench."
WINDOW = "window"
TOP = 10
NAME_CHARS = 120


class Spans:
    """``spans(name)`` is a recorded range while tracing, else nothing."""

    def __init__(self, on: bool) -> None:
        self.on = on

    def __call__(self, name: str):
        if self.on:
            return torch.profiler.record_function(PREFIX + name)
        return contextlib.nullcontext()


def profiler() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _interval(e) -> tuple[int, int]:
    t0 = e.start_ns()
    t1 = e.end_ns() if hasattr(e, "end_ns") else t0 + e.duration_ns()
    return t0, t1


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(prof: torch.profiler.profile) -> dict:
    """``busy_s``, ``window_s``, device seconds by kernel name, and the
    ``breakdown`` lists (the ten longest device operations by total, the
    ten longest idle gaps named by the host's span)."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(PREFIX):      # a span's shadow on the device
                continue
            device.append((*_interval(e), name))
        elif name.startswith(PREFIX):
            spans.append((*_interval(e), name[len(PREFIX):]))
    windows = [(a, b) for a, b, n in spans if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    w0, w1 = windows[0]
    by_name: dict[str, int] = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            by_name[name] = by_name.get(name, 0) + (b - a)
    busy = _union(clipped)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if w1 > t:
        gaps.append((t, w1))
    inner = [(a, b, n) for a, b, n in spans if n != WINDOW]

    def host_doing(g0: int, g1: int) -> str:
        best, name = 0, "host"
        for a, b, n in inner:
            overlap = min(b, g1) - max(a, g0)
            if overlap > best:
                best, name = overlap, n
        return name

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernel_s": {n: ns / 1e9 for n, ns in by_name.items()},
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in ops],
        "idle_gaps": [[host_doing(a, b), (b - a) / 1e9] for a, b in longest],
    }


def kernel_seconds(reduced: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(s for n, s in reduced["kernel_s"].items() if fragment in n)
