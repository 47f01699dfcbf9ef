"""The device's idle time put down to the program's own spans.

``repro_torch`` opens spans named ``repro_torch.<name>`` at the
boundaries where its trainer and decoder wait (``repro_torch.core.trace``).
A profiler built with ``profile_all_threads`` records them on every
thread, on the clock of the device activities, so each idle stretch of
the device inside the benchmark's ``portbench.window`` span can be put
down to what the window's own thread was doing then.

:func:`program_idle` reads the profiler's raw events in memory, as
``tracing.reduce`` does, and computes the device's idle intervals the
same way: every device activity clipped to the window, their union the
busy time, its complement the idle gaps.  It touches none of
``reduce``'s readings.
"""

from __future__ import annotations

import torch

import tracing

PROGRAM = "repro_torch."


def _covered(gaps: list[tuple[int, int]],
             intervals: list[tuple[int, int]]) -> int:
    """Nanoseconds of ``gaps`` that the union of ``intervals`` covers."""
    covered = tracing._union(intervals)
    total, i = 0, 0
    for g0, g1 in gaps:                  # both sorted and disjoint
        while i < len(covered) and covered[i][1] <= g0:
            i += 1
        j = i
        while j < len(covered) and covered[j][0] < g1:
            total += min(covered[j][1], g1) - max(covered[j][0], g0)
            j += 1
    return total


def program_idle(prof: torch.profiler.profile) -> dict:
    """``idle_s``: the device's idle seconds in the window.
    ``idle_s_by_span``: for each program span name on the window's thread,
    the idle seconds its spans cover (a nested span's seconds count in
    its parent's too).  ``spans``: for each program span name on any
    thread, its ``count`` and total ``seconds`` inside the window.
    ``device_spans``: device-side events named as program spans (they are
    left out of the busy time, as ``reduce`` leaves out the benchmark's
    own span shadows)."""
    device, spans, window = [], [], []
    device_spans = 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(PROGRAM):
                device_spans += 1
            elif not name.startswith(tracing.PREFIX):
                device.append(tracing._interval(e))
        elif name.startswith(PROGRAM):
            spans.append((*tracing._interval(e), name[len(PROGRAM):],
                          e.start_thread_id()))
        elif name == tracing.PREFIX + tracing.WINDOW:
            window.append((*tracing._interval(e), e.start_thread_id()))
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    w0, w1, thread = window[0]
    busy = tracing._union([(max(a, w0), min(b, w1)) for a, b in device
                           if min(b, w1) > max(a, w0)])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if w1 > t:
        gaps.append((t, w1))
    on_thread: dict[str, list] = {}
    totals: dict[str, dict] = {}
    for a, b, name, tid in spans:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if tid == thread:
            on_thread.setdefault(name, []).append((a, b))
        entry = totals.setdefault(name, {"count": 0, "seconds": 0.0})
        entry["count"] += 1
        entry["seconds"] += (b - a) / 1e9
    return {"idle_s": sum(b - a for a, b in gaps) / 1e9,
            "idle_s_by_span": {n: _covered(gaps, iv) / 1e9
                               for n, iv in sorted(on_thread.items())},
            "spans": dict(sorted(totals.items())),
            "device_spans": device_spans}
