"""Spans and timed counters at the boundaries where the offloaded trainer
and decoder wait.

A span is a range in ``torch.profiler``'s own event stream, so it sits on
the clock of the device activities the profiler records beside it.  It is
recorded wherever a profiler records the thread it runs on: every thread
under ``torch.profiler.profile(experimental_config=torch._C._profiler.
_ExperimentalConfig(profile_all_threads=True))``, only the profiler's own
thread otherwise.  With no profiler running a span costs the construction
of one ``_RecordFunctionFast`` (about a microsecond).  There is no switch,
buffer or exporter here: whoever runs the profiler reads the spans.

Every span is named ``repro_torch.<name>`` for a ``<name>`` of
:data:`SPANS`.  What tells two spans of one name apart (the unit, the
step, the store key) goes in keyword values, which the profiler keeps
with ``record_shapes=True`` on its own thread (torch drops them on the
threads ``profile_all_threads`` adds).

Thread and boundary of each span:

* executor: ``train_step``, ``prefill``, ``decode_step``,
  ``open_kv_cache`` (the session's entry points), ``synchronize``,
  ``plan.<op>`` (one per plan op), ``fetch`` (the blocking half of a
  FetchOp), ``optim_gate`` (the wait for the previous step's Adam of a
  unit), ``expert.route_readback`` (a MoE route stage's expert ids read
  back to the host, which decide the expert pages to fetch);
* any thread: ``pool_acquire`` (a pool slot taken for a store read);
* the host Adam stage's thread (the optimizer worker under full overlap,
  the executor otherwise): ``adam.unit`` (one unit's Adam task),
  ``adam.read_wait`` (blocked on a subgroup's staged state),
  ``adam.update`` (the arithmetic), ``adam.commit_prep`` (narrowing and
  write guard before the write-backs are submitted), ``adam.write_wait``
  (the unit's write-backs waited out);
* the optimizer's state-prefetch worker (the stage's thread when
  inline): ``adam.read`` (a subgroup's master, m and v read into the
  staging arena), inside it ``adam.staging_acquire`` (blocked on a free
  staging buffer);
* read pool: ``adam.store_read`` (one store read);
* write-back pool: ``adam.write`` (one store write);
* H2D worker: ``h2d.stage`` (one unit staged), ``swap.wait`` (blocked on a
  store read), ``h2d.copy`` (one host-to-device copy, on any thread that
  copies), inside it on the card ``h2d.copy_wait`` (the wait for the
  copy's event);
* gradient writer: ``grad_write`` (a unit's gradients landed on the
  host), ``overflow_screen`` (its Inf/NaN screen).
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:           # older torch: the slower public range
    _RecordFunctionFast = None

PREFIX = "repro_torch."

PLAN_OPS = ("fetch", "compute", "kv_read", "kv_write", "act_save",
            "act_fetch", "expert_fetch", "expert_release", "grad_write",
            "overflow_check", "optim_step", "release")

SPANS = (
    "train_step", "prefill", "decode_step", "open_kv_cache", "synchronize",
    *(f"plan.{op}" for op in PLAN_OPS),
    "fetch", "optim_gate", "expert.route_readback", "pool_acquire",
    "adam.unit", "adam.read_wait", "adam.update", "adam.commit_prep",
    "adam.write_wait", "adam.read", "adam.staging_acquire",
    "adam.store_read", "adam.write",
    "h2d.stage", "swap.wait", "h2d.copy", "h2d.copy_wait",
    "grad_write", "overflow_screen",
)
_NAMES = frozenset(SPANS)


def span(name: str, **ids):
    """The span ``repro_torch.<name>``, as a context manager; ``ids`` are
    its keyword values (str or int)."""
    if name not in _NAMES:
        raise ValueError(f"{name!r} is not a span of repro_torch.core.trace")
    if _RecordFunctionFast is None:
        return torch.profiler.record_function(PREFIX + name)
    return _RecordFunctionFast(PREFIX + name, [], ids)


def spanned(name: str):
    """Decorator: the function runs inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def timed(stats, counter: str, name: str, **ids):
    """The span ``name``, and the ``perf_counter`` seconds it lasted added
    to ``counter`` through ``stats.add_worker_seconds`` (which locks, so
    any thread may count).  A block that raises counts nothing."""
    t0 = time.perf_counter()
    with span(name, **ids):
        yield
    stats.add_worker_seconds(counter, time.perf_counter() - t0)
