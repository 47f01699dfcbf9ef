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
  host), ``overflow_screen`` (its Inf/NaN screen);
* executor, in a block's apply: ``kda.fwd`` (one chunked KDA forward,
  the backward's recompute of the block included) and ``kda.bwd`` (its
  backward over the kept graph).

Beside the spans, a :class:`KDALedger` counts the KDA mixer's chunked
forwards (``kda_calls``), their tokens (``kda_tokens``) and the device
seconds of ``kda.fwd`` and ``kda.bwd`` (``kda_device_seconds``).  Each
session owns one and makes it its executor's ledger (:func:`counting`)
while it runs a plan; its ``overlap_snapshot()`` carries the counters.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
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
    "grad_write", "overflow_screen", "kda.fwd", "kda.bwd",
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


class KDALedger:
    """The KDA mixer's chunked forwards, their tokens and the device
    seconds of its spans.  :meth:`timed` opens a span and, on the card,
    records CUDA events on the current (compute) stream around it; a pair
    of events is summed once both have completed, with no synchronisation
    added (the pairs still running wait for a later :meth:`snapshot`).
    On the CPU only the calls and tokens move."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.calls = 0
        self.tokens = 0
        self.device_seconds = 0.0
        self._pending: collections.deque = collections.deque()

    @contextlib.contextmanager
    def timed(self, name: str, device, *, tokens: int | None = None):
        """The span ``name``; ``tokens`` (where given) counts one call of
        that many tokens."""
        cuda = torch.device(device).type == "cuda"
        with span(name):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            yield
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
        with self._lock:
            if tokens is not None:
                self.calls += 1
                self.tokens += tokens
            if cuda:
                self._pending.append((start, end))
            self._settle()

    def _settle(self) -> None:
        while self._pending and self._pending[0][1].query():
            start, end = self._pending.popleft()
            self.device_seconds += start.elapsed_time(end) / 1e3

    def snapshot(self) -> dict:
        with self._lock:
            self._settle()
            return {"kda_calls": self.calls, "kda_tokens": self.tokens,
                    "kda_device_seconds": self.device_seconds}


_counting = threading.local()


@contextlib.contextmanager
def counting(ledger: KDALedger):
    """Make ``ledger`` this thread's KDA ledger inside the block."""
    outer = getattr(_counting, "ledger", None)
    _counting.ledger = ledger
    try:
        yield
    finally:
        _counting.ledger = outer


def kda_ledger() -> KDALedger | None:
    """This thread's KDA ledger (:func:`counting`), or None."""
    return getattr(_counting, "ledger", None)
