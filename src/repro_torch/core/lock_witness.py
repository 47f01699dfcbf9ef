"""Dynamic lock-order witness: records the lock-acquisition graph while
tests run and fails on a cycle (a potential deadlock), complementing the
static checkers in :mod:`tools.analyze`.

A copy of ``src/repro/core/lock_witness.py`` for the port: it patches
``threading`` only, so it holds no framework.

The offload pipeline holds several locks across five thread roles
(executor, H2D stager, gradient writer, optimizer worker, state-prefetch
worker) plus the store's aio pools.  The static lock-discipline checkers
prove each *field* is accessed under its lock; they cannot prove the
*order* locks nest in is globally consistent.  This witness closes that
gap dynamically: wrap ``threading.Lock``/``threading.Condition`` for the
duration of a test run (``pytest --lock-witness``), record every edge
``A → B`` ("B was acquired while A was held"), and fail the moment the
edge set develops a cycle — i.e. two code paths nest the same two locks
in opposite orders, which deadlocks under the right interleaving even if
this run got lucky.

Locks are keyed by *creation site* (``file:line`` of the constructor
call), so every ``SpillableKVCache._lock`` across all instances is one
node — an AB/BA inversion between two *instances* of the same pair of
classes is still an inversion.  Same-site edges (two instances created
on the same line, e.g. a lock per pool in a list comprehension) are
ignored: ordering within a homogeneous group needs an instance-level
protocol, not a site-level one, and flagging it would false-positive
every ``[Lock() for _ in ...]``.

Usage::

    from repro_torch.core import lock_witness
    lock_witness.install()
    try:
        ...  # run the workload
        lock_witness.check()     # raises LockOrderError on a cycle
    finally:
        lock_witness.uninstall()

or via the pytest flag (see ``tests/conftest.py``), which installs the
reference's copy for the whole session and checks after every test; both
copies swap the same ``threading`` factories, so the flag witnesses the
port's locks too.
"""

from __future__ import annotations

import threading
import traceback
from collections import defaultdict

__all__ = ["LockOrderError", "WitnessLock", "install", "uninstall",
           "check", "reset", "edges", "installed"]

_real_lock = threading.Lock
_real_condition = threading.Condition

# ---------------------------------------------------------------------------
# Global witness state.  The edge map is guarded by a REAL lock (created
# before install() swaps the factories) so the witness never recurses
# into itself.
# ---------------------------------------------------------------------------

_state_lock = _real_lock()
_edges: dict[str, dict[str, tuple]] = {}   # site -> {site -> witness stack}
_installed = False
_held = threading.local()                  # per-thread stack of held sites


class LockOrderError(AssertionError):
    """Two code paths nest the same locks in opposite orders."""


def _creation_site() -> str:
    """file:line of the frame that called Lock()/Condition(), skipping
    frames inside this module."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename != __file__:
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _record_acquire(site: str) -> None:
    stack = _held_stack()
    if stack:
        top = stack[-1]
        if top != site:
            with _state_lock:
                inner = _edges.setdefault(top, {})
                if site not in inner:
                    # remember one witness path per edge for the report
                    inner[site] = tuple(traceback.format_stack()[-8:-2])
    stack.append(site)


def _record_release(site: str) -> None:
    stack = _held_stack()
    # release order need not be LIFO (explicit lock.release() patterns
    # like SpillableKVCache._spill drop the lock mid-scope): remove the
    # most recent matching entry
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == site:
            del stack[i]
            return


class WitnessLock:
    """A ``threading.Lock`` stand-in that reports acquisitions to the
    witness graph.  Plain object (not a subclass — ``threading.Lock`` is
    a factory function, not a type); exposes the full lock protocol, so
    ``threading.Condition`` accepts it as its underlying lock."""

    __slots__ = ("_lock", "_site")

    def __init__(self, site: str | None = None) -> None:
        self._lock = _real_lock()
        self._site = site or _creation_site()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            _record_acquire(self._site)
        return got

    def release(self) -> None:
        self._lock.release()
        _record_release(self._site)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock site={self._site!r} {self._lock!r}>"


def _witness_condition(lock=None):
    """Condition factory: a Condition over a WitnessLock, so ``with cv:``
    edges are recorded too.  ``wait()`` works unchanged — Condition only
    needs acquire/release (and uses its own waiter queue), and the
    witness stack is per-thread, so the release inside wait() correctly
    pops this thread's entry."""
    if lock is None:
        lock = WitnessLock(_creation_site())
    return _real_condition(lock)


def install() -> None:
    """Swap ``threading.Lock``/``threading.Condition`` for witnessing
    versions.  Locks created *before* install are invisible — install
    early (conftest does it at session start, before any repro_torch module
    instantiates)."""
    global _installed
    with _state_lock:
        if _installed:
            return
        _installed = True
    threading.Lock = WitnessLock
    threading.Condition = _witness_condition


def uninstall() -> None:
    global _installed
    with _state_lock:
        if not _installed:
            return
        _installed = False
    threading.Lock = _real_lock
    threading.Condition = _real_condition


def installed() -> bool:
    with _state_lock:
        return _installed


def reset() -> None:
    """Drop every recorded edge (NOT the currently-held stacks)."""
    with _state_lock:
        _edges.clear()


def edges() -> dict[str, set[str]]:
    """Snapshot of the acquisition graph: held-site -> {acquired-site}."""
    with _state_lock:
        return {a: set(bs) for a, bs in _edges.items()}


def check() -> None:
    """Raise :class:`LockOrderError` if the acquisition graph has a cycle.

    A cycle A → B → ... → A means some thread acquired B while holding A
    and some (other) run acquired A while holding B — the classic
    inversion that deadlocks when both paths run concurrently."""
    with _state_lock:
        graph = {a: list(bs) for a, bs in _edges.items()}
        witnesses = {(a, b): w for a, bs in _edges.items()
                     for b, w in bs.items()}
    # iterative DFS with colors; report the first cycle found
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[str, int] = defaultdict(int)
    parent: dict[str, str] = {}
    for root in graph:
        if color[root] != WHITE:
            continue
        stack = [(root, iter(graph.get(root, ())))]
        color[root] = GRAY
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == GRAY:
                    # unwind the cycle nxt -> ... -> node -> nxt
                    cycle = [node]
                    while cycle[-1] != nxt:
                        cycle.append(parent[cycle[-1]])
                    cycle.reverse()
                    cycle.append(nxt)
                    pairs = list(zip(cycle, cycle[1:], strict=False))
                    lines = [f"lock-order cycle: "
                             f"{' -> '.join(s.rsplit('/', 1)[-1] for s in cycle)}"]
                    for a, b in pairs:
                        lines.append(f"\n  {b} acquired while holding {a}; "
                                     f"witness:")
                        lines.extend("    " + ln.rstrip() for ln in
                                     witnesses.get((a, b), ()))
                    raise LockOrderError("\n".join(lines))
                if color[nxt] == WHITE:
                    color[nxt] = GRAY
                    parent[nxt] = node
                    stack.append((nxt, iter(graph.get(nxt, ()))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
