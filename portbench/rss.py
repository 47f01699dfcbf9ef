"""The process's resident-memory peak, sampled on a thread.

A frozen copy of ``chip_smoke.py``'s ``_RssPeak`` (the card machine's
/proc/self/status has ``VmRSS`` but no ``VmHWM``), sampling every 20 ms
from the moment it starts.  ``getrusage``'s ``ru_maxrss`` serves as a
floor only where it rose while the sampler ran: a new process inherits
the high-water mark of the process that forked it.

Imports nothing but the standard library, so ``run.py`` starts it first.
"""

from __future__ import annotations

import resource
import threading

PERIOD_S = 0.02


def vm_rss() -> int:
    """``VmRSS`` of this process, in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS")


def max_rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class RssPeak:
    """The most ``VmRSS`` read between :meth:`start` and :meth:`stop`."""

    def __init__(self) -> None:
        self.peak = 0
        self._maxrss0 = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "RssPeak":
        self._maxrss0 = max_rss()
        self.peak = vm_rss()
        self._thread = threading.Thread(target=self._sample, daemon=True,
                                        name="portbench-rss")
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(PERIOD_S):
            self.peak = max(self.peak, vm_rss())

    def stop(self) -> int:
        """Stop sampling (idempotent); returns the peak in bytes."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
            self.peak = max(self.peak, vm_rss())
            floor = max_rss()
            if floor > self._maxrss0:
                self.peak = max(self.peak, floor)
        return self.peak
