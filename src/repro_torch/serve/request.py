"""Request lifecycle dataclasses for the continuous-batching front-end.

A :class:`Request` is one prompt → greedy-completion job moving through
``QUEUED → ACTIVE → DONE`` (or ``QUEUED → REFUSED`` when the KV-page
admission check says its prompt could never stream its own attended
window).  The scheduler stamps :class:`RequestMetrics` with engine-clock
times as the request crosses each boundary; derived latencies (queue wait,
time-to-first-token, decode tokens/s) are properties so reports never
carry stale copies.

A copy of ``src/repro/serve/request.py`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class RequestState(Enum):
    QUEUED = "queued"  # arrived, waiting for a slot / admission
    ACTIVE = "active"  # holds a batch slot, prefilled or decoding
    DONE = "done"  # retired: EOS, length cap, or max_new reached
    REFUSED = "refused"  # terminal: prompt pages cannot be streamed


@dataclass
class RequestMetrics:
    """Engine-clock stamps (seconds since the engine's run() started).

    ``arrival`` is when the request became visible to the scheduler;
    ``admitted_at`` when it won a batch slot; ``first_token_at`` when its
    prefill emitted the first greedy token; ``finished_at`` when it
    retired."""

    arrival: float = 0.0
    admitted_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None
    tokens_out: int = 0

    @property
    def queue_wait_s(self) -> float | None:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.arrival

    @property
    def ttft_s(self) -> float | None:
        """Arrival → first token (the serving-latency headline)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def decode_tokens_per_s(self) -> float | None:
        """Emitted tokens over the request's slot-holding time."""
        if self.finished_at is None or self.admitted_at is None:
            return None
        dt = self.finished_at - self.admitted_at
        return self.tokens_out / dt if dt > 0 else None


@dataclass
class Request:
    """One serving job: prompt ids + a greedy-decode budget.

    ``arrival`` is the request's offered arrival time on the engine clock
    (0.0 = available immediately); the scheduler will not see it earlier.
    ``eos_token`` stops decode early when emitted (the emitted EOS is kept
    in the output).  ``max_new_tokens`` caps emission; the engine also
    retires a request whose cache would exceed the spec's ``max_seq``.
    """

    rid: str
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float = 0.0
    eos_token: int | None = None
    state: RequestState = RequestState.QUEUED
    slot: int | None = None
    output: list[int] = field(default_factory=list)
    metrics: RequestMetrics = field(default_factory=RequestMetrics)

    def __post_init__(self) -> None:
        arr = np.asarray(self.prompt)
        if arr.ndim != 1 or arr.size < 1:
            raise ValueError(
                f"request {self.rid}: prompt must be a "
                f"non-empty 1-D token array, got {arr.shape}"
            )
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(
                f"request {self.rid}: prompt must hold integer "
                f"token ids, got {arr.dtype}"
            )
        if int(arr.min()) < 0:
            raise ValueError(f"request {self.rid}: negative token ids")
        self.prompt = np.ascontiguousarray(arr, dtype=np.int32)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be "
                f">= 1, got {self.max_new_tokens}"
            )
        self.metrics.arrival = float(self.arrival)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])
