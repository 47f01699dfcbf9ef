"""Speculative decoding over the weight-streamed serve path.

The economics are different from GPU speculative decoding.  On an
SSD-offloaded host the per-step cost is dominated by streaming every
block's weights through the pinned pool — a cost that is *flat* in the
number of query positions.  Verifying a K-token draft window in one
streamed pass therefore prices K tokens at roughly one token's weight
traffic; any accepted draft token is a whole block-stream round saved.
Even modest acceptance rates pay, and a *free* draft source is enough.

Three pieces:

* :class:`DraftSource` — the draft protocol, ``propose(context, n)``.
  Pluggable: anything that guesses continuation tokens works (a small
  resident model, a lookup table, ...).  Rejected guesses cost only the
  marginal query positions, never correctness.
* :class:`NGramDraft` — the built-in self-drafting source: suffix n-gram
  lookup over the request's own prompt + emitted tokens.  Free (no second
  model to stream), and effective exactly where generation is locally
  repetitive (code, structured text, extraction-style prompts).
* :class:`SpecStats` — accept/commit bookkeeping for one generation or
  serving run (see docs/METRICS.md: ``accepted_per_step``,
  ``spec_overhead_s``).

Greedy output equals plain decoding: the verify pass
(:meth:`~repro_torch.core.session.OffloadSession.verify_step`) reproduces
the sequential step's logits bitwise at every window position, and the
host commits exactly the prefix the sequential argmax chain would have
produced.  Drafting quality affects *speed only*.  The port projects each
window position as its own (batch, 1) product, so the committed K/V are
bitwise the step's too.

A copy of ``src/repro/serve/spec.py`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class DraftSource(Protocol):
    """Anything that proposes draft continuation tokens.

    ``propose`` receives the request's full visible context — prompt plus
    every token emitted so far, *including* the pending token whose K/V
    has not landed yet — and returns up to ``n`` guessed continuation ids
    as a 1-D integer array (possibly empty, never longer than ``n``).
    Guesses are free to be wrong; the verify pass rejects them at the
    cost of a wasted query position, never at the cost of output drift.
    """

    def propose(self, context: np.ndarray, n: int) -> np.ndarray: ...


class NGramDraft:
    """Self-drafting via suffix n-gram lookup over the request's context.

    Takes the last ``gram`` tokens as a key, scans the context backwards
    for that key's most recent earlier occurrence, and proposes the
    tokens that followed it.  The most recent match wins — local
    repetition (the common case in code and structured output) beats a
    stale early match.  No match, no draft: the round degenerates to a
    plain single-token step.
    """

    def __init__(self, gram: int = 2):
        if gram < 1:
            raise ValueError(f"gram must be >= 1, got {gram}")
        self.gram = gram

    def propose(self, context: np.ndarray, n: int) -> np.ndarray:
        ctx = np.asarray(context).ravel()
        g = self.gram
        if n < 1 or ctx.size <= g:
            return np.zeros((0,), np.int32)
        key = ctx[-g:]
        # candidate starts: every earlier position whose g-token window
        # matches the suffix key, newest first
        windows = np.lib.stride_tricks.sliding_window_view(ctx[:-1], g)
        hits = np.flatnonzero((windows == key).all(axis=1))
        for start in hits[::-1]:
            follow = ctx[start + g : start + g + n]
            if follow.size:
                return follow.astype(np.int32)
        return np.zeros((0,), np.int32)


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode knobs for one generation / serving run.

    ``k`` is the maximum verify-window width in tokens *including* the
    pending token, so up to ``k - 1`` draft guesses ride along per round;
    the executed window is padded to the covering power of two
    (:func:`~repro_torch.core.session.verify_bucket`), which bounds the warm
    trace set.  ``draft`` defaults to a fresh :class:`NGramDraft`.
    """

    k: int = 4
    draft: DraftSource = field(default_factory=NGramDraft)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec window k must be >= 1, got {self.k}")


@dataclass
class SpecStats:
    """Accept/commit counters for one spec-decode run.

    ``lane_rounds`` counts (verify pass × participating lane) pairs, so
    :attr:`accepted_per_step` is the mean tokens a lane commits per
    streamed pass — the headline number (1.0 means spec decode degenerated
    to plain stepping; the weight-traffic saving is roughly this factor).
    ``spec_overhead_s`` is the host-side time spent drafting, comparing
    and rolling back — everything spec decode adds *outside* the streamed
    verify pass itself.
    """

    rounds: int = 0
    lane_rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    committed_tokens: int = 0
    spec_overhead_s: float = 0.0

    @property
    def accepted_per_step(self) -> float:
        if self.lane_rounds == 0:
            return 0.0
        return self.committed_tokens / self.lane_rounds

    def snapshot(self) -> dict:
        return {
            "rounds": self.rounds,
            "lane_rounds": self.lane_rounds,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "committed_tokens": self.committed_tokens,
            "accepted_per_step": self.accepted_per_step,
            "spec_overhead_s": self.spec_overhead_s,
        }
