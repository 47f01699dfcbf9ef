"""Continuous-batching scheduler over the paged spill-able KV cache.

Splits serving into two layers with a deliberate boundary:

* :class:`FifoScheduler` — pure admission policy.  Holds the not-yet-
  arrived and arrived-but-waiting queues, reveals requests to the engine
  only once their offered ``arrival`` time has passed, and admits strictly
  in FIFO order: the queue head either joins a free batch slot, is refused
  terminally (its prompt's page window can never be streamed under the
  cache's residency budget — admitting it would thrash every other lane),
  or blocks the queue until a slot frees.  No skip-ahead: later requests
  never overtake an admissible head, so queue-wait is bounded by slot
  turnover, not by luck.
* :class:`ServingEngine` — execution.  Drives the session's compile-once
  serve path: joiners are prefilled in prompt-*bucket* groups through the
  KVWriteOp prefill-scatter mode (each group runs at the shapes a solo
  prefill of those requests would, which keeps continuously-batched greedy
  output bit-identical to decoding every request alone), active slots
  advance together through :meth:`OffloadSession.decode_step_slots`, and
  finished slots retire immediately — pages reclaimed without a spill
  write, the slot returned to the free list for the next joiner.

The engine takes injectable ``clock``/``sleep`` callables so tests can
drive arrivals deterministically with a fake clock; the defaults are wall
time.  ``run(mode="static")`` is the ablation baseline: classic static
batching that forms full batches in arrival order and admits nothing until
the whole batch drains.

Port of ``src/repro/serve/scheduler.py`` (host code: numpy only).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.session import verify_bucket
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.spec import SpecConfig, SpecStats


class FifoScheduler:
    """Arrival-ordered admission over the cache's slots and page budget."""

    def __init__(self, requests: list[Request]):
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate request ids")
        for r in requests:
            if r.state is not RequestState.QUEUED:
                raise ValueError(f"request {r.rid} already {r.state.value}")
        # stable sort: ties on arrival keep submission order (FIFO)
        self._pending = deque(sorted(requests, key=lambda r: r.arrival))
        self._queue: deque[Request] = deque()

    def poll(self, now: float) -> None:
        """Reveal every request whose arrival time has passed."""
        while self._pending and self._pending[0].arrival <= now:
            self._queue.append(self._pending.popleft())

    def admit(self, kv, now: float) -> list[Request]:
        """Admit from the queue head: join a slot per request until the
        free list runs dry.  Inadmissible prompts are refused terminally
        and do not block the queue; admissible ones do (no skip-ahead)."""
        joiners: list[Request] = []
        while self._queue:
            r = self._queue[0]
            if not kv.admissible(r.prompt_len):
                self._queue.popleft()
                r.state = RequestState.REFUSED
                r.metrics.finished_at = now
                continue
            if kv.free_slots == 0:
                break
            slot = kv.join()
            assert slot is not None
            self._queue.popleft()
            r.slot = slot
            r.state = RequestState.ACTIVE
            r.metrics.admitted_at = now
            joiners.append(r)
        return joiners

    def next_arrival(self) -> float | None:
        return self._pending[0].arrival if self._pending else None

    @property
    def waiting(self) -> int:
        """Arrived requests not yet admitted."""
        return len(self._queue)

    @property
    def drained(self) -> bool:
        return not self._pending and not self._queue


@dataclass
class ServingReport:
    """Outcome of one :meth:`ServingEngine.run`: the requests (with their
    stamped metrics) plus engine-level throughput counters."""

    requests: list[Request]
    mode: str
    duration_s: float
    decode_steps: int = 0
    active_lane_steps: int = 0
    prefills: int = 0
    batch: int = 0
    kv_stats: dict = field(default_factory=dict)
    # speculative decoding (all zero unless the engine ran with spec=...)
    spec_rounds: int = 0
    spec_committed: int = 0
    spec_lane_rounds: int = 0
    spec_overhead_s: float = 0.0

    @property
    def completed(self) -> list[Request]:
        return [r for r in self.requests if r.state is RequestState.DONE]

    @property
    def refused(self) -> list[Request]:
        return [r for r in self.requests if r.state is RequestState.REFUSED]

    @property
    def total_tokens(self) -> int:
        return sum(r.metrics.tokens_out for r in self.completed)

    @property
    def tokens_per_s(self) -> float:
        """Aggregate emitted tokens over the whole run's wall time."""
        return self.total_tokens / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of batch lanes doing useful work per decode step
        — the number continuous batching exists to raise."""
        if self.decode_steps == 0 or self.batch == 0:
            return 0.0
        return self.active_lane_steps / (self.decode_steps * self.batch)

    @property
    def accepted_per_step(self) -> float:
        """Mean tokens a lane commits per speculative verify pass — the
        weight-traffic saving factor (0.0 when spec decode was off)."""
        if self.spec_lane_rounds == 0:
            return 0.0
        return self.spec_committed / self.spec_lane_rounds

    def ttft_percentile(self, q: float) -> float:
        """q-th percentile (0-100) of arrival → first-token latency."""
        ttfts = [
            r.metrics.ttft_s for r in self.completed if r.metrics.ttft_s is not None
        ]
        if not ttfts:
            raise ValueError("no completed requests with a first token")
        return float(np.percentile(np.asarray(ttfts), q))


class ServingEngine:
    """Drives an :class:`~repro_torch.serve.offloaded.OffloadedDecoder`'s
    session as a continuous-batching server.

    ``clock`` and ``sleep`` default to wall time; tests inject a fake pair
    to make arrivals and queue-wait metrics deterministic.  One ``run()``
    at a time: it opens the session's single KV cache and closes it (page
    slots returned, in-flight request pages reclaimed) on every exit path.
    """

    def __init__(
        self,
        decoder,
        *,
        spec: SpecConfig | None = None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        if decoder.decode_spec is None:
            raise ValueError(
                "ServingEngine needs a decoder built with "
                "decode=DecodeSpec(...) — the paged KV cache "
                "is the serving substrate"
            )
        self.decoder = decoder
        self.spec = spec
        self._spec_stats: SpecStats | None = None
        self._clock = clock
        self._sleep = sleep
        self._t0 = 0.0

    def _now(self) -> float:
        return self._clock() - self._t0

    # -- request lifecycle helpers -------------------------------------------

    @staticmethod
    def _token_cap(r: Request, max_seq: int) -> int:
        """Emission cap: the request's own budget, or the cache running
        out of positions to append into (prefill's first token is free —
        it appends nothing)."""
        return min(r.max_new_tokens, max_seq - r.prompt_len + 1)

    def _emit(
        self, r: Request, token: int, now: float, next_tok: np.ndarray, max_seq: int
    ) -> bool:
        """Record one greedy token; returns True when the request is done
        (EOS or cap) and should retire."""
        if r.metrics.first_token_at is None:
            r.metrics.first_token_at = now
        r.output.append(token)
        r.metrics.tokens_out += 1
        next_tok[r.slot] = token
        if token == r.eos_token:
            return True
        return r.metrics.tokens_out >= self._token_cap(r, max_seq)

    @staticmethod
    def _retire(kv, r: Request, now: float) -> None:
        kv.retire(r.slot)
        r.state = RequestState.DONE
        r.metrics.finished_at = now

    def _prefill_group(
        self,
        kv,
        group: list[Request],
        next_tok: np.ndarray,
        by_slot: dict[int, Request],
    ) -> None:
        """One prefill-scatter pass for a same-bucket group of joiners."""
        session = self.decoder.session
        spec = self.decoder.decode_spec
        t_pad = max(r.prompt_len for r in group)
        toks = np.zeros((spec.batch, t_pad), np.int32)
        for r in group:
            toks[r.slot, : r.prompt_len] = r.prompt
        logits = session.prefill(
            kv,
            toks,
            slots=[r.slot for r in group],
            lengths=[r.prompt_len for r in group],
        )
        now = self._now()
        for r in group:
            done = self._emit(
                r, int(np.argmax(logits[r.slot])), now, next_tok, spec.max_seq
            )
            if done:
                self._retire(kv, r, now)
            else:
                by_slot[r.slot] = r

    def _step_active(
        self, kv, next_tok: np.ndarray, by_slot: dict[int, Request]
    ) -> int:
        """One batched decode step; retires finishing slots.  Returns the
        number of lanes that did useful work."""
        session = self.decoder.session
        spec = self.decoder.decode_spec
        toks = np.zeros((spec.batch, 1), np.int32)
        for slot in by_slot:
            toks[slot, 0] = next_tok[slot]
        logits = session.decode_step_slots(kv, toks)
        now = self._now()
        lanes = len(by_slot)
        for slot, r in sorted(by_slot.items()):
            if self._emit(r, int(np.argmax(logits[slot])), now, next_tok, spec.max_seq):
                del by_slot[slot]
                self._retire(kv, r, now)
        return lanes

    def _step_active_spec(
        self, kv, next_tok: np.ndarray, by_slot: dict[int, Request]
    ) -> int:
        """One speculative round over the active slots: a shared-width
        draft window (each slot's pending token + its own n-gram drafts)
        verified in one streamed pass, then **per-slot** accept/commit —
        one lane's rejection rolls only that lane's pages back; the
        others keep every token their own drafts earned.  Finishing
        slots (EOS or cap mid-window) stop committing early and retire.
        Returns the number of lanes that did useful work."""
        session = self.decoder.session
        dspec = self.decoder.decode_spec
        sc = self.spec
        stats = self._spec_stats
        th0 = time.perf_counter()
        # shared window width: the tightest lane's capacity bounds the
        # padded window for everyone (per-query results are extent- and
        # padding-invariant, so a wide lane loses nothing but the pad)
        n_cap = sc.k
        while n_cap > 1 and any(
            kv.slot_length(s) + verify_bucket(n_cap) > dspec.max_seq for s in by_slot
        ):
            n_cap -= 1
        drafts = {}
        for slot, r in by_slot.items():
            room = self._token_cap(r, dspec.max_seq) - r.metrics.tokens_out
            want = min(n_cap, max(room, 1)) - 1
            context = np.concatenate([r.prompt, np.asarray(r.output, np.int32)])
            drafts[slot] = sc.draft.propose(context, want)[: max(want, 0)]
        n = 1 + max((d.shape[0] for d in drafts.values()), default=0)
        toks = np.zeros((dspec.batch, n), np.int32)
        for slot in by_slot:
            toks[slot, 0] = next_tok[slot]
            d = drafts[slot]
            toks[slot, 1 : 1 + d.shape[0]] = d
            stats.drafted += int(d.shape[0])
        stats.spec_overhead_s += time.perf_counter() - th0
        logits = session.verify_step_slots(kv, toks)
        now = self._now()
        th1 = time.perf_counter()
        greedy = np.argmax(logits, axis=-1).astype(np.int32)
        lanes = len(by_slot)
        for slot, r in sorted(by_slot.items()):
            base = kv.slot_length(slot)
            accept = 0
            while accept + 1 < n and toks[slot, accept + 1] == greedy[slot, accept]:
                accept += 1
            committed = 0
            done = False
            for j in range(accept + 1):
                done = self._emit(r, int(greedy[slot, j]), now, next_tok, dspec.max_seq)
                committed += 1
                if done:
                    break
            stats.lane_rounds += 1
            stats.committed_tokens += committed
            stats.accepted += committed - 1
            if done:
                del by_slot[slot]
                self._retire(kv, r, now)  # drops ALL the slot's pages
            else:
                kv.rollback(slot, base + committed)
        stats.rounds += 1
        stats.spec_overhead_s += time.perf_counter() - th1
        return lanes

    def _step(self, kv, next_tok: np.ndarray, by_slot: dict[int, Request]) -> int:
        """One batched advance of the active slots — speculative when the
        engine was built with ``spec=``, plain greedy otherwise."""
        if self.spec is not None:
            return self._step_active_spec(kv, next_tok, by_slot)
        return self._step_active(kv, next_tok, by_slot)

    @staticmethod
    def _bucket_groups(spec, joiners: list[Request]) -> list[list[Request]]:
        """Group joiners by prompt time-bucket so each group's prefill
        runs at the shapes a solo prefill would (bit-identical output);
        ordered by bucket for determinism."""
        groups: dict[int, list[Request]] = {}
        for r in joiners:
            groups.setdefault(spec.bucket_len(r.prompt_len), []).append(r)
        return [groups[b] for b in sorted(groups)]

    # -- drive loops ---------------------------------------------------------

    def run(self, requests: list[Request], mode: str = "continuous") -> ServingReport:
        """Serve ``requests`` to completion; returns the stamped report.

        ``mode="continuous"``: per-slot join/decode/retire — a finishing
        request's slot and pages go to the next joiner immediately.
        ``mode="static"``: the ablation — full batches in arrival order,
        nothing admitted until the previous batch fully drains.
        """
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if not requests:
            raise ValueError("no requests to serve")
        session = self.decoder.session
        spec = self.decoder.decode_spec
        report = ServingReport(
            requests=list(requests), mode=mode, duration_s=0.0, batch=spec.batch
        )
        sched = FifoScheduler(report.requests)
        self._spec_stats = SpecStats()
        kv = session.open_kv_cache()
        self._t0 = self._clock()
        try:
            # a fresh cache opens with every slot active (the joint-prefill
            # contract); serving starts from an all-free slot pool
            for s in sorted(kv.active):
                kv.retire(s)
            if mode == "continuous":
                self._drive_continuous(kv, sched, report)
            else:
                self._drive_static(kv, sched, report)
            report.duration_s = self._now()
            return report
        finally:
            # closes on error paths too: in-flight requests' pages are
            # reclaimed with the cache, never orphaned in the pool
            self.decoder.kv_stats = report.kv_stats = kv.stats.snapshot()
            st = self._spec_stats
            report.spec_rounds = st.rounds
            report.spec_committed = st.committed_tokens
            report.spec_lane_rounds = st.lane_rounds
            report.spec_overhead_s = st.spec_overhead_s
            if self.spec is not None:
                self.decoder.spec_stats = st
            kv.close()

    def _drive_continuous(
        self, kv, sched: FifoScheduler, report: ServingReport
    ) -> None:
        spec = self.decoder.decode_spec
        next_tok = np.zeros(spec.batch, np.int32)
        by_slot: dict[int, Request] = {}
        while not (sched.drained and not by_slot):
            sched.poll(self._now())
            joiners = sched.admit(kv, self._now())
            if joiners:
                for group in self._bucket_groups(spec, joiners):
                    self._prefill_group(kv, group, next_tok, by_slot)
                    report.prefills += 1
                continue  # re-poll: prefill took time, more may have come
            if by_slot:
                report.active_lane_steps += self._step(kv, next_tok, by_slot)
                report.decode_steps += 1
                continue
            # idle: every arrived request served, more still to come.  An
            # admissible queued request never strands here — with no active
            # slots the whole free list was available to admit() above.
            nxt = sched.next_arrival()
            if nxt is None:
                break
            delay = nxt - self._now()
            if delay > 0:
                self._sleep(delay)

    def _drive_static(self, kv, sched: FifoScheduler, report: ServingReport) -> None:
        """Classic static batching: take the next ``batch`` requests in
        arrival order, wait for all of them, prefill them as one group,
        and drain the whole batch before admitting anyone else."""
        spec = self.decoder.decode_spec
        next_tok = np.zeros(spec.batch, np.int32)
        while not sched.drained:
            # block until a full batch (or the final remainder) is here
            while True:
                sched.poll(self._now())
                nxt = sched.next_arrival()
                if nxt is None or sched.waiting >= spec.batch:
                    break
                delay = nxt - self._now()
                if delay > 0:
                    self._sleep(delay)
            by_slot: dict[int, Request] = {}
            joiners = sched.admit(kv, self._now())
            if joiners:
                # prefill in prompt-bucket groups, same as continuous: a
                # short prompt prefilled in a longer prompt's bucket runs
                # at other shapes than its solo prefill would, which
                # voids the output-equals-solo-decode contract.  The
                # static tax is the decode drain, not the prefill.
                for group in self._bucket_groups(spec, joiners):
                    self._prefill_group(kv, group, next_tok, by_slot)
                    report.prefills += 1
            while by_slot:
                report.active_lane_steps += self._step(kv, next_tok, by_slot)
                report.decode_steps += 1
