"""Weight-streamed offloaded decode: serving through the offload session.

Port of ``src/repro/serve/offloaded.py``.  Weights stay on SSD; every
decode step streams them block by block through the same pool-slot →
async-read → H2D → compute → release lifecycle as training, executed from
StreamPlans with lookahead pipelining.  Three ways to generate:

* **cached** (default when the session carries a
  :class:`~repro_torch.core.kv_cache.DecodeSpec`): prefill, then steps over
  a **paged** spill-able KV cache whose pages live in pool slots of the
  same pinned arena (:mod:`repro_torch.core.kv_cache`).  Under
  ``policy.overlap`` ≠ ``"sync"`` each block's KV window is gathered and
  copied to the device on the staging worker beneath the previous block's
  compute.
* **speculative** (``spec=SpecConfig(...)``): the cached path with draft
  windows verified K tokens per streamed pass and per-slot KV rollback;
  output equals the plain greedy loop (:mod:`repro_torch.serve.spec`).
* **uncached** (``use_cache=False``): every emitted token re-runs the full
  prefix (O(T²) compute), the ablation baseline.

The continuous-batching front end over the same session is
:class:`~repro_torch.serve.scheduler.ServingEngine`.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.kv_cache import DecodeSpec
from repro_torch.core.session import OffloadSession, verify_bucket
from repro_torch.serve.spec import SpecConfig, SpecStats


class OffloadedDecoder:
    """Greedy batch decoding over an SSD-resident model.

    Wraps a serve-mode :class:`OffloadSession` unless an open session is
    handed in.  Pass ``decode=DecodeSpec(...)`` to size the session's pool
    for the spill-able KV cache.  Context manager; closing releases the
    pool arena and store.

    Token contract (validated once, here): prompts/tokens are
    ``(batch, time)`` arrays of non-negative integer ids, any integer
    dtype, converted to int32.  Floats, scalars, and flat arrays are
    rejected rather than silently cast.
    """

    def __init__(self, model, policy, *,
                 session: OffloadSession | None = None,
                 decode: DecodeSpec | None = None):
        if session is not None and decode is not None:
            raise ValueError("pass decode= when the decoder owns the "
                             "session; an existing session already fixed "
                             "its pool census")
        self.session = session or OffloadSession(
            model, policy, mode="serve", decode=decode)
        self._owns_session = session is None
        self.kv_stats: dict | None = None  # last cached run's KV stats
        self.spec_stats: SpecStats | None = None  # last spec-decode run's
        self._closed = False
        self._last_fetch: dict | None = None
        self._last_overlap: dict | None = None

    def __enter__(self) -> "OffloadedDecoder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Idempotent teardown.  Counter snapshots are taken first so
        :attr:`fetch_stats` / :attr:`kv_overlap_stats` keep answering
        after the session (and its worker threads) are gone."""
        if self._closed:
            return
        self._last_fetch = self.session.swapper.stats.snapshot()
        self._last_overlap = self._overlap_live()
        self._closed = True
        if self._owns_session:
            self.session.close()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def decode_spec(self) -> DecodeSpec | None:
        return self.session.decode_spec

    @staticmethod
    def _validate_tokens(tokens, name: str = "tokens") -> np.ndarray:
        """Enforce the token contract; returns a contiguous int32 copy."""
        arr = np.asarray(tokens)
        if arr.ndim != 2:
            raise ValueError(f"{name} must be (batch, time), got shape "
                             f"{arr.shape}")
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"{name} must hold integer token ids, got dtype "
                            f"{arr.dtype}")
        if arr.size and int(arr.min()) < 0:
            raise ValueError(f"{name} holds negative token ids")
        return np.ascontiguousarray(arr, dtype=np.int32)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("decoder is closed (stats properties still "
                               "answer; compute paths do not)")

    def step_logits(self, tokens: np.ndarray) -> np.ndarray:
        """Next-token fp32 logits (batch, vocab) for a (batch, time)
        prompt — one full streamed pass (uncached; see :meth:`generate`
        for the cached loop)."""
        self._check_open()
        tokens = self._validate_tokens(tokens)
        return self.session.decode_logits(tokens)[:, -1, :]

    def generate(self, prompts: np.ndarray, new_tokens: int, *,
                 use_cache: bool | None = None,
                 spec: SpecConfig | None = None) -> np.ndarray:
        """Greedy-decode ``new_tokens`` per request; returns (batch, new)
        int32.

        ``use_cache=None`` picks cached decode whenever the session has a
        DecodeSpec; ``use_cache=False`` forces the O(T²) full-prefix path.
        ``spec=SpecConfig(...)`` runs speculative decoding over the cached
        path; its output equals the plain greedy loop's, and its counters
        land in :attr:`spec_stats`."""
        self._check_open()
        tokens = self._validate_tokens(prompts, name="prompts")
        if tokens.shape[1] < 1:
            raise ValueError("prompts must hold at least one token")
        if new_tokens < 1:
            raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
        dspec = self.session.decode_spec
        cached = (dspec is not None) if use_cache is None else use_cache
        if spec is not None and not cached:
            raise ValueError("speculative decoding needs the cached path; "
                             "it cannot run with use_cache=False")
        if not cached:
            return self._generate_uncached(tokens, new_tokens)
        if dspec is None:
            raise RuntimeError(
                "use_cache=True needs a session built with "
                "decode=DecodeSpec(...) so the pool census has KV slots")
        batch, t0 = tokens.shape
        if batch != dspec.batch:
            raise ValueError(f"prompts batch {batch} != DecodeSpec batch "
                             f"{dspec.batch}")
        if t0 + new_tokens > dspec.max_seq:
            raise ValueError(f"prompt ({t0}) + new_tokens ({new_tokens}) "
                             f"exceeds DecodeSpec max_seq {dspec.max_seq}")
        kv = self.session.open_kv_cache()
        try:
            if spec is not None:
                return self._generate_spec(kv, tokens, new_tokens, spec)
            logits = self.session.prefill(kv, tokens)
            out = []
            for i in range(new_tokens):
                nxt = np.argmax(logits, axis=-1).astype(np.int32)
                out.append(nxt)
                if i + 1 < new_tokens:
                    logits = self.session.decode_step(kv, nxt[:, None])
            return np.stack(out, axis=1)
        finally:
            self.kv_stats = kv.stats.snapshot()
            kv.close()

    def _generate_spec(self, kv, tokens: np.ndarray, new_tokens: int,
                       spec: SpecConfig) -> np.ndarray:
        """Speculative greedy loop over the cached path (joint batch).

        Round invariant: the cache holds every emitted token but the last,
        which rides as the pending head of the next verify window
        ``[pending, draft...]``.  The verify pass prices the whole window
        at ~one streamed weight pass; the host commits the longest prefix
        the sequential argmax chain agrees with (all lanes advance in
        lockstep by the batch minimum — recomputed tokens are
        deterministic, so per-lane output is unchanged) and rolls every
        slot back over the rejected tail."""
        session = self.session
        dspec = session.decode_spec
        stats = SpecStats()
        try:
            logits = session.prefill(kv, tokens)
            batch = tokens.shape[0]
            t_next = np.argmax(logits, axis=-1).astype(np.int32)
            out = [t_next.copy()]
            emitted = 1
            contexts = [list(map(int, tokens[b])) + [int(t_next[b])]
                        for b in range(batch)]
            while emitted < new_tokens:
                th0 = time.perf_counter()
                remaining = new_tokens - emitted
                n_cap = min(spec.k, remaining)
                drafts = [spec.draft.propose(np.asarray(contexts[b], np.int32),
                                             n_cap - 1)
                          for b in range(batch)]
                n = 1 + max(d.shape[0] for d in drafts)
                # the padded window must still fit the cache capacity
                while n > 1 and kv.length + verify_bucket(n) > dspec.max_seq:
                    n -= 1
                window = np.zeros((batch, n), np.int32)
                window[:, 0] = t_next
                for b, d in enumerate(drafts):
                    m = min(d.shape[0], n - 1)
                    window[b, 1:1 + m] = d[:m]
                    stats.drafted += m
                stats.spec_overhead_s += time.perf_counter() - th0
                vlogits = session.verify_step(kv, window)
                th1 = time.perf_counter()
                greedy = np.argmax(vlogits, axis=-1).astype(np.int32)
                accept = np.zeros(batch, np.int64)
                for b in range(batch):
                    j = 0
                    while j + 1 < n and window[b, j + 1] == greedy[b, j]:
                        j += 1
                    accept[b] = j
                commit = int(min(int(accept.min()) + 1, remaining))
                for j in range(commit):
                    out.append(greedy[:, j].copy())
                base = kv.length
                for s in sorted(kv.active):
                    kv.rollback(s, base + commit)
                t_next = greedy[:, commit - 1].copy()
                for b in range(batch):
                    contexts[b].extend(int(x) for x in greedy[b, :commit])
                emitted += commit
                stats.rounds += 1
                stats.lane_rounds += batch
                stats.committed_tokens += commit * batch
                stats.accepted += (commit - 1) * batch
                stats.spec_overhead_s += time.perf_counter() - th1
            return np.stack(out, axis=1)
        finally:
            self.spec_stats = stats

    def _generate_uncached(self, tokens: np.ndarray,
                           new_tokens: int) -> np.ndarray:
        """Full-prefix re-run per token (the O(T²) ablation)."""
        out = []
        for _ in range(new_tokens):
            nxt = np.argmax(self.step_logits(tokens), axis=-1)
            nxt = nxt.astype(np.int32)
            out.append(nxt)
            tokens = np.concatenate([tokens, nxt[:, None]], axis=1)
        return np.stack(out, axis=1)

    def _overlap_live(self) -> dict:
        snap = self.session.overlap_snapshot()
        return {"kv_stage_gets": snap["kv_stage_gets"],
                "kv_stage_hits": snap["kv_stage_hits"],
                "kv_stage_wait_s": snap["kv_stage_wait_seconds"]}

    @property
    def fetch_stats(self) -> dict:
        """Swapper counters — how well decode hides SSD latency.  After
        :meth:`close`, the final pre-teardown snapshot."""
        if self._closed:
            return dict(self._last_fetch)
        return self.session.swapper.stats.snapshot()

    @property
    def kv_overlap_stats(self) -> dict:
        """Staged-KV transfer counters (session lifetime): hits/gets of the
        staged window and the executor's wait when it was not staged yet.
        All zero under ``overlap="sync"``.  After :meth:`close`, the final
        pre-teardown snapshot."""
        if self._closed:
            return dict(self._last_overlap)
        return self._overlap_live()
