"""Weight-streamed offloaded decode: serving through the offload session.

Port of the cached path of ``src/repro/serve/offloaded.py``.  Weights stay
on SSD; every decode step streams them block by block through the same
pool-slot → async-read → H2D → compute → release lifecycle as training,
executed from StreamPlans with lookahead pipelining, over a **paged**
spill-able KV cache whose pages live in pool slots of the same pinned
arena (:mod:`repro_torch.core.kv_cache`).  Under ``policy.overlap`` ≠
``"sync"`` each block's KV window is gathered and copied to the device on
the staging worker beneath the previous block's compute.

The uncached full-prefix path, speculative decoding and the continuous-
batching ``ServingEngine`` come with later slices.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.kv_cache import DecodeSpec
from repro_torch.core.session import OffloadSession


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

    def generate(self, prompts: np.ndarray, new_tokens: int) -> np.ndarray:
        """Greedy-decode ``new_tokens`` per request over the cached path;
        returns (batch, new_tokens) int32."""
        self._check_open()
        tokens = self._validate_tokens(prompts, name="prompts")
        if tokens.shape[1] < 1:
            raise ValueError("prompts must hold at least one token")
        if new_tokens < 1:
            raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
        dspec = self.session.decode_spec
        if dspec is None:
            raise RuntimeError(
                "generate needs a session built with decode=DecodeSpec(...) "
                "(the uncached path is not ported yet)")
        batch, t0 = tokens.shape
        if batch != dspec.batch:
            raise ValueError(f"prompts batch {batch} != DecodeSpec batch "
                             f"{dspec.batch}")
        if t0 + new_tokens > dspec.max_seq:
            raise ValueError(f"prompt ({t0}) + new_tokens ({new_tokens}) "
                             f"exceeds DecodeSpec max_seq {dspec.max_seq}")
        kv = self.session.open_kv_cache()
        try:
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
