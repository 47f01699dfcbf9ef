"""OffloadSession in the port: the reference's lifecycle, error-path
drain, lookahead and serve-mode cases (``tests/test_session.py``, its
twelve cases before the expert-paging ones) translated to the port.

The model is the port's ``from_numpy_units`` over the reference's numpy
units (``make_offloadable_lm(CFG, PRNGKey(seed))``), applies on the CPU.
The port has no jitted stage functions: the reference's ``_jit_block``
fault hook is the port's ``_block_forward``, the function the training
plan's ``block`` op runs.  The three expert-paging cases live in
``tests/test_torch_expert_paging.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (OffloadPolicy, OffloadSession,
                              memascend_policy)
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.data import DataLoader, SyntheticTextDataset
from repro_torch.serve import OffloadedDecoder

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256)
JCFG, CFG = JConfig(**KW), ModelConfig(**KW)


def _model(seed=0):
    units = jax_lm(JCFG, jax.random.PRNGKey(seed)).units
    return from_numpy_units(CFG, units, torch.bfloat16, device="cpu")


def _batch(batch=4, seq=32, seed=1):
    dl = DataLoader(SyntheticTextDataset(vocab=256, seed=seed), batch=batch,
                    seq_len=seq)
    return dl.next_batch()


class _RecordingSwapper:
    """Delegating wrapper that logs (op, key) event order."""

    def __init__(self, inner):
        self._inner = inner
        self.events = []

    def prefetch(self, key, dtype, shape, **kw):
        self.events.append(("prefetch", key))
        return self._inner.prefetch(key, dtype, shape, **kw)

    def get(self, key, dtype, shape, **kw):
        self.events.append(("get", key))
        return self._inner.get(key, dtype, shape, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def first(self, op, unit):
        return next(i for i, (o, k) in enumerate(self.events)
                    if o == op and k.startswith(unit + "/"))


# -- lifecycle ---------------------------------------------------------------

def test_context_manager_frees_everything(tmp_store_root):
    b = _batch()
    with OffloadSession(_model(), memascend_policy(tmp_store_root,
                                                   lr=1e-3)) as s:
        m = s.train_step(b["tokens"], b["labels"])
        assert np.isfinite(m["loss"])
        tracker = s.tracker
        assert tracker.component("pinned").live_allocated > 0
    # __exit__ returned the pool arena, the flat buffer, and every staging
    # byte; the swapper has nothing in flight.
    tracker.assert_quiescent()
    assert len(s.swapper._inflight) == 0
    s.close()   # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        s.train_step(b["tokens"], b["labels"])


def test_error_path_drains_inflight_and_checkpoints(tmp_store_root):
    b = _batch()
    s = OffloadSession(_model(), memascend_policy(tmp_store_root, lr=1e-3))
    calls = {"n": 0}
    real_block = s._block_forward

    def flaky_block(params, h):
        calls["n"] += 1
        if calls["n"] == 2:     # fail mid-forward, prefetches in flight
            raise RuntimeError("injected block failure")
        return real_block(params, h)

    s._block_forward = flaky_block
    with pytest.raises(RuntimeError, match="injected"):
        s.train_step(b["tokens"], b["labels"])
    # drain ran: no outstanding reads, every pool slot returned, and the
    # host-held activation checkpoints were freed.
    assert len(s.swapper._inflight) == 0
    assert s.pool.in_use_payload == 0
    assert s.tracker.component(
        "activation_checkpoints").live_allocated == 0
    s.close()
    s.tracker.assert_quiescent()


def test_close_runs_every_step_despite_failure(tmp_store_root):
    """A failure mid-close (e.g. an interrupt re-raised out of drain) must
    not skip the remaining cleanup steps: the store still closes and the
    original failure propagates."""
    s = OffloadSession(_model(), memascend_policy(tmp_store_root, lr=1e-3))
    s.swapper.drain = lambda: (_ for _ in ()).throw(
        KeyboardInterrupt("injected"))
    store_closed = []
    real_close = s.store.close
    def closing():
        store_closed.append(True)
        real_close()
    s.store.close = closing
    with pytest.raises(KeyboardInterrupt, match="injected"):
        s.close()
    assert store_closed and s.pool.in_use_payload == 0
    s.tracker.assert_quiescent()
    s.close()   # idempotent after a failed close


def test_init_failure_releases_store_and_arena(tmp_store_root):
    """A constructor failure after the store opened (e.g. disk-full while
    seeding optimizer state) must release everything already acquired —
    __enter__ never runs, so nobody else can close()."""
    from repro_torch.core import FilesystemEngine

    class _FailingStore:
        def __init__(self, inner):
            self._inner = inner
            self.closed = False

        def write(self, *a, **kw):
            raise IOError("injected disk full")

        def close(self):
            self.closed = True
            self._inner.close()

        def __getattr__(self, name):
            return getattr(self._inner, name)

    failing = _FailingStore(FilesystemEngine(tmp_store_root))
    policy = (OffloadPolicy.preset("memascend")
              .with_store(factory=lambda: failing).with_adam(lr=1e-3).build())
    from repro_torch.core.memory_tracker import MemoryTracker
    tracker = MemoryTracker()
    with pytest.raises(IOError, match="injected"):
        OffloadSession(_model(), policy, tracker=tracker)
    assert failing.closed
    tracker.assert_quiescent()   # pinned arena returned


def test_growth_step_unscales_with_pre_growth_scale(tmp_store_root):
    """On a loss-scale growth step the grads in the flat buffer carry the
    OLD scale; the optimizer must unscale with that, not the doubled
    post-update scale (regression: updates were 2x too small every
    growth_interval steps)."""
    policy = (OffloadPolicy.preset("memascend").with_store(tmp_store_root)
              .with_adam(lr=1e-3, compute_dtype="float16").build())
    b = _batch()
    with OffloadSession(_model(), policy) as s:
        s.scaler.scale = 1024.0
        s.scaler.growth_interval = 1    # next good step doubles the scale
        seen = {}
        real_compute = s.optimizer.compute_subgroup
        def recording_compute(staged, grad):
            seen[staged.key] = np.asarray(grad, dtype=np.float32)
            return real_compute(staged, grad)
        s.optimizer.compute_subgroup = recording_compute
        m = s.train_step(b["tokens"], b["labels"])
        s.synchronize()   # full overlap: Adam streams on the worker
        assert m["applied"] and s.scaler.scale == 2048.0
        key = "embed/embed"
        off, size, shape = s._flat_offsets[key]
        scaled = s.flat[off:off + size].reshape(shape)
        np.testing.assert_allclose(seen[key], scaled / 1024.0, rtol=1e-6)


# -- lookahead pipelining ----------------------------------------------------

def test_lookahead_prefetches_next_block_before_current_get(tmp_store_root):
    # overlap="sync" keeps every swapper event on the executor thread so
    # the interleaving is deterministic; the window logic under test is
    # identical in the overlap modes (covered by test_overlap_executor.py,
    # which asserts outcomes rather than cross-thread event order).
    policy = (OffloadPolicy.preset("memascend").with_store(tmp_store_root)
              .with_lookahead(2).with_overlap("sync").build())
    b = _batch()
    with OffloadSession(_model(), policy) as s:
        rec = _RecordingSwapper(s.swapper)
        s.swapper = rec
        s.eval_loss(b["tokens"], b["labels"])
    # block_001's SSD read was issued before we blocked on block_000
    assert rec.first("prefetch", "block_001") < rec.first("get", "block_000")


def test_lookahead_one_is_synchronous(tmp_store_root):
    policy = (OffloadPolicy.preset("memascend").with_store(tmp_store_root)
              .with_lookahead(1).with_overlap("sync").build())
    b = _batch()
    with OffloadSession(_model(), policy) as s:
        assert s.lookahead == 1
        rec = _RecordingSwapper(s.swapper)
        s.swapper = rec
        s.eval_loss(b["tokens"], b["labels"])
    # no cross-unit overlap: block_001 is only touched after block_000's get
    assert rec.first("prefetch", "block_001") > rec.first("get", "block_000")


def test_deep_lookahead_still_prefetches_backward_refetch(tmp_store_root):
    """Lookahead deep enough to reach a unit's backward re-fetch while its
    forward ticket is still in flight must not alias onto that ticket:
    every get() should find a genuinely issued read (regression — the
    window used to advance past the duplicate, degrading the backward
    fetch to a synchronous read)."""
    policy = (OffloadPolicy.preset("memascend").with_store(tmp_store_root)
              .with_inflight_blocks(3).with_lookahead(3).build())
    b = _batch()
    with OffloadSession(_model(), policy) as s:
        s.train_step(b["tokens"], b["labels"])
        assert s.swapper.stats.sync_fallbacks == 0


def test_train_metrics_report_fetch_wait(tmp_store_root):
    b = _batch()
    with OffloadSession(_model(), memascend_policy(tmp_store_root,
                                                   lr=1e-3)) as s:
        m = s.train_step(b["tokens"], b["labels"])
    assert m["fetch_wait_s"] >= 0.0
    assert m["prefetch_hits"] > 0    # lookahead had reads in flight


# -- serve mode + offloaded decode ------------------------------------------

def test_serve_mode_streams_weights_only(tmp_store_root):
    model = _model()
    policy = memascend_policy(tmp_store_root, lr=1e-3)
    with OffloadSession(model, policy, mode="serve") as s:
        assert s.flat is None and s.optimizer is None
        # only .compute tensors were written — no master/m/v on the store
        keys = s.store.keys()
        assert keys and all(k.endswith(".compute") for k in keys)
        tokens = _batch(batch=2, seq=8)["tokens"]
        logits = s.decode_logits(tokens)
        assert logits.shape == (2, 8, CFG.vocab)
        with pytest.raises(RuntimeError, match="train-mode"):
            s.train_step(tokens, tokens)
        with pytest.raises(RuntimeError, match="master"):
            s.master_param("embed", "embed")
    s.tracker.assert_quiescent()


def test_decode_matches_train_session_weights(tmp_store_root):
    """Serve-mode registration feeds the same compute weights the train
    session streams: identical logits through the same decode plan."""
    tokens = _batch(batch=2, seq=8)["tokens"]
    with OffloadSession(_model(), memascend_policy(
            tmp_store_root + "t", lr=1e-3)) as st:
        logits_train = st.decode_logits(tokens)
    with OffloadSession(_model(), memascend_policy(
            tmp_store_root + "s", lr=1e-3), mode="serve") as ss:
        logits_serve = ss.decode_logits(tokens)
    np.testing.assert_array_equal(logits_train, logits_serve)


def test_offloaded_decoder_greedy_generate(tmp_store_root):
    model = _model()
    policy = memascend_policy(tmp_store_root, lr=1e-3)
    prompts = np.asarray(_batch(batch=2, seq=6)["tokens"])
    with OffloadedDecoder(model, policy) as dec:
        gen = dec.generate(prompts, 3)
        assert gen.shape == (2, 3)
        # greedy decode is deterministic: replay step-by-step
        ctx = prompts
        for t in range(3):
            expect = np.argmax(dec.step_logits(ctx), axis=-1)
            np.testing.assert_array_equal(gen[:, t], expect)
            ctx = np.concatenate([ctx, expect[:, None].astype(np.int32)],
                                 axis=1)
        assert dec.fetch_stats["n_gets"] > 0
    dec.session.tracker.assert_quiescent()
