"""MoE expert paging in the port: the reference's fault-injection suite for
the expert-paging path (``tests/test_expert_paging.py``) and the three
expert-paging cases of ``tests/test_session.py``, translated to the
port's session.

Both packages start from the same numpy units: the reference's
``make_offloadable_lm(..., expert_paging=mode)`` splits each MoE block's
expert stacks into per-expert pages, and the port's ``from_numpy_units``
rebuilds ``expert_meta`` from them.  The port has no jitted stage
functions, so a fault is injected into the model's apply
(``model.block_moe``, ``model.block_step_route``) instead of the
reference's ``_jit_*`` attributes.

Identities held within the port, bit for bit: routed-only expert
residency against staging every expert, in losses (sync, h2d and full
overlap) and in greedy decode tokens.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig, MoEConfig as JMoE
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import DecodeSpec, OffloadSession, memascend_policy
from repro_torch.core.model_adapter import from_numpy_units

torch.set_num_threads(2)

KW = dict(name="tiny-moe", family="moe", n_layers=2, d_model=32, n_heads=4,
          n_kv_heads=2, d_ff=64, vocab=128)
MOE = dict(n_experts=8, top_k=2, d_ff_expert=32)
JCFG = JConfig(**KW, moe=JMoE(**MOE))
CFG = ModelConfig(**KW, moe=MoEConfig(**MOE))


def _model(mode="routed", seed=0):
    units = jax_lm(JCFG, jax.random.PRNGKey(seed), expert_paging=mode).units
    return from_numpy_units(CFG, units, torch.bfloat16, device="cpu")


def _policy(root, mode="routed", overlap="full", lr=1e-2):
    return memascend_policy(root, lr=lr).replace(
        expert_paging=mode, expert_page_slots=8, overlap=overlap)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG.vocab, (2, 16)).astype(np.int32),
            rng.integers(0, CFG.vocab, (2, 16)).astype(np.int32))


class _FaultyRead:
    """Store wrapper whose ``read`` raises for expert compute pages while
    ``armed``, counting how many times the fault actually fired."""

    def __init__(self, inner, *, fail_on_call=1):
        self._inner = inner
        self.armed = True
        self.fired = 0
        self._calls = 0
        self._fail_on = fail_on_call

    def read(self, key, view):
        if self.armed and "moe.expert" in key:
            self._calls += 1
            if self._calls >= self._fail_on:
                self.fired += 1
                raise IOError(f"injected expert read failure: {key}")
        return self._inner.read(key, view)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _arm(s, **kw):
    faulty = _FaultyRead(s.store, **kw)
    s.store = faulty
    s._expert_cache.store = faulty
    return faulty


# -- failed expert SSD read ---------------------------------------------------

@pytest.mark.parametrize("overlap", ["sync", "full"])
def test_failed_expert_read_surfaces_once_and_releases(tmp_store_root,
                                                       overlap):
    """The very first expert page read fails: the error surfaces exactly
    once at the fetch gate and leaves no slot, pin or counter behind,
    proven by a clean recovery step."""
    tokens, labels = _batch()
    s = OffloadSession(_model(), _policy(tmp_store_root, overlap=overlap))
    try:
        faulty = _arm(s)
        with pytest.raises(IOError, match="injected expert read"):
            s.train_step(tokens, labels)
        assert faulty.fired == 1, (
            "fault must fire once and propagate, not be retried/swallowed")
        assert len(s.swapper._inflight) == 0
        assert s._device_slots is None or s._device_slots.idle()
        assert s.tracker.component(
            "activation_checkpoints").live_allocated == 0
        faulty.armed = False
        m = s.train_step(tokens, labels)
        assert np.isfinite(m["loss"])
    finally:
        s.close()
    s.tracker.assert_quiescent()


def test_failed_read_mid_gather_unpins_earlier_pages(tmp_store_root):
    """Failure on the THIRD expert page read: the pages already copied
    into the stack were pinned and must be unpinned on the error path, or
    the optimizer's invalidate_unit (and close) would refuse."""
    tokens, labels = _batch()
    s = OffloadSession(_model(), _policy(tmp_store_root, overlap="full"))
    try:
        faulty = _arm(s, fail_on_call=3)
        with pytest.raises(IOError, match="injected expert read"):
            s.train_step(tokens, labels)
        assert faulty.fired == 1
        assert s._device_slots.idle()
        faulty.armed = False
        losses = [s.train_step(tokens, labels)["loss"] for _ in range(2)]
        assert all(np.isfinite(x) for x in losses)
    finally:
        s.close()
    s.tracker.assert_quiescent()


def test_failed_read_on_prestaged_step_drops_staged_slot(tmp_store_root):
    """Fault armed only from the SECOND step: step 1 seeds the routing
    prior, so step 2's window prestages expert stacks whose build fails on
    the staging worker.  The failure surfaces at that step's fetch gate
    and still releases the EXPERT_CLASS budget."""
    tokens, labels = _batch()
    s = OffloadSession(_model(), _policy(tmp_store_root, overlap="full"))
    try:
        faulty = _arm(s)
        faulty.armed = False
        m = s.train_step(tokens, labels)         # seeds _expert_prior
        assert np.isfinite(m["loss"])
        # evict every cached page so step 2 must hit the store again
        for unit in s._expert_meta:
            s._expert_cache.invalidate_unit(unit)
        faulty.armed = True
        with pytest.raises(IOError, match="injected expert read"):
            s.train_step(tokens, labels)
        assert faulty.fired >= 1
        assert s._device_slots.idle()
        assert len(s.swapper._inflight) == 0
        faulty.armed = False
        m = s.train_step(tokens, labels)
        assert np.isfinite(m["loss"])
    finally:
        s.close()
    s.tracker.assert_quiescent()


# -- abort mid-step -----------------------------------------------------------

def test_abort_mid_step_drains_expert_stages(tmp_store_root):
    """A compute failure while later units' expert prestages are still in
    flight on the staging worker: the abort drain consumes those futures
    and returns their EXPERT_CLASS slots, and the session still trains."""
    tokens, labels = _batch()
    s = OffloadSession(_model(), _policy(tmp_store_root, overlap="full"))
    try:
        m = s.train_step(tokens, labels)   # warm: prior + prestage window
        assert np.isfinite(m["loss"])
        calls = {"n": 0}
        real_moe = s.model.block_moe

        def flaky_moe(*a):
            calls["n"] += 1
            if calls["n"] == 1:    # first MoE block of step 2: the next
                raise RuntimeError("injected moe failure")  # stage in flight
            return real_moe(*a)

        s.model.block_moe = flaky_moe
        with pytest.raises(RuntimeError, match="injected moe"):
            s.train_step(tokens, labels)
        s.model.block_moe = real_moe
        assert len(s.swapper._inflight) == 0
        assert s._device_slots.idle(), "abort leaked an expert slot"
        # only cache-resident pages may still hold pool buffers
        assert len(s._expert_cache.resident_pages) <= 8
        assert s.tracker.component(
            "activation_checkpoints").live_allocated == 0
        m = s.train_step(tokens, labels)
        assert np.isfinite(m["loss"])
    finally:
        s.close()
    s.tracker.assert_quiescent()


def test_abort_during_decode_releases_expert_slots(tmp_store_root):
    """Same drain contract on the serve path: a failing decode step with
    expert stacks staged releases them and leaves the KV cache usable."""
    tokens, labels = _batch()
    s = OffloadSession(_model(), _policy(tmp_store_root, overlap="full"),
                       decode=DecodeSpec(batch=2, max_seq=64))
    try:
        s.train_step(tokens, labels)
        kv = s.open_kv_cache()
        try:
            logits = s.prefill(kv, tokens[:, :8])
            nxt = np.argmax(logits, axis=-1).astype(np.int32)[:, None]
            real_step = s.model.block_step_route
            calls = {"n": 0}

            def flaky_step(*a, **kw):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("injected decode failure")
                return real_step(*a, **kw)

            s.model.block_step_route = flaky_step
            with pytest.raises(RuntimeError, match="injected decode"):
                s.decode_step(kv, nxt)
            s.model.block_step_route = real_step
            assert s._device_slots.idle()
            # the same KV cache still decodes after the drain
            out = s.decode_step(kv, nxt)
            assert out.shape[0] == 2
        finally:
            kv.close()
    finally:
        s.close()
    s.tracker.assert_quiescent()


def test_close_with_fault_still_quiesces(tmp_store_root):
    """Closing right after a failed step runs every teardown step: the
    expert cache closes (dropping resident pages), the arena returns, and
    the tracker ends quiescent."""
    tokens, labels = _batch()
    s = OffloadSession(_model(), _policy(tmp_store_root, overlap="h2d"))
    _arm(s)
    with pytest.raises(IOError, match="injected expert read"):
        s.train_step(tokens, labels)
    s.close()
    s.tracker.assert_quiescent()
    assert s.pool.in_use_payload == 0


# -- routed vs all-resident (tests/test_session.py's MoE cases) ---------------

@pytest.mark.parametrize("overlap", ["sync", "h2d", "full"])
def test_moe_routed_paging_losses_bit_identical(tmp_store_root, overlap):
    """Routed-only expert residency vs staging every expert: the losses
    are BIT-identical under every overlap mode — unrouted experts' stack
    rows are zero and never read — while the routed arm moves strictly
    fewer expert bytes out of the page cache."""
    tokens, labels = _batch(seed=7)
    out = {}
    for mode in ("all", "routed"):
        with OffloadSession(_model(mode),
                            _policy(tmp_store_root + mode, mode,
                                    overlap)) as s:
            out[mode] = ([s.train_step(tokens, labels)["loss"]
                          for _ in range(3)], s.overlap_snapshot())
        s.tracker.assert_quiescent()
    assert out["all"][0] == out["routed"][0], (
        f"{overlap}: routed paging drifted from all-resident: "
        f"{out['routed'][0]} vs {out['all'][0]}")
    assert all(np.isfinite(x) for x in out["all"][0])
    routed_b = out["routed"][1]["expert_fetch_bytes"]
    all_b = out["all"][1]["expert_fetch_bytes"]
    assert 0 < routed_b < all_b


def test_moe_routed_decode_tokens_identical(tmp_store_root):
    """Greedy decode through the paged serve path (prefill + cached
    steps): token-identical between routed and all-resident residency,
    the routed arm moving fewer expert bytes."""
    tokens, _ = _batch(seed=7)
    toks, fetched = {}, {}
    for mode in ("all", "routed"):
        with OffloadSession(_model(mode),
                            _policy(tmp_store_root + mode, mode),
                            decode=DecodeSpec(batch=2, max_seq=64)) as s:
            s.train_step(tokens, tokens)
            s.synchronize()
            before = s.overlap_snapshot()["expert_fetch_bytes"]
            kv = s.open_kv_cache()
            try:
                logits = s.prefill(kv, tokens[:, :8])
                seq = [np.argmax(logits, axis=-1).astype(np.int32)]
                for _ in range(6):
                    logits = s.decode_step(kv, seq[-1][:, None])
                    seq.append(np.argmax(logits, axis=-1).astype(np.int32))
            finally:
                kv.close()
            toks[mode] = np.stack(seq, axis=1)
            fetched[mode] = s.overlap_snapshot()["expert_fetch_bytes"] \
                - before
        s.tracker.assert_quiescent()
    np.testing.assert_array_equal(toks["all"], toks["routed"])
    assert 0 < fetched["routed"] < fetched["all"]


def test_moe_prestage_hits_after_first_step(tmp_store_root):
    """Step 2+ prestages the previous step's routed set inside the fetch
    window; with identical batches and lr=0 (weights frozen, routing
    repeats exactly) every executor expert-stage get is a hit, and fetch
    waits and refills are accounted."""
    tokens, labels = _batch(seed=7)
    with OffloadSession(_model("routed"),
                        _policy(tmp_store_root, lr=0.0)) as s:
        for _ in range(3):
            m = s.train_step(tokens, labels)
        snap = s.overlap_snapshot()
        assert snap["expert_stage_gets"] > 0
        assert snap["expert_stage_hits"] == snap["expert_stage_gets"]
        assert "expert_fetch_wait_s" in m
        stats = s.expert_cache_stats()
        assert stats["refills"] > 0
    s.tracker.assert_quiescent()


def test_expert_mode_must_match_the_model(tmp_store_root):
    """A paged model under expert_paging='off', or a stacked one under
    'routed', is refused at construction, before any store write."""
    with pytest.raises(ValueError, match="expert_paging='off'"):
        OffloadSession(_model("routed"), memascend_policy(tmp_store_root))
    stacked = from_numpy_units(
        CFG, jax_lm(JCFG, jax.random.PRNGKey(0)).units, torch.bfloat16,
        device="cpu")
    with pytest.raises(ValueError, match="no paged-MoE units"):
        OffloadSession(stacked, _policy(tmp_store_root + "b"))


def test_moe_verify_window_equals_step_chain(tmp_store_root):
    """Speculative verify over a paged-MoE session: each window position
    routes and runs its experts at the step's (B, 1) shapes, so the
    verify logits are bitwise the decode_step chain's."""
    tokens, _ = _batch(seed=7)
    window = tokens[:, 8:12]
    with OffloadSession(_model("routed"), _policy(tmp_store_root),
                        mode="serve",
                        decode=DecodeSpec(batch=2, max_seq=64)) as s:
        kv = s.open_kv_cache()
        try:
            s.prefill(kv, tokens[:, :8])
            chain = [s.decode_step(kv, window[:, j:j + 1])
                     for j in range(4)]
        finally:
            kv.close()
        kv = s.open_kv_cache()
        try:
            s.prefill(kv, tokens[:, :8])
            verify = s.verify_step(kv, window)
        finally:
            kv.close()
    for j in range(4):
        np.testing.assert_array_equal(verify[:, j], chain[j])
    s.tracker.assert_quiescent()
