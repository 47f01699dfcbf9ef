"""Cached offloaded decode: the port's ``OffloadedDecoder.generate`` against
the reference package's, on the same numpy weights and prompts, plus the
port's own identities and its failure paths.

* fp32 compute: greedy tokens identical to the reference.
* bf16 compute: teacher-forced on the reference's greedy tokens, every
  step's logits within 8 bf16 ULPs of each row's max logit (the repo's
  decode-audit bound, ``benchmarks/bench_decode.py``), and an argmax may
  differ only where the reference's top two logits lie within that bound
  (a near-tie).  Free-running bf16 greedy tokens are not compared: one
  near-tie flip sends the two runs down different continuations.
* within the port: ``sync`` == ``full`` overlap and a 2-page spilling KV
  budget == all-resident, token for token.
* uncached (full-prefix) decode, ``decode_logits`` / ``use_cache=False``:
  fp32 logits within 1e-5 of the reference's (row-max scaled) and tokens
  identical to the reference's and to the port's cached path; at bf16 the
  first step's logits equal the cached prefill's bit for bit (both run
  ``attention_scores``, as the reference's do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import OffloadPolicy as JPolicy
from repro.core.kv_cache import DecodeSpec as JSpec
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.serve import OffloadedDecoder as JDecoder
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.core import DecodeSpec, OffloadPolicy, OffloadSession
from repro_torch.core.model_adapter import (from_numpy_units,
                                            make_offloadable_lm)
from repro_torch.serve import OffloadedDecoder

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", n_layers=3, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256, qk_norm=True)
JCFG, TCFG = JConfig(**KW), ModelConfig(**KW)
ULP_TOL = 8.0 * 2.0 ** -8
NEW = 10


@pytest.fixture(scope="module")
def jmodel():
    return jax_lm(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def units(jmodel):
    return jmodel.units


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(3, 256, size=(2, 6),
                                             dtype=np.int32)


def _spec(**kw):
    return dict(batch=2, max_seq=32, bucket=8, **kw)


def _policy(root, compute, overlap="full"):
    return (OffloadPolicy.preset("memascend").with_store(root)
            .with_adam(compute_dtype=compute).with_overlap(overlap).build())


def _port_generate(units, prompts, root, compute="bfloat16", overlap="full",
                   **spec_kw):
    model = from_numpy_units(TCFG, units, getattr(torch, compute),
                             device="cpu")
    with OffloadedDecoder(model, _policy(root, compute, overlap),
                          decode=DecodeSpec(**_spec(**spec_kw))) as dec:
        return dec.generate(prompts, NEW)


def _jax_session_logits(model, prompts, root):
    """Reference bf16 logits per step, each step fed the reference's own
    greedy token."""
    policy = JPolicy.preset("memascend").with_store(root).build()
    with JDecoder(model, policy, decode=JSpec(**_spec())) as dec:
        s = dec.session
        kv = s.open_kv_cache()
        try:
            out = [np.asarray(s.prefill(kv, prompts), np.float32)]
            for t in range(NEW - 1):
                nxt = np.argmax(out[-1], -1).astype(np.int32)
                out.append(np.asarray(s.decode_step(kv, nxt[:, None]),
                                      np.float32))
        finally:
            kv.close()
    return out


@pytest.mark.parametrize("spec_kw", [{}, {"resident_pages": 2}],
                         ids=["resident", "spilling"])
def test_fp32_tokens_match_reference(jmodel, units, prompts, tmp_store_root,
                                     spec_kw):
    jpol = (JPolicy.preset("memascend").with_store(tmp_store_root + "/j")
            .with_adam(compute_dtype="float32").build())
    with JDecoder(jmodel, jpol, decode=JSpec(**_spec(**spec_kw))) as dec:
        ref = dec.generate(prompts, NEW)
    got = _port_generate(units, prompts, tmp_store_root + "/t", "float32",
                         **spec_kw)
    np.testing.assert_array_equal(got, ref)


def test_bf16_teacher_forced_logits_within_ulp_bound(jmodel, units, prompts,
                                                     tmp_store_root):
    ref = _jax_session_logits(jmodel, prompts, tmp_store_root + "/j")
    teacher = np.stack([r.argmax(-1) for r in ref[:-1]], axis=1)
    model = from_numpy_units(TCFG, units, torch.bfloat16, device="cpu")
    with OffloadedDecoder(model, _policy(tmp_store_root + "/t", "bfloat16"),
                          decode=DecodeSpec(**_spec())) as dec:
        s = dec.session
        kv = s.open_kv_cache()
        try:
            got = [s.prefill(kv, prompts)]
            for t in range(NEW - 1):
                got.append(s.decode_step(kv, teacher[:, t:t + 1]))
        finally:
            kv.close()
    for g, r in zip(got, ref, strict=True):
        scale = np.maximum(np.abs(r).max(-1, keepdims=True), 1.0)
        assert (np.abs(g - r) / scale).max() <= ULP_TOL
        for b in np.nonzero(g.argmax(-1) != r.argmax(-1))[0]:
            gap = r[b, r[b].argmax()] - r[b, g[b].argmax()]
            assert gap <= ULP_TOL * scale[b, 0], "flip beyond a near-tie"


def test_sync_equals_full_and_spilling_equals_resident(units, prompts,
                                                       tmp_store_root):
    full = _port_generate(units, prompts, tmp_store_root + "/a")
    sync = _port_generate(units, prompts, tmp_store_root + "/b",
                          overlap="sync")
    spill = _port_generate(units, prompts, tmp_store_root + "/c",
                           resident_pages=2)
    np.testing.assert_array_equal(sync, full)
    np.testing.assert_array_equal(spill, full)


@pytest.mark.parametrize("where", ["compute", "staging"])
@pytest.mark.parametrize("overlap", ["sync", "full"])
def test_mid_generate_failure_returns_every_slot(units, prompts,
                                                 tmp_store_root, where,
                                                 overlap):
    """A failure in the fourth block apply (the second decode step) or in
    the sixteenth H2D copy (mid-prefill) surfaces from generate() and
    leaves no pool slot, device slot or worker thread behind; the decoder
    then generates again."""
    model = from_numpy_units(TCFG, units, torch.bfloat16, device="cpu")
    dec = OffloadedDecoder(model, _policy(tmp_store_root, "bfloat16",
                                          overlap),
                           decode=DecodeSpec(**_spec(resident_pages=2)))
    try:
        s = dec.session
        calls = {"n": 0}
        if where == "compute":
            target, name = model, "block_step"
        else:
            target, name = s, "_h2d_copy"
        orig = getattr(target, name)

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 4 + (12 if where == "staging" else 0):
                raise RuntimeError("injected fault")
            return orig(*a, **kw)

        setattr(target, name, flaky)
        with pytest.raises(RuntimeError, match="injected fault"):
            dec.generate(prompts, NEW)
        assert s.pool.in_use_payload == 0
        assert s._device_slots is None or s._device_slots.idle()
        setattr(target, name, orig)
        assert dec.generate(prompts, 3).shape == (2, 3)
    finally:
        dec.close()


def test_entry_points_refuse_what_is_not_ported(tmp_store_root):
    model = make_offloadable_lm(TCFG, 0, torch.float32, device="cpu")
    policy = _policy(tmp_store_root, "float32")
    # a train-mode session takes the preset as shipped: its default host
    # tier of activation checkpoints, one per block
    with OffloadSession(model, _policy(tmp_store_root + "/train", "float32"),
                        mode="train") as s:
        assert s._act_tiers == ("host",) * TCFG.n_layers
    s.tracker.assert_quiescent()
    with OffloadedDecoder(model, policy) as dec:
        # without a DecodeSpec the decoder runs the uncached path; the
        # cached one needs the spec's KV page slots in the pool census
        with pytest.raises(RuntimeError, match="DecodeSpec"):
            dec.generate(np.ones((2, 3), np.int32), 2, use_cache=True)
    mla = ModelConfig(**{**KW, "name": "tiny-mla"},
                      mla=MLAConfig(q_lora_rank=16, kv_lora_rank=16,
                                    qk_nope_head_dim=8, qk_rope_head_dim=8,
                                    v_head_dim=8))
    with pytest.raises(NotImplementedError, match="mla"):
        make_offloadable_lm(mla, 0, device="cpu")
    # expert paging needs a MoE FFN to split into pages
    with pytest.raises(ValueError, match="MoE"):
        make_offloadable_lm(TCFG, 0, device="cpu", expert_paging="routed")


def test_uncached_decode_matches_reference_and_cached(units, prompts,
                                                      tmp_store_root):
    jpol = (JPolicy.preset("memascend").with_store(tmp_store_root + "/j")
            .with_adam(compute_dtype="float32").build())
    with JDecoder(jax_lm(JCFG, jax.random.PRNGKey(0), jnp.float32),
                  jpol) as dec:
        ref_logits = np.asarray(dec.session.decode_logits(prompts))
        ref = dec.generate(prompts, 4)
    model = from_numpy_units(TCFG, units, torch.float32, device="cpu")
    with OffloadedDecoder(model, _policy(tmp_store_root + "/t", "float32"),
                          decode=DecodeSpec(**_spec())) as dec:
        logits = dec.session.decode_logits(prompts)
        got = dec.generate(prompts, 4, use_cache=False)
        cached = dec.generate(prompts, 4)
    assert logits.shape == (2, 6, 256) and logits.dtype == np.float32
    scale = np.abs(ref_logits).max(-1, keepdims=True)
    assert (np.abs(logits - ref_logits) / scale).max() <= 1e-5
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, cached)


def test_bf16_uncached_first_step_within_ulp_bound_of_prefill(
        units, prompts, tmp_store_root):
    model = from_numpy_units(TCFG, units, torch.bfloat16, device="cpu")
    with OffloadedDecoder(model, _policy(tmp_store_root, "bfloat16"),
                          decode=DecodeSpec(**_spec())) as dec:
        first = dec.step_logits(prompts)
        s = dec.session
        kv = s.open_kv_cache()
        try:
            pre = s.prefill(kv, prompts)
        finally:
            kv.close()
    np.testing.assert_array_equal(first, pre)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        make_offloadable_lm(TCFG, 0)
