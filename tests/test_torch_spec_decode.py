"""Speculative decoding in the port, against the reference package on the
same numpy weights and inputs, and against the port's own step chain.

* ``verify_bucket`` and ``NGramDraft`` equal the reference's.
* ``gqa_verify`` equals the reference's at fp32 within rtol 1e-5 (the same
  math; the port projects each window position as its own product).
* Within the port, verify-window logits are bitwise the ``decode_step``
  chain's — joint and at ragged per-slot lengths, fp32 and bf16 — because
  every position runs at the step's own shapes.
* ``generate(spec=...)`` emits the plain greedy tokens, and at fp32 the
  reference's speculative tokens too; it refuses ``use_cache=False``.
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
from repro.core.session import verify_bucket as j_verify_bucket
from repro.models.attention import gqa_step as j_gqa_step
from repro.models.attention import gqa_verify as j_gqa_verify
from repro.serve import NGramDraft as JNGramDraft
from repro.serve import OffloadedDecoder as JDecoder
from repro.serve import SpecConfig as JSpecConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core import DecodeSpec, OffloadPolicy, OffloadSession
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.core.session import verify_bucket
from repro_torch.models.attention import gqa_step, gqa_verify
from repro_torch.serve import NGramDraft, OffloadedDecoder, SpecConfig

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", n_layers=3, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256, qk_norm=True)
JCFG, TCFG = JConfig(**KW), ModelConfig(**KW)


@pytest.fixture(scope="module")
def units():
    return jax_lm(JCFG, jax.random.PRNGKey(0)).units


def _policy(root, compute):
    return (OffloadPolicy.preset("memascend").with_store(root)
            .with_adam(compute_dtype=compute).build())


def _session(units, root, compute, **spec_kw):
    model = from_numpy_units(TCFG, units, getattr(torch, compute),
                             device="cpu")
    return OffloadSession(model, _policy(root, compute), mode="serve",
                          decode=DecodeSpec(**spec_kw))


def test_verify_bucket_matches_reference():
    for n in range(1, 40):
        assert verify_bucket(n) == j_verify_bucket(n)
    with pytest.raises(ValueError):
        verify_bucket(0)


def test_ngram_draft_matches_reference():
    rng = np.random.default_rng(0)
    for gram in (1, 2, 3):
        for _ in range(20):
            ctx = rng.integers(0, 6, rng.integers(1, 40)).astype(np.int32)
            n = int(rng.integers(0, 6))
            np.testing.assert_array_equal(NGramDraft(gram).propose(ctx, n),
                                          JNGramDraft(gram).propose(ctx, n))
    with pytest.raises(ValueError):
        NGramDraft(gram=0)
    with pytest.raises(ValueError):
        SpecConfig(k=0)


def _attn_inputs(units, cache_len, kq=5, s_bucket=32, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: v for k, v in units[1].params.items()
              if k.startswith("attn.")}
    x = rng.standard_normal((2, kq, TCFG.d_model)).astype(np.float32)
    shape = (2, s_bucket, TCFG.n_kv_heads, TCFG.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return params, x, k, v, np.asarray(cache_len, np.int64)


@pytest.mark.parametrize("cache_len", [9, [3, 20]], ids=["joint", "ragged"])
def test_gqa_verify_matches_reference(units, cache_len):
    params, x, k, v, cl = _attn_inputs(units, cache_len)
    t = [torch.from_numpy(a) for a in (x, k, v, cl)]
    got = gqa_verify({n: torch.from_numpy(a.copy())
                      for n, a in params.items()},
                     t[0], TCFG, t[1], t[2], t[3], chunk=8)
    want = j_gqa_verify({n: jnp.asarray(a) for n, a in params.items()},
                        jnp.asarray(x), JCFG, jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(cl, jnp.int32), chunk=8)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_verify_position_zero_is_gqa_step(units, dtype):
    """Window position 0 is bitwise one gqa_step on a shorter extent: the
    same (B, 1) projections, the same core (the window's later positions
    and the extra chunks are masked to exact zeros)."""
    params, x, k, v, cl = _attn_inputs(units, [4, 11])
    p = {n: torch.from_numpy(a.copy()).to(dtype) for n, a in params.items()}
    xs, ks, vs = (torch.from_numpy(a).to(dtype) for a in (x, k, v))
    out, k_new, v_new = gqa_verify(p, xs, TCFG, ks, vs,
                                   torch.from_numpy(cl), chunk=8)
    s_out, s_k, s_v = gqa_step(p, xs[:, :1].contiguous(), TCFG,
                               ks[:, :16].contiguous(), vs[:, :16].contiguous(),
                               torch.from_numpy(cl), chunk=8)
    assert torch.equal(out[:, :1], s_out)
    assert torch.equal(k_new[:, :1], s_k) and torch.equal(v_new[:, :1], s_v)
    # the reference's step agrees at fp32 too
    if dtype == torch.float32:
        j_out, _k, _v = j_gqa_step(
            {n: jnp.asarray(a) for n, a in params.items()},
            jnp.asarray(x[:, :1]), JCFG, jnp.asarray(k[:, :16]),
            jnp.asarray(v[:, :16]), jnp.asarray(cl, jnp.int32), chunk=8)
        np.testing.assert_allclose(s_out.numpy(), np.asarray(j_out),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_verify_logits_match_sequential_steps(units, tmp_store_root,
                                              compute):
    """Every window position's verify logits are bitwise the decode_step
    chain's; lengths do not advance, and after a partial-commit rollback
    the next step repeats the chain."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, 256, (2, 7))
    window = rng.integers(3, 256, (2, 5))
    with _session(units, tmp_store_root, compute, batch=2, max_seq=64,
                  bucket=16) as s:
        kv = s.open_kv_cache()
        s.prefill(kv, prompt)
        seq = [s.decode_step(kv, window[:, j:j + 1]) for j in range(5)]
        kv.close()
        kv = s.open_kv_cache()
        s.prefill(kv, prompt)
        base = kv.length
        vlg = s.verify_step(kv, window)          # padded to 8 inside
        assert vlg.shape == (2, 5, 256) and vlg.dtype == np.float32
        for j in range(5):
            np.testing.assert_array_equal(vlg[:, j], seq[j])
        assert kv.length == base
        for slot in sorted(kv.active):
            kv.rollback(slot, base + 3)
        np.testing.assert_array_equal(s.decode_step(kv, window[:, 3:4]),
                                      seq[3])
        kv.close()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_verify_step_slots_ragged_lengths(units, tmp_store_root, compute):
    """Per-slot verify at ragged lengths equals each lane's sequential
    chain and leaves every slot's length untouched."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, 256, (2, 6))
    step1 = rng.integers(3, 256, (2, 1))
    w = rng.integers(3, 256, (2, 3))

    def drive(s):
        kv = s.open_kv_cache()
        s.prefill(kv, prompt)
        s.decode_step_slots(kv, step1)
        kv.rollback(0, kv.slot_length(0) - 1)   # ragged lengths
        return kv

    with _session(units, tmp_store_root, compute, batch=2, max_seq=64,
                  bucket=16) as s:
        kv = drive(s)
        ref = [s.decode_step_slots(kv, w[:, j:j + 1]) for j in range(3)]
        kv.close()
        kv = drive(s)
        lens = {slot: kv.slot_length(slot) for slot in sorted(kv.active)}
        vlg = s.verify_step_slots(kv, w)
        for j in range(3):
            np.testing.assert_array_equal(vlg[:, j], ref[j])
        assert {slot: kv.slot_length(slot)
                for slot in sorted(kv.active)} == lens
        kv.close()


def test_generate_spec_matches_plain_greedy_and_reference(units,
                                                          tmp_store_root):
    """fp32: the port's speculative tokens equal its plain greedy tokens
    and the reference's speculative tokens, committing more than one token
    per streamed pass; bf16: spec equals plain within the port."""
    rng = np.random.default_rng(1)
    prompt = np.tile(rng.integers(3, 40, 6), 4)[None].repeat(2, axis=0)
    kw = dict(batch=2, max_seq=96, bucket=16)
    jpol = (JPolicy.preset("memascend").with_store(tmp_store_root + "/j")
            .with_adam(compute_dtype="float32").build())
    with JDecoder(jax_lm(JCFG, jax.random.PRNGKey(0), jnp.float32), jpol,
                  decode=JSpec(**kw)) as dec:
        ref = dec.generate(prompt.astype(np.int32), 32,
                           spec=JSpecConfig(k=4))
    for compute in ("float32", "bfloat16"):
        model = from_numpy_units(TCFG, units, getattr(torch, compute),
                                 device="cpu")
        with OffloadedDecoder(model, _policy(tmp_store_root + "/" + compute,
                                             compute),
                              decode=DecodeSpec(**kw)) as dec:
            plain = dec.generate(prompt, 32)
            fast = dec.generate(prompt, 32, spec=SpecConfig(k=4))
            st = dec.spec_stats
        np.testing.assert_array_equal(fast, plain)
        assert st.rounds < 31 and st.accepted_per_step > 1.0
        assert st.committed_tokens == 31 * 2
        if compute == "float32":
            np.testing.assert_array_equal(fast, ref)


def test_generate_spec_rejects_uncached(units, tmp_store_root):
    model = from_numpy_units(TCFG, units, torch.float32, device="cpu")
    with OffloadedDecoder(model, _policy(tmp_store_root, "float32"),
                          decode=DecodeSpec(batch=1, max_seq=32,
                                            bucket=8)) as dec, \
            pytest.raises(ValueError, match="cached"):
        dec.generate(np.ones((1, 4), np.int32), 4, use_cache=False,
                     spec=SpecConfig())


def test_verify_validation(units, tmp_store_root):
    with _session(units, tmp_store_root, "float32", batch=2, max_seq=16,
                  bucket=8) as s:
        kv = s.open_kv_cache()
        with pytest.raises(RuntimeError, match="before prefill"):
            s.verify_step(kv, np.ones((2, 2), np.int32))
        s.prefill(kv, np.ones((2, 12), np.int32))
        with pytest.raises(ValueError, match="verify window"):
            s.verify_step(kv, np.ones((2, 0), np.int32))
        with pytest.raises(ValueError, match="KV cache full"):
            s.verify_step(kv, np.ones((2, 5), np.int32))    # 12 + 8 > 16
        kv.close()
