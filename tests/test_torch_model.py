"""The port's model math against the reference package's, on the same
numpy weights and inputs.

Tolerances, stated with their reasons:

* fp32: |port - jax| <= 1e-5 x the output's max magnitude.  Same math;
  only reduction order differs between XLA and torch.
* bf16, elementwise (rms_norm, apply_rope): one bf16 ULP of each element
  (2^-8 relative).  Both frameworks round after the same ops; an fp32
  statistic that differs in its last bit can flip one rounding.
* bf16, with products (gated_mlp, gqa_step, head_logits): 4 bf16 ULPs of
  each row's max.  Both accumulate in fp32 and round once per product,
  but the intermediate bf16 activations can round apart by one ULP and
  the next product carries that on.
* bf16, attention prefill and whole blocks: 8 bf16 ULPs of each row's max
  — the repo's decode-audit bound (``benchmarks/bench_decode.py``).  Here
  the reference rounds the softmax probabilities to bf16 before the PV
  product (``attention_scores``) while the port's kernel keeps them in
  fp32, a documented difference of the two attention paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.models import attention as jatt
from repro.models import layers as jlay
from repro_torch.configs.base import ModelConfig
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlay

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256, qk_norm=True)
JCFG, TCFG = JConfig(**KW), ModelConfig(**KW)
ULP = 2.0 ** -8
DTYPES = ["float32", "bfloat16"]


def _t(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, ref, dtype, ulps):
    """fp32: 1e-5 of the output's scale.  bf16: ``ulps`` bf16 ULPs of each
    row's max (``ulps=0`` means one ULP of each element)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if dtype == "float32":
        bound = 1e-5 * max(float(np.abs(ref).max()), 1.0)
        assert np.abs(got - ref).max() <= bound
        return
    if ulps == 0:
        bound = ULP * np.maximum(np.abs(got), np.abs(ref)) + 1e-30
    else:
        bound = ulps * ULP * np.maximum(
            np.abs(ref).max(axis=-1, keepdims=True), 1e-3)
    diff = np.abs(got - ref)
    assert (diff <= bound).all(), float((diff / bound).max())


@pytest.fixture(scope="module")
def units():
    return jax_lm(JCFG, jax.random.PRNGKey(0)).units


def _params(units, i, dtype):
    p = units[i].params
    # zero-initialised norms would hide a (1 + w) scaling slip: perturb them
    rng = np.random.default_rng(i)
    p = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             if "norm" in k else v) for k, v in p.items()}
    return ({k: _j(v, dtype) for k, v in p.items()},
            {k: _t(v, dtype) for k, v in p.items()})


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype, rng):
    x = 3.0 * rng.standard_normal((2, 5, 64))
    w = 0.1 * rng.standard_normal(64)
    assert_close(tlay.rms_norm(_t(x, dtype), _t(w, dtype)),
                 jlay.rms_norm(_j(x, dtype), _j(w, dtype)), dtype, 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype, rng):
    x = rng.standard_normal((2, 7, 4, 16))
    pos = np.broadcast_to(np.arange(3, 10), (2, 7))
    got = tlay.apply_rope(_t(x, dtype), torch.from_numpy(pos.copy()), 1e6)
    ref = jlay.apply_rope(_j(x, dtype), jnp.asarray(pos), 1e6)
    assert_close(got, ref, dtype, 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_mlp(dtype, rng):
    x = rng.standard_normal((2, 5, 64))
    wu, wg = (rng.standard_normal((64, 128)) / 8 for _ in range(2))
    wd = rng.standard_normal((128, 64)) / 11
    got = tlay.gated_mlp(_t(x, dtype), _t(wu, dtype), _t(wd, dtype),
                         "swiglu", w_gate=_t(wg, dtype))
    ref = jlay.gated_mlp(_j(x, dtype), _j(wu, dtype), _j(wd, dtype),
                         "swiglu", w_gate=_j(wg, dtype))
    assert_close(got, ref, dtype, 4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_prefill(dtype, units, rng):
    jp, tp = _params(units, 1, dtype)
    x = rng.standard_normal((2, 24, 64))
    got = tatt.gqa_prefill(tp, _t(x, dtype), TCFG)
    ref = jax.jit(jatt.gqa_prefill, static_argnums=2)(jp, _j(x, dtype), JCFG)
    for g, r, ulps in zip(got, ref, (8, 1, 1), strict=True):
        assert_close(g, r, dtype, ulps)


def _cache(rng, s_bucket, dtype):
    k = rng.standard_normal((2, s_bucket, 2, 16))
    v = rng.standard_normal((2, s_bucket, 2, 16))
    return k, v


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_step(dtype, units, rng):
    jp, tp = _params(units, 1, dtype)
    x = rng.standard_normal((2, 1, 64))
    k, v = _cache(rng, 16, dtype)
    got = tatt.gqa_step(tp, _t(x, dtype), TCFG, _t(k, dtype), _t(v, dtype),
                        torch.tensor(11), chunk=8)
    ref = jax.jit(jatt.gqa_step, static_argnums=2, static_argnames="chunk")(
        jp, _j(x, dtype), JCFG, _j(k, dtype), _j(v, dtype),
        jnp.asarray(11, jnp.int32), chunk=8)
    for g, r in zip(got, ref, strict=True):
        assert_close(g, r, dtype, 4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_step_chunked_rows_invariant_to_extent(dtype, units, rng):
    """The ``chunk`` contract: the same row gives bitwise-identical output
    whether the device cache extends to 16 or to 40 positions (garbage
    past the length is masked exactly)."""
    _jp, tp = _params(units, 1, dtype)
    x = _t(rng.standard_normal((2, 1, 64)), dtype)
    k, v = _cache(rng, 40, dtype)
    k[:, 11:] = 1e4 * rng.standard_normal(k[:, 11:].shape)   # garbage
    short = tatt.gqa_step(tp, x, TCFG, _t(k[:, :16], dtype),
                          _t(v[:, :16], dtype), torch.tensor(11), chunk=8)
    long = tatt.gqa_step(tp, x, TCFG, _t(k, dtype), _t(v, dtype),
                         torch.tensor(11), chunk=8)
    for a, b in zip(short, long, strict=True):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def models(units):
    out = {}
    for dtype in DTYPES:
        jm = jax_lm(JCFG, jax.random.PRNGKey(0),
                    compute_dtype=getattr(jnp, dtype))
        tm = from_numpy_units(TCFG, units, getattr(torch, dtype),
                              device="cpu")
        out[dtype] = (jm, tm)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_prefill_and_step(dtype, units, models, rng):
    jm, tm = models[dtype]
    jp, tp = _params(units, 2, dtype)
    h = rng.standard_normal((2, 16, 64))
    got = tm.block_prefill(tp, _t(h, dtype))
    ref = jax.jit(jm.block_prefill)(jp, _j(h, dtype))
    for g, r, ulps in zip(got, ref, (8, 1, 1), strict=True):
        assert_close(g, r, dtype, ulps)
    # one step against the prefill's own cache (positions >= 12 garbage)
    x = rng.standard_normal((2, 1, 64))
    got = tm.block_step(tp, _t(x, dtype), got[1], got[2], torch.tensor(12),
                        chunk=8)
    ref = jax.jit(jm.block_step, static_argnames="chunk")(
        jp, _j(x, dtype), ref[1], ref[2], jnp.asarray(12, jnp.int32),
        chunk=8)
    for g, r in zip(got, ref, strict=True):
        assert_close(g, r, dtype, 8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_and_head_logits(dtype, units, models, rng):
    jm, tm = models[dtype]
    tokens = rng.integers(0, 256, size=(2, 5))
    jp, tp = _params(units, 0, dtype)
    assert_close(tm.embed_apply(tp, torch.from_numpy(tokens)),
                 jm.embed_apply(jp, jnp.asarray(tokens)), dtype, 0)
    jp, tp = _params(units, len(units) - 1, dtype)
    h = rng.standard_normal((2, 3, 64))
    got = tm.head_logits(tp, _t(h, dtype))
    assert got.dtype == torch.float32
    assert_close(got, jm.head_logits(jp, _j(h, dtype)), dtype, 4)
