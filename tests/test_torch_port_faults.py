"""Regression tests of two repaired port faults, at bf16 on the CPU unless
named otherwise.

**Cached and uncached decode compute one attention function.**  The
port's ``gqa_prefill`` once attended through the hand-written kernel
(fp32 probabilities) while the uncached full-prefix pass ran
``attention_scores`` (bf16 probabilities); the reference runs
``attention_scores`` in both.  Now the prefill's logits equal the
uncached pass's first-step logits bit for bit
(``tests/test_torch_offloaded_decode.py``) and the reference's
cached-vs-uncached cases (``tests/test_offloaded_decode.py``) are held
here on the reference's model, prompts and specs (``decode_logits``
equal between train- and serve-mode sessions is
``tests/test_torch_session.py``'s).

The reference compares free-running greedy tokens.  A cached step's
logits are not bitwise the full-prefix pass's in either package (the
step's chunked two-pass softmax and (B, 1) products sum in another order:
up to ~0.04 of the logits on this model, in the reference as in the
port), so the two paths agree token for token only while no step is a
near-tie.  On the reference's own data, step 1's top two uncached logits
of row 0 tie exactly (margin 0.0) in the reference; the port's bf16
logits lie within 2 ULPs of the reference's (XLA and torch round bf16
``silu`` differently) and break that tie the other way, after which the
free-running sequences part.  So every step here is teacher-forced on the
uncached path's greedy tokens: the cached argmax must equal the uncached
one wherever the uncached top-two margin exceeds 8 bf16 ULPs of the row
max (the repo's decode-audit bound, ``benchmarks/bench_decode.py``), and
the cached logits must lie within that bound of the uncached ones.

**The KV page's dtype.**  ``_write_kv`` handed the model's K/V to the
cache in the model's dtype; the host form of bf16 is ``uint16`` bits, so
an fp32 model's values were converted into bf16 pages as integers, and a
bf16 model's bits into fp32 pages as values.  K/V are now cast on the
device to the pages' dtype first: under both mismatches the cached greedy
tokens equal the reference's under the same mismatch, compared
free-running (no step of this model is a near-tie under either
mismatch).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import DecodeSpec as JSpec, OffloadPolicy as JPolicy
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.serve import OffloadedDecoder as JDecoder
from repro_torch.configs.base import ModelConfig
from repro_torch.core import DecodeSpec, OffloadPolicy, memascend_policy
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.serve import OffloadedDecoder

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", n_layers=3, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256)
JCFG, CFG = JConfig(**KW), ModelConfig(**KW)
ULP_TOL = 8.0 * 2.0 ** -8


def _units(dtype=jnp.bfloat16):
    return jax_lm(JCFG, jax.random.PRNGKey(0), dtype).units


def _model(dtype=torch.bfloat16, units=None):
    return from_numpy_units(CFG, units or _units(), dtype, device="cpu")


def _prompts(batch=2, seq=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(3, CFG.vocab, size=(batch, seq), dtype=np.int32)


def _teacher_forced(dec, prompts, new):
    """Per step, the uncached pass's logits on the uncached path's own
    greedy context, and the cached path's logits fed the same tokens."""
    s = dec.session
    ctx, uncached = prompts, []
    for _ in range(new):
        uncached.append(s.decode_logits(ctx)[:, -1])
        ctx = np.concatenate(
            [ctx, uncached[-1].argmax(-1).astype(np.int32)[:, None]], 1)
    kv = s.open_kv_cache()
    try:
        cached = [s.prefill(kv, prompts)]
        for t in range(new - 1):
            cached.append(s.decode_step(
                kv, ctx[:, prompts.shape[1] + t][:, None]))
    finally:
        kv.close()
    return cached, uncached


def _assert_same_greedy(cached, uncached):
    for t, (c, u) in enumerate(zip(cached, uncached, strict=True)):
        scale = np.maximum(np.abs(u).max(-1, keepdims=True), 1.0)
        assert (np.abs(c - u) / scale).max() <= ULP_TOL, f"step {t}"
        top2 = np.sort(u, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > ULP_TOL * scale[:, 0]
        np.testing.assert_array_equal(c.argmax(-1)[clear],
                                      u.argmax(-1)[clear], f"step {t}")
    # the prompt pass is the uncached first step, bit for bit
    np.testing.assert_array_equal(cached[0], uncached[0])


# -- cached vs uncached (tests/test_offloaded_decode.py, translated) ----------

@pytest.mark.parametrize("spec_kw", [
    {},                        # every page resident
    {"resident_blocks": 2},    # layer-equivalent budget
    {"resident_pages": 2},     # minimum paged budget: heavy spill traffic
    {"page_tokens": 4, "resident_pages": 3},   # pages finer than buckets
    {"page_tokens": 32, "resident_blocks": 2},  # whole-layer pages
])
def test_cached_matches_uncached_argmax(tmp_store_root, spec_kw):
    """Cached decode (all-resident and spilling, across page sizes and
    budgets) picks the full-prefix path's greedy token at every step
    that is not a near-tie, teacher-forced on that path's tokens."""
    prompts = _prompts()
    spec = DecodeSpec(batch=2, max_seq=32, bucket=8, **spec_kw)
    with OffloadedDecoder(_model(), memascend_policy(tmp_store_root,
                                                     lr=1e-3),
                          decode=spec) as dec:
        cached, uncached = _teacher_forced(dec, prompts, 8)
    _assert_same_greedy(cached, uncached)


def test_use_cache_false_forces_uncached_path(tmp_store_root):
    prompts = _prompts()
    spec = DecodeSpec(batch=2, max_seq=32, bucket=8)
    with OffloadedDecoder(_model(), memascend_policy(tmp_store_root,
                                                     lr=1e-3),
                          decode=spec) as dec:
        cached = dec.generate(prompts, 4)
        stats = dec.kv_stats
        assert stats is not None   # the cached run recorded stats
        runs = {}
        real_execute = dec.session.execute

        def counting(plan, state):
            runs[plan.name] = runs.get(plan.name, 0) + 1
            return real_execute(plan, state)

        dec.session.execute = counting
        uncached = dec.generate(prompts, 4, use_cache=False)
        dec.session.execute = real_execute
        # one full-prefix pass per token, no cached plan, no KV traffic
        assert runs == {"decode": 4} and dec.kv_stats is stats
        ctx = np.concatenate([prompts, uncached[:, :3]], axis=1)
        want = [dec.step_logits(ctx[:, :6 + t]).argmax(-1) for t in range(4)]
        np.testing.assert_array_equal(uncached, np.stack(want, axis=1))
        np.testing.assert_array_equal(uncached[:, 0], cached[:, 0])


# -- the KV page's dtype ------------------------------------------------------

@pytest.mark.parametrize("model_dtype,policy_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_kv_pages_take_the_policy_dtype(tmp_store_root, model_dtype,
                                        policy_dtype):
    """A model computing in one dtype under a policy whose compute (and
    KV page) dtype is the other: the cached tokens equal the reference's
    under the same mismatch, with no numpy cast warning."""
    units = _units(getattr(jnp, model_dtype))
    prompts = _prompts()
    spec = dict(batch=2, max_seq=32, bucket=8)
    jpol = (JPolicy.preset("memascend").with_store(tmp_store_root + "/j")
            .with_adam(compute_dtype=policy_dtype).build())
    with JDecoder(jax_lm(JCFG, jax.random.PRNGKey(0),
                         getattr(jnp, model_dtype)),
                  jpol, decode=JSpec(**spec)) as dec:
        ref = dec.generate(prompts, 8)
    pol = (OffloadPolicy.preset("memascend").with_store(tmp_store_root + "/t")
           .with_adam(compute_dtype=policy_dtype).build())
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        with OffloadedDecoder(_model(getattr(torch, model_dtype), units),
                              pol, decode=DecodeSpec(**spec)) as dec:
            got = dec.generate(prompts, 8)
            kv = dec.session.open_kv_cache()
            try:
                assert kv.dtype == pol.adam.compute_np_dtype
            finally:
                kv.close()
    np.testing.assert_array_equal(got, ref)
