"""The tensor-core attention kernel's arithmetic, emulated on the CPU, and
its wrapper's host-side rules.

The CUDA kernel (``repro_torch/csrc/swa_attention.cu``, ``tc`` namespace)
runs only on the card.  :func:`emulate_tc` repeats its roundings in torch:
bf16/fp16 operands multiplied exactly and summed in fp32, the scale (times
log2 e) applied to the fp32 scores after the product, masked scores at
-inf (an exact zero; the reference's -1e30 gives the same zero to every
row with a live key), an online softmax in the log2 domain over the
kernel's tiles (128 query rows; 128 keys at D <= 128, 64 at D 256), P
rounded to the input dtype before the P.V product while l sums the
unrounded probabilities, and the output normalised by the reciprocal of
max(l, 1e-30).  It is held to the
reference oracle ``ref_swa_attention`` and to the Pallas kernel in
interpret mode (as ``tests/test_kernels.py`` runs it) within the
reference's bf16 bound of 3e-2; fp16 gets 1e-2 (its ULP is 8x finer than
bf16's; 1e-2 still covers a one-ULP output flip at |o| in [4, 8)).  A
tiny qwen3-like model's prefill logits through the emulated attention stay
within the repo's 8 row-max bf16-ULP bound of the reference's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import OffloadPolicy as JPolicy
from repro.core.kv_cache import DecodeSpec as JSpec
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import OffloadedDecoder as JDecoder
from repro_torch.configs.base import ModelConfig
from repro_torch.core import DecodeSpec, OffloadPolicy
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.kernels import ops
from repro_torch.kernels.swa_attention import (HEAD_DIMS, attention_path,
                                               swa_attention_plain,
                                               tma_strides,
                                               validate_operands)
from repro_torch.serve import OffloadedDecoder

torch.set_num_threads(2)

TOL = {"bfloat16": 3e-2, "float16": 1e-2}
BLOCK_Q = 128
LOG2E = 1.4426950408889634
ULP_TOL = 8.0 * 2.0 ** -8


def emulate_tc(q, k, v, *, window: int = 0, causal: bool = True):
    """The tensor-core kernel's arithmetic on (B, H, S, D) x (B, KH, S, D)
    bf16/fp16 tensors; returns the output in q's dtype."""
    b, h, s, d = q.shape
    n_rep = h // k.shape[1]
    bk = 128 if d <= 128 else 64
    # the host passes 1/sqrt(D) as a C float and multiplies by log2 e there
    scale_log2 = float(np.float32(1.0 / math.sqrt(d)) * np.float32(LOG2E))
    qf = q.float()
    kf = k.float().repeat_interleave(n_rep, dim=1)
    vf = v.float().repeat_interleave(n_rep, dim=1)
    out = torch.empty(b, h, s, d)
    for q_lo in range(0, s, BLOCK_Q):
        q_hi = min(q_lo + BLOCK_Q, s)
        qpos = torch.arange(q_lo, q_hi)[:, None]
        k_begin = max(0, q_lo - window + 1) if window else 0
        k_end = q_hi if causal else s
        m = torch.full((b, h, q_hi - q_lo), -math.inf)
        l = torch.zeros(b, h, q_hi - q_lo)
        acc = torch.zeros(b, h, q_hi - q_lo, d)
        for k_lo in range(k_begin // bk * bk, k_end, bk):
            k_hi = min(k_lo + bk, s)
            kpos = torch.arange(k_lo, k_hi)[None, :]
            sc = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q_lo:q_hi],
                              kf[:, :, k_lo:k_hi])
            live = torch.ones(q_hi - q_lo, k_hi - k_lo, dtype=torch.bool)
            if causal:
                live &= kpos <= qpos
            if window:
                live &= kpos > qpos - window
            sc = torch.where(live, sc, torch.tensor(-math.inf))
            m_new = torch.maximum(m, sc.amax(-1) * scale_log2)
            # a row with no live key yet keeps m = -inf; its max counts as 0
            # where it is subtracted
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(sc * scale_log2 - m_use[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(q.dtype).float(),
                vf[:, :, k_lo:k_hi])
            m = m_new
        inv = 1.0 / l.clamp_min(1e-30)
        out[:, :, q_lo:q_hi] = acc * inv[..., None]
    return out.to(q.dtype)


def _inputs(rng, b, h, kh, s, d):
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kh, s, d)).astype(np.float32),
            rng.standard_normal((b, kh, s, d)).astype(np.float32))


def _jax(fn, arrays, dtype, **kw):
    q, k, v = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    return np.asarray(fn(q, k, v, **kw), np.float32)


def _emulated(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return emulate_tc(q, k, v, **kw).float().numpy()


def test_emulation_matches_reference_at_qwen3_widths(rng):
    """qwen3-4b's attention widths (H 32, KH 8, D 128) at the serving
    prompt (S 512), bf16, causal: four q tiles, up to four k tiles each."""
    arrays = _inputs(rng, 1, 32, 8, 512, 128)
    got = _emulated(arrays, "bfloat16")
    oracle = _jax(jref.ref_swa_attention, arrays, "bfloat16")
    pallas = _jax(jops.swa_attention, arrays, "bfloat16", block_q=128,
                  block_k=128)
    plain = swa_attention_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                                  for a in arrays)).float().numpy()
    for ref in (oracle, pallas, plain):
        np.testing.assert_allclose(got, ref, atol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("h,kh,s,d,window,causal", [
    (4, 4, 256, 64, 0, True),        # n_rep 1
    (8, 2, 384, 128, 128, True),     # n_rep 4, a band
    (8, 1, 320, 256, 0, True),       # n_rep 8, D 256 (64-key tiles)
    (4, 2, 640, 128, 500, True),     # a band wider than a tile
    (4, 2, 256, 128, 64, False),     # non-causal band
])
def test_emulation_matches_reference_sweep(dtype, h, kh, s, d, window,
                                           causal, rng):
    arrays = _inputs(rng, 2, h, kh, s, d)
    kw = dict(window=window, causal=causal)
    got = _emulated(arrays, dtype, **kw)
    np.testing.assert_allclose(
        got, _jax(jref.ref_swa_attention, arrays, dtype, **kw),
        atol=TOL[dtype])
    np.testing.assert_allclose(
        got, _jax(jops.swa_attention, arrays, dtype, block_q=64,
                  block_k=64, **kw), atol=TOL[dtype])


@pytest.mark.parametrize("s", [77, 200, 511, 513])
def test_emulation_ragged_lengths_match_the_oracle(s, rng):
    """Lengths no tile divides (the kernel's zero fill and masks); the
    Pallas kernel needs divisible lengths, so the oracle alone."""
    arrays = _inputs(rng, 1, 4, 1, s, 128)
    np.testing.assert_allclose(
        _emulated(arrays, "bfloat16"),
        _jax(jref.ref_swa_attention, arrays, "bfloat16"),
        atol=TOL["bfloat16"])


KW = dict(name="tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
          n_kv_heads=2, d_ff=256, vocab=256, qk_norm=True)


def test_tiny_model_prefill_logits_with_emulated_attention(
        monkeypatch, tmp_store_root):
    """A qwen3-like model (qk-norm, GQA 4/2, head_dim 32) prefilling a
    200-token prompt (padded to 256: two q tiles, two k tiles) through the
    emulated tensor-core attention: its bf16 logits within 8 bf16 ULPs of
    each row's max of the reference's prefill."""
    jmodel = jax_lm(JConfig(**KW), jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(3, 256, size=(2, 200),
                                                dtype=np.int32)
    spec = dict(batch=2, max_seq=320, bucket=64)
    jpol = JPolicy.preset("memascend").with_store(tmp_store_root + "/j")
    with JDecoder(jmodel, jpol.build(), decode=JSpec(**spec)) as dec:
        kv = dec.session.open_kv_cache()
        try:
            ref = np.asarray(dec.session.prefill(kv, prompts), np.float32)
        finally:
            kv.close()

    calls = []

    def attend(q, k, v, *, window=0, causal=True):
        calls.append(q.shape)
        return emulate_tc(q, k, v, window=window, causal=causal)

    monkeypatch.setattr(ops, "swa_attention", attend)
    model = from_numpy_units(ModelConfig(**KW), jmodel.units, torch.bfloat16,
                             device="cpu")
    policy = (OffloadPolicy.preset("memascend")
              .with_store(tmp_store_root + "/t")
              .with_adam(compute_dtype="bfloat16").build())
    with OffloadedDecoder(model, policy, decode=DecodeSpec(**spec)) as dec:
        kv = dec.session.open_kv_cache()
        try:
            got = dec.session.prefill(kv, prompts)
        finally:
            kv.close()
    assert calls == [(2, 4, 256, 32)] * KW["n_layers"]
    scale = np.maximum(np.abs(ref).max(-1, keepdims=True), 1.0)
    assert (np.abs(got - ref) / scale).max() <= ULP_TOL


# -- the wrapper's host-side rules ---------------------------------------------

@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "tensor_core"),
                                        (torch.float16, "tensor_core"),
                                        (torch.float32, "simt")])
def test_attention_path_by_dtype(dtype, path):
    assert attention_path(dtype) == path


def test_attention_path_refuses_other_dtypes():
    with pytest.raises(TypeError):
        attention_path(torch.float64)


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_tma_strides_take_contiguous_and_transposed_views(layout):
    """gqa_prefill's (B, S, H, D) activations pass as (B, H, S, D) views."""
    if layout == "contiguous":
        t = torch.zeros(2, 4, 40, 128, dtype=torch.bfloat16)
        want = (4 * 40 * 128, 40 * 128, 128)
    else:
        t = torch.zeros(2, 40, 4, 128, dtype=torch.bfloat16).transpose(1, 2)
        want = (40 * 4 * 128, 128, 4 * 128)
    assert tma_strides(t) == want


def test_tma_strides_replace_the_stride_of_a_size_one_dimension():
    """A size-1 dimension is never stepped: its stride may be anything."""
    t = torch.zeros(1, 1, 40, 64, dtype=torch.float16).as_strided(
        (1, 1, 40, 64), (3, 5, 64, 1))
    assert tma_strides(t) == (40 * 64, 40 * 64, 64)


@pytest.mark.parametrize("case,match", [
    ("base", "16-byte aligned"),
    ("seq", "seq stride"),
    ("head", "head stride"),
    ("batch", "batch stride"),
])
def test_tma_strides_refuse_what_tma_cannot_take(case, match):
    d, s, h = 64, 16, 2
    if case == "base":
        t = torch.zeros(h * s * d + 1, dtype=torch.bfloat16)[1:].view(
            1, h, s, d)
    elif case == "seq":                  # rows 68 elements = 136 bytes apart
        t = torch.zeros(1, h, s, 68, dtype=torch.bfloat16)[..., :d]
    elif case == "head":                 # heads 1028 elements apart
        t = torch.zeros(1, h, s * d + 4, dtype=torch.bfloat16)[
            ..., :s * d].unflatten(2, (s, d))
    else:                                # batch rows 2052 elements apart
        t = torch.zeros(2, h * s * d + 4, dtype=torch.bfloat16)[
            :, :h * s * d].unflatten(1, (h, s, d))
    with pytest.raises(ValueError, match=match):
        tma_strides(t, "q")


def test_validate_operands_shapes_and_head_dims():
    q = torch.zeros(2, 8, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 16, 128, dtype=torch.bfloat16)
    assert validate_operands(q, k, k) == (2, 8, 16, 128, 2)
    assert 128 in HEAD_DIMS and 96 not in HEAD_DIMS
    bad = torch.zeros(2, 8, 16, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        validate_operands(bad, bad[:, :2], bad[:, :2])
    with pytest.raises(ValueError, match="KH | H"):
        validate_operands(q, q[:, :3], q[:, :3])
    with pytest.raises(TypeError):
        validate_operands(q, k.float(), k)
    with pytest.raises(ValueError, match="window"):
        validate_operands(q, k, k, window=-1)
