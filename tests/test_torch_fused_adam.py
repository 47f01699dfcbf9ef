"""The fused AdamW step: the port's plain version against the reference
package's oracle (``repro.kernels.ref.ref_fused_adam``) and its Pallas
kernel (``repro.kernels.ops.fused_adam``, interpreted on the CPU as
``tests/test_kernels.py`` runs it), on the same numpy inputs, at the
reference sweep's tolerances: p, m, v within rtol 2e-5 / atol 1e-6 and
the bf16 ``w16`` bit-exact; the five-step trajectory within rtol 1e-4; the
hypothesis property within rtol 1e-4 with v >= 0.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.fused_adam import (adam_constants, fused_adam_cuda,
                                            fused_adam_plain)

torch.set_num_threads(2)

_OUT = {"bfloat16": (torch.bfloat16, jnp.bfloat16, np.uint16),
        "float16": (torch.float16, jnp.float16, np.uint16),
        "float32": (torch.float32, jnp.float32, np.uint32)}


def _inputs(shape, rng, *, moments=True):
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    if moments:
        m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        v = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    else:
        m = np.zeros(shape, np.float32)
        v = np.zeros(shape, np.float32)
    return p, g, m, v


def _port(arrs, step, **kw):
    out = ops.fused_adam(*(torch.from_numpy(a.copy()) for a in arrs), step,
                         **kw)
    return [t.float().numpy() if i < 3 else t for i, t in enumerate(out)]


def _bits(t: torch.Tensor, as_np) -> np.ndarray:
    view = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32}[t.dtype]
    return t.view(view).numpy().view(as_np)


@pytest.mark.parametrize("shape", [(16,), (100, 3), (8, 8, 9), (2048,)])
@pytest.mark.parametrize("step", [1, 10, 1000])
def test_adam_sweep_matches_reference_and_pallas(shape, step, rng):
    arrs = _inputs(shape, rng)
    kw = dict(lr=3e-3, weight_decay=0.05)
    got = _port(arrs, step, **kw)
    jin = [jnp.asarray(a) for a in arrs]
    for want in (ref.ref_fused_adam(*jin, step, **kw),
                 jops.fused_adam(*jin, step, **kw)):
        for a, b in zip(got[:3], want[:3], strict=True):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5,
                                       atol=1e-6)
        np.testing.assert_array_equal(
            _bits(got[3], np.uint16), np.asarray(want[3]).view(np.uint16))


@pytest.mark.parametrize("out_dtype", sorted(_OUT))
def test_adam_out_dtypes_match_reference(out_dtype, rng):
    t_dtype, j_dtype, bits = _OUT[out_dtype]
    arrs = _inputs((129,), rng)
    got = _port(arrs, 7, lr=1e-3, out_dtype=t_dtype)
    want = ref.ref_fused_adam(*(jnp.asarray(a) for a in arrs), 7, lr=1e-3,
                              out_dtype=j_dtype)
    assert got[3].dtype == t_dtype and got[3].shape == (129,)
    np.testing.assert_array_equal(_bits(got[3], bits),
                                  np.asarray(want[3]).view(bits))


def test_adam_multi_step_trajectory(rng):
    p, g0, m, v = _inputs((512,), rng, moments=False)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    jp, jm, jv = (jnp.asarray(a) for a in (p, m, v))
    for t in range(1, 6):
        g = g0 * np.float32(0.9 ** t)
        tp, tm, tv, _ = ops.fused_adam(tp, torch.from_numpy(g), tm, tv, t,
                                       lr=1e-2)
        jp, jm, jv, _ = ref.ref_fused_adam(jp, jnp.asarray(g), jm, jv, t,
                                           lr=1e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-6)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(min_value=1, max_value=5000),
       lr=st.floats(min_value=1e-5, max_value=1e-1),
       step=st.integers(min_value=1, max_value=10_000),
       seed=st.integers(min_value=0, max_value=2**31))
def test_adam_property(n, lr, step, seed):
    p, g, m, v = _inputs((n,), np.random.default_rng(seed), moments=False)
    p2, _m2, v2, _w = _port((p, g, m, v), step, lr=lr)
    pr, _mr, _vr, _ = ref.ref_fused_adam(
        *(jnp.asarray(a) for a in (p, g, m, v)), step, lr=lr)
    np.testing.assert_allclose(p2, np.asarray(pr), rtol=1e-4, atol=1e-7)
    assert float(v2.min()) >= 0.0


@pytest.mark.parametrize("step", [1, 2, 10, 1000, 2958, 10_000])
def test_bias_terms_are_the_references_fp32_power(step):
    """1 - beta**t in fp32 as ``ref_fused_adam`` computes it."""
    c = adam_constants(step, lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                       weight_decay=0.0)
    t = jnp.asarray(step, jnp.float32)
    for beta, got in ((0.9, c.bias1), (0.999, c.bias2)):
        want = float(1.0 - beta ** t)
        assert abs(got - want) <= 1.2e-7 * want


def test_dispatch_routes_by_device():
    """CPU tensors reach the plain version; the kernel's launch count does
    not move; a CUDA tensor on a host without a card never falls back;
    meta tensors outside a dry run raise."""
    arrs = [torch.from_numpy(a) for a in
            _inputs((33,), np.random.default_rng(0))]
    before = fused_adam_cuda.launches
    got = ops.fused_adam(*arrs, 3, weight_decay=0.01)
    want = fused_adam_plain(*arrs, 3, weight_decay=0.01)
    assert fused_adam_cuda.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    with pytest.raises(RuntimeError, match="outside a dry run"):
        ops.fused_adam(*(a.to("meta") for a in arrs), 1)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam_cuda(*arrs, 1)
    with pytest.raises(TypeError, match="out_dtype"):
        fused_adam_plain(*arrs, 1, out_dtype=torch.int8)
