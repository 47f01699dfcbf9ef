"""The port's banded attention against the reference package's.

On the CPU the port's dispatcher takes the kernel's plain version
(``swa_attention_plain``); it is held to the Pallas kernel run in interpret
mode (``repro.kernels.ops.swa_attention``, as ``tests/test_kernels.py`` runs
it) and to the reference oracle ``ref_swa_attention``, over the
reference's sweep and tolerances: fp32 atol 2e-5 (same math, other
summation order), bf16 atol 3e-2 (one bf16 rounding of outputs of
magnitude ~1).  The CUDA kernel's own sweep on the card is in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.swa_attention import swa_attention_plain

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(rng, b, h, kh, s, d):
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kh, s, d)).astype(np.float32),
            rng.standard_normal((b, kh, s, d)).astype(np.float32))


def _port(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return ops.swa_attention(q, k, v, **kw).float().numpy()


def _jax(fn, arrays, dtype, **kw):
    q, k, v = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    return np.asarray(fn(q, k, v, **kw), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [0, 64, 128])
def test_plain_matches_reference_sweep(dtype, h, kh, window, rng):
    arrays = _inputs(rng, 2, h, kh, 256, 32)
    got = _port(arrays, dtype, window=window)
    pallas = _jax(jops.swa_attention, arrays, dtype, window=window,
                  block_q=64, block_k=64)
    oracle = _jax(jref.ref_swa_attention, arrays, dtype, window=window)
    np.testing.assert_allclose(got, pallas, atol=TOL[dtype])
    np.testing.assert_allclose(got, oracle, atol=TOL[dtype])


def test_plain_matches_reference_non_causal(rng):
    arrays = _inputs(rng, 1, 2, 2, 128, 16)
    got = _port(arrays, "float32", window=0, causal=False)
    pallas = _jax(jops.swa_attention, arrays, "float32", window=0,
                  causal=False, block_q=64, block_k=64)
    np.testing.assert_allclose(got, pallas, atol=2e-5)


def test_plain_handles_lengths_no_tile_divides(rng):
    """The Pallas kernel needs S divisible by its blocks; the port does not
    (the CUDA kernel masks its ragged edge).  Checked against the oracle."""
    arrays = _inputs(rng, 1, 4, 2, 77, 16)
    got = _port(arrays, "float32", window=32)
    oracle = _jax(jref.ref_swa_attention, arrays, "float32", window=32)
    np.testing.assert_allclose(got, oracle, atol=2e-5)


def test_dispatch_rejects_other_devices():
    q = torch.zeros((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.swa_attention(q, q, q)


def test_output_keeps_input_dtype(rng):
    arrays = _inputs(rng, 1, 2, 1, 8, 16)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    assert swa_attention_plain(q, k, v).dtype == torch.bfloat16
