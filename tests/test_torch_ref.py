"""The port's kernel oracles (:mod:`repro_torch.kernels.ref`) against the
reference's (:mod:`repro.kernels.ref`) on the same numpy inputs, and
against the kernels' own plain versions on the CPU; and the static
concurrency analyzer over the port's sources."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_adam import fused_adam_plain
from repro_torch.kernels.swa_attention import swa_attention_plain

REPO = Path(__file__).resolve().parent.parent
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("poison", [None, np.inf, -np.inf, np.nan])
def test_overflow_oracle_equals_the_reference(dtype, poison):
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    if poison is not None:
        x[617] = poison
    jx, tx = _both(x, dtype)
    got = tref.ref_overflow_check(tx)
    assert got.dtype == torch.bool and got.ndim == 0
    assert bool(got) == bool(jref.ref_overflow_check(jx)) == \
        (poison is not None)
    assert bool(got) == ops.overflow_check(tx)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float16", "float32"])
def test_adam_oracle_equals_the_reference(weight_decay, out_dtype):
    """fp32 math: within 2 ULPs of each other's outputs (the same formula;
    jnp and torch may fuse or order the scalar work differently); the
    16-bit copies equal after rounding those."""
    rng = np.random.default_rng(1)
    p, g, m = (rng.standard_normal(4096).astype(np.float32)
               for _ in range(3))
    v = np.abs(rng.standard_normal(4096)).astype(np.float32)
    kw = dict(lr=3e-3, weight_decay=weight_decay)
    jout = jref.ref_fused_adam(*(jnp.asarray(a) for a in (p, g, m, v)), 7,
                               out_dtype=DTYPES[out_dtype][0], **kw)
    tout = tref.ref_fused_adam(*(torch.from_numpy(a) for a in (p, g, m, v)),
                               7, out_dtype=DTYPES[out_dtype][1], **kw)
    for j, t in zip(jout[:3], tout[:3], strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.4e-7,
                                   atol=0)
    assert tout[3].dtype == DTYPES[out_dtype][1]
    np.testing.assert_array_equal(tout[3].float().numpy(),
                                  tout[0].to(tout[3].dtype).float().numpy())
    # and the kernel's plain version agrees with the oracle
    plain = fused_adam_plain(*(torch.from_numpy(a) for a in (p, g, m, v)),
                             7, out_dtype=DTYPES[out_dtype][1], **kw)
    for a, b in zip(plain[:3], tout[:3], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,causal", [(0, True), (16, True),
                                           (0, False), (16, False)])
def test_attention_oracle_equals_the_reference(dtype, window, causal):
    """fp32: atol 2e-5 (the reference sweep's); bf16: one bf16 rounding of
    outputs of magnitude ~1 (atol 3e-2)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 48, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 48, 32)).astype(np.float32)
            for _ in range(2))
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    atol = 2e-5 if dtype == "float32" else 3e-2
    want = np.asarray(jref.ref_swa_attention(jq, jk, jv, window=window,
                                             causal=causal), np.float32)
    got = tref.ref_swa_attention(tq, tk, tv, window=window, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    plain = swa_attention_plain(tq, tk, tv, window=window, causal=causal)
    np.testing.assert_allclose(plain.float().numpy(), got.float().numpy(),
                               atol=atol, rtol=0)


def test_analyzer_finds_nothing_in_the_port():
    """``python -m tools.analyze src/repro_torch`` (no baseline) is clean."""
    out = subprocess.run(
        [sys.executable, "-m", "tools.analyze", "src/repro_torch",
         "--no-baseline"], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stderr
