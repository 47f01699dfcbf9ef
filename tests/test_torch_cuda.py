"""The port on the card: the CUDA kernel against its plain version, the
page-locked allocator backings, and cached decode on the device.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device.  The file imports neither JAX nor the reference package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference sweep's (``tests/test_kernels.py``): fp32
atol 2e-5 (same math, other summation order), bf16 atol 3e-2 (one bf16
rounding of outputs of magnitude ~1).  fp32 products run without TF32.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (AlignmentFreeAllocator, DecodeSpec,
                              MemoryTracker, OffloadPolicy,
                              PowerOfTwoCachingAllocator)
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.kernels.swa_attention import (swa_attention_cuda,
                                               swa_attention_plain)
from repro_torch.serve import OffloadedDecoder

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, h, kh, s, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dtype).cuda()
                 for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))


def _check(q, k, v, dtype, **kw):
    out = swa_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = swa_attention_plain(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [0, 64, 128])
def test_kernel_matches_plain_sweep(cuda, dtype, h, kh, window):
    _check(*_qkv(2, h, kh, 256, 32, dtype), dtype, window=window)


@pytest.mark.parametrize("s,d,window,causal", [
    (128, 16, 0, False), (77, 64, 32, True), (200, 128, 0, True),
    (130, 256, 64, False)])
def test_kernel_non_causal_and_ragged_lengths(cuda, s, d, window, causal):
    for dtype in TOL:
        _check(*_qkv(1, 4, 2, s, d, dtype), dtype, window=window,
               causal=causal)


def test_kernel_takes_transposed_views_and_counts_launches(cuda):
    """gqa_prefill's call: (B, S, H, D) activations passed as (B, H, S, D)
    views; the output keeps q's layout, and each launch counts once."""
    q, k, v = _qkv(2, 8, 2, 96, 128, torch.bfloat16)
    qv, kv_, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    before = swa_attention_cuda.launches
    out = swa_attention_cuda(qv, kv_, vv)
    assert swa_attention_cuda.launches == before + 1
    assert out.stride() == qv.stride()
    ref = swa_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 2, 1, 16, 16, torch.float32)
    with pytest.raises(TypeError):
        swa_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="head_dim"):
        swa_attention_cuda(*_qkv(1, 2, 1, 16, 24, torch.float32))
    with pytest.raises(ValueError, match="unit stride"):
        swa_attention_cuda(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="CUDA"):
        swa_attention_cuda(q.cpu(), k.cpu(), v.cpu())


@pytest.mark.parametrize("cls", [AlignmentFreeAllocator,
                                 PowerOfTwoCachingAllocator])
def test_cuda_backing_is_page_locked(cuda, cls):
    a = cls(tracker=MemoryTracker(), component="p", backing="cuda")
    buf = a.alloc(3 * 4096 + 5)
    view = buf.view(np.float32, (100,))
    view[:] = np.arange(100)
    host = torch.from_numpy(view)
    assert host.is_pinned()
    dev = host.to(cuda, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(dev.cpu(), host)
    if cls is AlignmentFreeAllocator:
        assert buf.array.ctypes.data % 4096 == 0
    buf.free()


def test_cached_decode_on_the_card_matches_the_cpu(cuda, tmp_path):
    """fp32 greedy tokens of the tiny model on the card equal the port's
    CPU run, and each prefill launches the kernel once per block."""
    cfg = ModelConfig(name="tiny", family="dense", n_layers=3, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      qk_norm=True)
    prompts = np.random.default_rng(0).integers(3, 256, size=(2, 6))
    out = {}
    for dev in ("cpu", "cuda"):
        model = make_offloadable_lm(cfg, 0, torch.float32, device=dev)
        policy = (OffloadPolicy.preset("memascend")
                  .with_store(str(tmp_path / dev))
                  .with_adam(compute_dtype="float32").build())
        with OffloadedDecoder(model, policy, decode=DecodeSpec(
                batch=2, max_seq=32, bucket=8, resident_pages=2)) as dec:
            before = swa_attention_cuda.launches
            out[dev] = dec.generate(prompts, 8)
            launched = swa_attention_cuda.launches - before
        assert launched == (cfg.n_layers if dev == "cuda" else 0)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
