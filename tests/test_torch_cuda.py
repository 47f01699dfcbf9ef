"""The port on the card: the CUDA kernels against their plain versions,
the page-locked allocator backings, cached and uncached decode,
continuous batching, speculative verify, the training step and MoE expert
paging on the device.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device.  The file imports neither JAX nor the reference package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference sweep's (``tests/test_kernels.py``): fp32
atol 2e-5 (same math, other summation order), bf16 atol 3e-2 (one bf16
rounding of outputs of magnitude ~1).  fp16 atol 1e-2: the tensor-core
kernel rounds P and the output to fp16, whose ULP is 8x finer than
bf16's, and 1e-2 still covers a one-ULP output flip at |o| in [4, 8)
(3.9e-3) on top of the P rounding.  fp32 products run without TF32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import (AlignmentFreeAllocator, DecodeSpec,
                              MemoryTracker, OffloadPolicy, OffloadSession,
                              PowerOfTwoCachingAllocator)
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.kernels import ops
from repro_torch.kernels.fused_adam import fused_adam_cuda, fused_adam_plain
from repro_torch.kernels.overflow_check import (overflow_check_cuda,
                                                overflow_check_plain,
                                                overflow_flag_cuda_)
from repro_torch.kernels.swa_attention import (swa_attention_cuda,
                                               swa_attention_plain)
from repro_torch.serve import (OffloadedDecoder, Request, ServingEngine,
                               SpecConfig)

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 1e-2}
TC_DTYPES = [torch.bfloat16, torch.float16]


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


@pytest.mark.parametrize("dtype", TC_DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2), (8, 1)])
def test_tc_kernel_head_dims_and_gqa(cuda, dtype, d, h, kh):
    """The tensor-core kernel at D 64/128/256 and n_rep 1/4/8, over more
    than one q tile and k tile (S 320)."""
    _check(*_qkv(2, h, kh, 320, d, dtype), dtype)


@pytest.mark.parametrize("dtype", TC_DTYPES)
@pytest.mark.parametrize("window", [0, 64, 128, 500])
def test_tc_kernel_windows(cuda, dtype, window):
    _check(*_qkv(1, 8, 2, 700, 128, dtype), dtype, window=window)


@pytest.mark.parametrize("dtype", TC_DTYPES)
@pytest.mark.parametrize("s", [77, 200, 511, 513])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_kernel_ragged_lengths_and_non_causal(cuda, dtype, s, causal):
    _check(*_qkv(1, 4, 1, s, 128, dtype), dtype, causal=causal,
           window=0 if causal else 96)


def test_kernel_paths_and_their_launch_counts(cuda):
    """bf16/fp16 take the tensor-core kernel, fp32 the SIMT kernel, on the
    transposed (B, S, H, D) views gqa_prefill passes; each launch counts
    once in the total and once in its path."""
    for dtype, path in ((torch.bfloat16, "tensor_core"),
                        (torch.float16, "tensor_core"),
                        (torch.float32, "simt")):
        q, k, v = _qkv(2, 8, 2, 150, 128, dtype)
        qv, kv_, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in (q, k, v))
        total = swa_attention_cuda.launches
        paths = dict(swa_attention_cuda.path_launches)
        out = swa_attention_cuda(qv, kv_, vv)
        assert swa_attention_cuda.launches == total + 1
        want = {p: n + (p == path) for p, n in paths.items()}
        assert swa_attention_cuda.path_launches == want
        assert out.stride() == qv.stride()
        ref = swa_attention_plain(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_tc_kernel_row_is_bitwise_independent_of_batch_and_padding(cuda):
    """A row's output depends only on its own (batch, head, position) and
    its live keys: the same at B 1 as at B 4 beside other rows, and the
    same when causal S is padded past it."""
    q, k, v = _qkv(4, 8, 2, 384, 128, torch.bfloat16, seed=5)
    full = swa_attention_cuda(q, k, v)
    alone = swa_attention_cuda(q[2:3], k[2:3], v[2:3])
    cut = swa_attention_cuda(*(t[:, :, :300].contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(full[2:3], alone)
    assert torch.equal(full[:, :, :300], cut)


def test_tc_kernel_rejects_what_tma_cannot_take(cuda):
    """An unaligned base or a seq stride that is not a multiple of 16
    bytes raises on the tensor-core path (no copy, no fallback); the SIMT
    path takes the same fp32 views."""
    n = 2 * 64 * 64
    for dtype in (torch.bfloat16, torch.float32):
        flat = torch.randn(n + 1, device=cuda).to(dtype)
        shifted = flat[1:].view(1, 2, 64, 64)
        wide = torch.randn(1, 2, 64, 68, device=cuda).to(dtype)[..., :64]
        for bad, match in ((shifted, "16-byte aligned"),
                           (wide, "seq stride")):
            k = v = torch.randn(1, 1, 64, 64, device=cuda).to(dtype)
            if dtype == torch.float32:
                _check(bad, k, v, dtype)
            else:
                with pytest.raises(ValueError, match=match):
                    swa_attention_cuda(bad, k, v)


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
    CPU run; the prefill attends through ``attention_scores``, as the
    uncached pass does, so the attention kernel is not launched."""
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
        assert launched == 0
    np.testing.assert_array_equal(out["cuda"], out["cpu"])


# -- the overflow screen -------------------------------------------------------

OV_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _ov(x, lo=0, hi=None):
    flag = torch.zeros(1, dtype=torch.int32, device=x.device)
    got = bool(overflow_flag_cuda_(x, flag, lo, hi).item())
    assert got == bool(overflow_check_plain(x, lo, hi))
    return got


@pytest.mark.parametrize("dtype", OV_DTYPES)
@pytest.mark.parametrize("n", [1, 127, 128, 129, 65_536, 100_001])
def test_overflow_kernel_matches_plain_sweep(cuda, dtype, n):
    """The reference sweep (tests/test_kernels.py): clean, finfo.max and
    -0.0 never trigger; +Inf/-Inf/NaN at the first, middle and last index
    always do."""
    g = torch.Generator(device="cuda").manual_seed(n)
    base = torch.randn(n, device=cuda, generator=g).to(dtype)
    assert not _ov(base)
    big = base.clone()
    big[n // 2] = torch.finfo(dtype).max
    big[0] = -0.0
    assert not _ov(big)
    for payload in (float("inf"), float("-inf"), float("nan")):
        for pos in {0, n // 2, n - 1}:
            x = base.clone()
            x[pos] = payload
            assert _ov(x) and overflow_check_cuda(x)


@pytest.mark.parametrize("dtype", OV_DTYPES)
@pytest.mark.parametrize("start", [0, 1, 3])
def test_overflow_kernel_regions_edges_mid_vector(cuda, dtype, start):
    """[lo, hi) regions whose edges fall inside a 16-byte vector, also
    from a first element that is not 16-byte aligned: a payload just
    inside trips the region, one just outside does not."""
    n = 1000
    for lo, hi in ((3, 61), (1, 2), (7, 40), (5, 997), (0, n), (9, 9)):
        for pos, inside in ((lo, True), (hi - 1, True), (lo - 1, False),
                            (hi, False)):
            if not 0 <= pos < n or (inside and hi == lo):
                continue
            x = torch.zeros(n + start, dtype=dtype, device=cuda)[start:]
            x[pos] = float("nan")
            assert _ov(x, lo, hi) == inside


@pytest.mark.parametrize("shape", [(4, 4), (3, 5, 7), (2, 2, 2, 2)])
def test_overflow_kernel_nd_shapes(cuda, shape):
    x = torch.randn(shape, device=cuda)
    assert not overflow_check_cuda(x) and not ops.overflow_check(x)
    x.view(-1)[0] = float("-inf")
    assert overflow_check_cuda(x) and ops.overflow_check(x)


def test_overflow_kernel_early_exit_keeps_a_set_flag(cuda):
    """A set flag stays set (blocks return at entry) and the verdict stays
    True; each launch counts once; other dtypes raise before a launch."""
    x = torch.randn(1 << 20, device=cuda)
    flag = torch.ones(1, dtype=torch.int32, device=cuda)
    before = overflow_flag_cuda_.launches
    assert overflow_flag_cuda_(x, flag).item() == 1
    x[5] = float("inf")
    flag.zero_()
    overflow_flag_cuda_(x, flag)
    overflow_flag_cuda_(x, flag, 6)        # clean tail: flag stays set
    assert flag.item() == 1
    assert overflow_flag_cuda_.launches == before + 3
    with pytest.raises(TypeError):
        overflow_flag_cuda_(x.double(), flag)
    with pytest.raises(ValueError, match="contiguous"):
        overflow_flag_cuda_(x.view(1024, 1024).t(), flag)
    assert overflow_flag_cuda_.launches == before + 3


TRAIN_CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                        qk_norm=True)


def _train(device, root, overlap="full", steps=3, act=None, layers=2):
    """fp32 train steps of the tiny model under ``memascend`` (its host
    tier of activation checkpoints unless ``act`` names tiers, or
    ``"device"`` for ``offload_checkpoints=False``); returns (losses,
    session facts)."""
    cfg = dataclasses.replace(TRAIN_CFG, n_layers=layers)
    model = make_offloadable_lm(cfg, 0, torch.float32, device=device)
    builder = (OffloadPolicy.preset("memascend").with_store(root)
               .with_adam(compute_dtype="float32", lr=1e-3)
               .with_overlap(overlap))
    if act == "device":
        builder = builder.with_overrides(offload_checkpoints=False)
    elif act is not None:
        builder = builder.with_activations(act)
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 16))
    labels = np.roll(tokens, -1, axis=1)
    with OffloadSession(model, builder.build()) as s:
        before = overflow_flag_cuda_.launches
        metrics = []
        for _ in range(steps):
            metrics.append(dict(s.train_step(tokens, labels)))
            if len(metrics) == 1:
                grads = np.array(s.flat, copy=True)
        losses = [m["loss"] for m in metrics]
        facts = {"launches": overflow_flag_cuda_.launches - before,
                 "pinned": torch.from_numpy(s.flat[:16]).is_pinned(),
                 "grads": grads,
                 "act_write_failures": sum(m["act_write_failures"]
                                           for m in metrics),
                 "eval": s.eval_loss(tokens, labels),
                 "master": s.master_param("block_000", "attn.w_q")}
    return losses, facts


def test_train_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """fp32 (TF32 off) losses on the card within rtol 1e-5 of the port's
    CPU run (the same math, other summation order); the gradient flat
    buffer is page-locked; every gradient tensor is screened by the
    kernel once a step."""
    cpu, _ = _train("cpu", str(tmp_path / "cpu"))
    gpu, facts = _train("cuda", str(tmp_path / "gpu"))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5)
    assert facts["pinned"]
    n_tensors = 2 * 11 + 3
    assert facts["launches"] == 3 * n_tensors
    assert gpu[-1] < gpu[0]


def test_train_sync_equals_full_on_the_card(cuda, tmp_path):
    sync, s_facts = _train("cuda", str(tmp_path / "sync"), overlap="sync")
    full, f_facts = _train("cuda", str(tmp_path / "full"))
    assert sync == full
    assert s_facts["eval"] == f_facts["eval"]
    np.testing.assert_array_equal(s_facts["master"], f_facts["master"])


def test_act_tiers_equal_device_checkpoints_on_the_card(cuda, tmp_path):
    """ssd, host and recompute checkpoints at 3 layers (an ssd fetch
    staged through the async store read, a host checkpoint fetched early
    to seed a recompute): losses, step-1 landed gradients, eval and a
    master bit-equal to checkpoints kept on the card."""
    tiers, t_facts = _train("cuda", str(tmp_path / "tiers"), steps=2,
                            act=("ssd", "host", "recompute"), layers=3)
    dev, d_facts = _train("cuda", str(tmp_path / "dev"), steps=2,
                          act="device", layers=3)
    assert tiers == dev
    np.testing.assert_array_equal(t_facts["grads"], d_facts["grads"])
    assert t_facts["eval"] == d_facts["eval"]
    np.testing.assert_array_equal(t_facts["master"], d_facts["master"])
    assert t_facts["act_write_failures"] == 0


# -- the fused AdamW step ------------------------------------------------------

def _adam_inputs(shape, seed, *, moments=True):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape)
    g = rng.standard_normal(shape)
    m = rng.standard_normal(shape) * 0.1 if moments else np.zeros(shape)
    v = np.abs(rng.standard_normal(shape)) * 0.01 if moments \
        else np.zeros(shape)
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in
            (p, g, m, v)]


def _adam_equal(ins, step, **kw):
    """Kernel and plain version on the same CUDA tensors: p, m, v and w16
    bit for bit (explicitly rounded fp32 ops in both, no contraction)."""
    before = fused_adam_cuda.launches
    got = fused_adam_cuda(*ins, step, **kw)
    torch.cuda.synchronize()
    want = fused_adam_plain(*ins, step, **kw)
    assert fused_adam_cuda.launches == before + 1
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("shape", [(16,), (100, 3), (8, 8, 9), (2048,)])
@pytest.mark.parametrize("step", [1, 10, 1000])
def test_adam_kernel_matches_plain_sweep(cuda, shape, step):
    """The reference sweep (tests/test_kernels.py): lr 3e-3, weight decay
    0.05, bf16 w16."""
    _adam_equal(_adam_inputs(shape, step), step, lr=3e-3, weight_decay=0.05)


@pytest.mark.parametrize("n", [1, 3, 127, 129, 100_001])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16,
                                       torch.float32])
def test_adam_kernel_ragged_sizes_and_out_dtypes(cuda, n, out_dtype):
    _adam_equal(_adam_inputs((n,), n), 7, lr=1e-3, out_dtype=out_dtype)


def test_adam_kernel_misaligned_inputs_and_trajectory(cuda):
    """Inputs that start mid-vector take the scalar path; a five-step
    trajectory stays bitwise the plain version's; the dispatcher reaches
    the kernel and makes strided inputs contiguous."""
    ins = [t[1:] for t in _adam_inputs((4097,), 0)]
    _adam_equal(ins, 3, weight_decay=0.01)
    p, g0, m, v = _adam_inputs((512,), 1, moments=False)
    pr, mr, vr = p, m, v
    for t in range(1, 6):
        g = g0 * (0.9 ** t)
        p, m, v, _ = fused_adam_cuda(p, g, m, v, t, lr=1e-2)
        pr, mr, vr, _ = fused_adam_plain(pr, g, mr, vr, t, lr=1e-2)
    assert torch.equal(p, pr) and torch.equal(m, mr) and torch.equal(v, vr)
    x = _adam_inputs((64, 32), 2)
    before = fused_adam_cuda.launches
    got = ops.fused_adam(*(t.t() for t in x), 4)
    assert fused_adam_cuda.launches == before + 1
    want = fused_adam_plain(*(t.t() for t in x), 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


def test_adam_kernel_rejects_what_it_does_not_take(cuda):
    p, g, m, v = _adam_inputs((64,), 0)
    with pytest.raises(TypeError):
        fused_adam_cuda(p.double(), g, m, v, 1)
    with pytest.raises(TypeError, match="out_dtype"):
        fused_adam_cuda(p, g, m, v, 1, out_dtype=torch.int8)
    with pytest.raises(ValueError, match="shapes"):
        fused_adam_cuda(p, g[:32], m, v, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_adam_cuda(*(t.view(8, 8).t() for t in (p, g, m, v)), 1)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam_cuda(p.cpu(), g, m, v, 1)


# -- serving breadth on the card: continuous batching and spec verify -----------

SERVE_CFG = ModelConfig(name="tiny", family="dense", n_layers=3, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                        qk_norm=True)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.005
        return self.t

    def sleep(self, d):
        self.t += d


def _decoder(root, compute, **spec_kw):
    model = make_offloadable_lm(SERVE_CFG, 0, getattr(torch, compute),
                                device="cuda")
    policy = (OffloadPolicy.preset("memascend").with_store(root)
              .with_adam(compute_dtype=compute).build())
    return OffloadedDecoder(model, policy, decode=DecodeSpec(**spec_kw))


def _requests():
    rng = np.random.default_rng(3)
    return [Request(rid=f"r{i}", prompt=rng.integers(3, 256, n),
                    max_new_tokens=m, arrival=a)
            for i, (n, m, a) in enumerate(
                [(3, 6, 0.0), (6, 4, 0.0), (19, 5, 0.02), (5, 6, 0.05)])]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_continuous_batching_equals_solo_on_the_card(cuda, tmp_path,
                                                      compute):
    """Each request's continuously batched greedy tokens equal the same
    request served alone; no joiner group's prefill launches the
    attention kernel (the model paths attend through
    ``attention_scores``)."""
    with _decoder(str(tmp_path), compute, batch=2, max_seq=32,
                  bucket=8) as dec:
        clk = _Clock()
        before = swa_attention_cuda.launches
        report = ServingEngine(dec, clock=clk, sleep=clk.sleep).run(
            _requests())
        launched = swa_attention_cuda.launches - before
        assert launched == 0 and report.prefills > 0
        assert report.kv_stats["reclaims"] > 0
        for r in _requests():
            clk = _Clock()
            solo = ServingEngine(dec, clock=clk, sleep=clk.sleep).run(
                [Request(rid=r.rid, prompt=r.prompt,
                         max_new_tokens=r.max_new_tokens)])
            got = next(x for x in report.requests if x.rid == r.rid)
            assert got.output == solo.requests[0].output


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_verify_equals_step_chain_and_spec_equals_greedy_on_the_card(
        cuda, tmp_path, compute):
    """verify_step logits of a 5-token window are bitwise the decode_step
    chain's on a fresh cache (joint and ragged per-slot), and
    generate(spec=) emits the plain greedy tokens."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, 256, (2, 7))
    window = rng.integers(3, 256, (2, 5))
    with _decoder(str(tmp_path), compute, batch=2, max_seq=96,
                  bucket=16) as dec:
        s = dec.session
        kv = s.open_kv_cache()
        s.prefill(kv, prompt)
        seq = [s.decode_step(kv, window[:, j:j + 1]) for j in range(5)]
        kv.close()
        kv = s.open_kv_cache()
        s.prefill(kv, prompt)
        ver = s.verify_step(kv, window)
        kv.close()
        for j in range(5):
            assert np.array_equal(ver[:, j], seq[j])
        # ragged per-slot lengths
        kv = s.open_kv_cache()
        s.prefill(kv, prompt)
        kv.rollback(0, 5)
        seq = [s.decode_step_slots(kv, window[:, j:j + 1])
               for j in range(3)]
        kv.close()
        kv = s.open_kv_cache()
        s.prefill(kv, prompt)
        kv.rollback(0, 5)
        ver = s.verify_step_slots(kv, window[:, :3])
        kv.close()
        for j in range(3):
            assert np.array_equal(ver[:, j], seq[j])
        pat = rng.integers(3, 40, 6)
        prompts = np.tile(pat, 4)[None, :].repeat(2, axis=0)
        plain = dec.generate(prompts, 24)
        fast = dec.generate(prompts, 24, spec=SpecConfig(k=4))
        assert np.array_equal(plain, fast)
        assert dec.spec_stats.accepted_per_step > 1.0


# -- cached vs uncached decode, and MoE expert paging, on the card -------------

ULP_TOL = 8.0 * 2.0 ** -8


def test_cached_matches_uncached_greedy_on_the_card(cuda, tmp_path):
    """bf16 tiny model: teacher-forced on the uncached pass's greedy
    tokens, every cached step's logits lie within 8 bf16 ULPs of the row
    max of the uncached pass's and pick its token wherever its top-two
    margin exceeds that bound (a cached step sums its chunked softmax and
    (B, 1) products in another order, so a near-tie may break either
    way)."""
    with _decoder(str(tmp_path), "bfloat16", batch=2, max_seq=32,
                  bucket=8) as dec:
        s = dec.session
        prompts = np.random.default_rng(0).integers(3, 256, size=(2, 6))
        ctx, uncached = prompts, []
        for _ in range(8):
            uncached.append(s.decode_logits(ctx)[:, -1])
            ctx = np.concatenate([ctx, uncached[-1].argmax(-1)[:, None]], 1)
        kv = s.open_kv_cache()
        try:
            cached = [s.prefill(kv, prompts)]
            for t in range(7):
                cached.append(s.decode_step(kv, ctx[:, 6 + t][:, None]))
        finally:
            kv.close()
        tokens = dec.generate(prompts, 8)
        untokens = dec.generate(prompts, 8, use_cache=False)
    agree = 0
    for c, u in zip(cached, uncached, strict=True):
        scale = np.maximum(np.abs(u).max(-1, keepdims=True), 1.0)
        assert (np.abs(c - u) / scale).max() <= ULP_TOL
        top2 = np.sort(u, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > ULP_TOL * scale[:, 0]
        assert np.array_equal(c.argmax(-1)[clear], u.argmax(-1)[clear])
        agree += int((c.argmax(-1) == u.argmax(-1)).sum())
    # free-running, the paths agree up to their first near-tie at least
    assert np.array_equal(tokens[:, 0], untokens[:, 0])
    print(f"teacher-forced argmax agreement {agree}/16, free-running "
          f"token agreement {(tokens == untokens).mean():.3f}, first-step "
          f"gap {np.abs(cached[0] - uncached[0]).max():.3e}")


MOE_CFG = ModelConfig(name="tiny-moe", family="moe", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
                      vocab=256, qk_norm=True,
                      moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=32))


def test_moe_ffn_is_bitwise_deterministic_on_the_card(cuda):
    """moe_ffn forward and backward twice on the same bf16 inputs: the
    same bits (the combine sums the k choices in a fixed order and the
    dispatch writes unique rows, no atomics), and the pinned-idx path
    equals the free top-k path."""
    from repro_torch.models.moe import moe_ffn, router_topk
    g = torch.Generator(device="cuda").manual_seed(0)
    e, d = MOE_CFG.moe, MOE_CFG.d_model

    def rnd(*shape):
        return (0.2 * torch.randn(*shape, device="cuda", generator=g)
                ).to(torch.bfloat16)

    params = {"moe.w_router": rnd(d, e.n_experts),
              "moe.w_gate": rnd(e.n_experts, d, e.d_ff_expert),
              "moe.w_up": rnd(e.n_experts, d, e.d_ff_expert),
              "moe.w_down": rnd(e.n_experts, e.d_ff_expert, d)}
    x = rnd(4, 64, d) * 5

    def run(idx=None):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xx = x.clone().requires_grad_()
        out, _aux = moe_ffn(p, xx, MOE_CFG, idx=idx)
        out.float().square().sum().backward()
        return [out] + [p[k].grad for k in sorted(p)] + [xx.grad]

    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))
    logits = x.reshape(-1, d) @ params["moe.w_router"]
    pinned = run(router_topk(logits, e.top_k)[1])
    assert all(torch.equal(a, b) for a, b in zip(first, pinned, strict=True))


def _moe_session(root, paging, **kw):
    model = make_offloadable_lm(MOE_CFG, 0, torch.bfloat16, device="cuda",
                                expert_paging=paging)
    policy = (OffloadPolicy.preset("memascend").with_store(root)
              .with_adam(lr=1e-2).with_expert_paging(paging, page_slots=16)
              .build())
    return OffloadSession(model, policy, **kw)


def test_moe_routed_losses_equal_all_on_the_card(cuda, tmp_path):
    """bf16 training, three steps: routed-only expert residency gives the
    all-resident losses bit for bit.  (At 32 tokens over 16 experts nearly
    every expert is routed each step, so the routed arm's bytes, which
    count mispredicted prestages too, need not be fewer.)"""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 256, (2, 16))
    labels = np.roll(tokens, -1, axis=1)
    out = {}
    for mode in ("all", "routed"):
        with _moe_session(str(tmp_path / mode), mode) as s:
            out[mode] = ([s.train_step(tokens, labels)["loss"]
                          for _ in range(3)],
                         s.overlap_snapshot()["expert_fetch_bytes"])
    assert out["routed"][0] == out["all"][0]
    assert out["routed"][1] > 0 and out["all"][1] > 0


def test_moe_decode_tokens_routed_equal_all_on_the_card(cuda, tmp_path):
    """bf16 cached greedy decode over a paged-MoE session: the same tokens
    under routed and all-resident residency."""
    prompts = np.random.default_rng(7).integers(0, 256, (2, 8))
    toks = {}
    for mode in ("all", "routed"):
        with _moe_session(str(tmp_path / mode), mode, mode="serve",
                          decode=DecodeSpec(batch=2, max_seq=64)) as s:
            kv = s.open_kv_cache()
            try:
                logits = s.prefill(kv, prompts)
                seq = [logits.argmax(-1)]
                for _ in range(8):
                    logits = s.decode_step(kv, seq[-1][:, None])
                    seq.append(logits.argmax(-1))
            finally:
                kv.close()
            toks[mode] = np.stack(seq, axis=1)
    np.testing.assert_array_equal(toks["all"], toks["routed"])
