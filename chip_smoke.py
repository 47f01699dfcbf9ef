"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--layers N] [--new-tokens N] [--train-layers N]
                          [--serve-layers N] [--moe-train-layers N]
                          [--moe-layers N] [--mla-layers N]
                          [--jamba-layers N] [--xlstm-layers N] [--seed S]

Phases (each raises on failure; the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` with
   nvcc (one process per source, all at once);
3. hold each kernel against its plain PyTorch version on the card: the
   reference sweeps, plus for attention fp16 and D-256 cases,
   ``causal=False``, lengths no tile divides and the prefill shape (each
   case printing the kernel it took: tensor cores for bf16/fp16, SIMT for
   fp32), for the overflow screen nd shapes, regions whose edges fall
   mid-vector and the embedding gradient's size, and for fused AdamW
   ragged sizes, fp16/fp32 ``w16``, misaligned inputs and a five-step
   trajectory (bit for bit); the tensor-core attention kernel's registers,
   spills and shared memory from the ptxas report;
4. time each kernel at its main path's shape (CUDA events, median of 20
   samples of back-to-back calls queued behind a GPU-side spin),
   attention also at a 4096-token prompt,
   its plain version, one PyTorch library call computing the same
   function (a yardstick only: the port never calls it) and the bound,
   the larger of bytes over 3.35 TB/s and operations over 989 TFLOP/s
   (H100 SXM, dense bf16);
5. cached decode: SSD-offloaded decode of qwen3-4b at full width and
   ``--layers`` depth (random weights from ``--seed``) through
   ``OffloadedDecoder.generate`` under the ``memascend`` policy with full
   overlap; the model paths attend through ``attention_scores``, as the
   reference's do, so the attention kernel's launch counts, zeroed just
   before and read just after, must stay 0; then the first-token logits
   are held against a device-resident forward of the same weights;
6. training: three ``OffloadSession.train_step``s and one ``eval_loss`` of
   qwen3-4b at full width and ``--train-layers`` depth on one seeded batch,
   ``memascend`` as shipped (every block's activation checkpoint in host
   memory) with full overlap; the overflow kernel's launch count is zeroed
   just before and read just after; the loss, the landed gradients (every
   block's ``attn.w_q`` among them) and one master after step 1 are held
   against a device-resident plain forward/backward and a plain AdamW on
   the card, and a second session with an Inf in one weight must skip its
   step; then activation tiers: a third session over the same model and
   batch on a fresh store with per-block tiers ssd, host, recompute, ...
   runs two steps (the second overlapping the first's Adam), and its
   step-1 loss and landed gradients and step-2 loss must equal the host
   phase's bit for bit;
7. the kernels reached at their entry points only, each launch count
   zeroed just before and read just after: three ``ops.fused_adam`` steps
   over qwen3-4b's largest tensor (the tied embedding, 388,956,160 fp32),
   step 1 held bit for bit against the plain version, and three
   ``ops.swa_attention`` calls at the cached-decode prefill's shape, held
   against the plain version;
8. serving breadth on one ``memascend`` decoder of qwen3-4b at full width
   and ``--serve-layers`` depth (overlap ``full``, ``DecodeSpec(batch=4,
   max_seq=640, bucket=64)``):
   a. uncached decode, ``generate(use_cache=False)`` at batch 4, prompt
      128: its first-step logits within 8 bf16 ULPs of each row's max of
      the cached prefill's (the gap is printed: 0 since both run
      ``attention_scores``), token agreement with the cached path;
   b. continuous batching, ``ServingEngine.run`` over 8 requests with
      seeded prompts of 64-448 tokens, 4-8 new tokens and arrivals over
      ~2 s: every request done, no attention-kernel launch, retired
      slots' pages reclaimed, two requests re-run alone through a fresh
      engine give the same tokens;
   c. speculative decode, ``generate(spec=SpecConfig(k=4))`` on prompts
      that repeat a seeded 32-token pattern to 256 tokens, equal to the
      plain greedy tokens, and the ``verify_step`` logits of a 4-token
      window equal (``torch.equal``) the ``decode_step`` chain's;
9. MoE expert paging on qwen3-30b-a3b at full width (d_model 2048, 32/4
   heads, 128 experts, top-8, d_ff_expert 768, vocab 151,936), random
   weights from ``--seed``:
   a. training at ``--moe-train-layers`` depth: two ``train_step``s of
      batch 2 x 512 under ``memascend`` with ``expert_paging="all"``, the
      store dropped, then the same two steps with ``"routed"`` (384 expert
      pages of host budget each); the losses bit-equal, step 1's within
      rel 1e-3 of a device-resident forward, one overflow-kernel launch
      per gradient tensor a step, the expert bytes, stage gets and hits
      of each arm;
   b. cached decode at ``--moe-layers`` depth: batch 4, 512-token
      prompts, 8 new tokens under ``"all"`` and ``"routed"``: equal
      tokens, the routed arm moving fewer expert bytes;
10. the device-resident path (``repro_torch.models.build``,
    ``train.build_train_step``, ``serve.build_serve_step``):
    a. resident training on the training phase's qwen3-4b model and
       batch (``--train-layers`` depth, right after phase 6): three steps
       of the launcher's loop (``resident_loop``: the train step, the
       loss scaler, SGD at lr 1e-2) on fp32 masters holding the model's
       bf16 weights; the loss falls, no step overflows, step 1 within rel
       1e-3 of phase 6's offloaded step-1 loss on the same batch, one
       overflow-kernel launch per gradient leaf a step (count zeroed just
       before, read just after), then the kernel held to its plain
       version on every leaf of one more step's gradients;
    b. resident MLA decode, deepseek-v3 at full width, ``--mla-layers``
       depth plus its MTP block, drawn on the card in bf16: batch 2, a
       64-token prompt through the latent cache, 16 greedy tokens (bf16
       compute), then a teacher-forced audit at fp32 compute over the
       same bf16 weights: the serve step's logits at all 79 positions
       within rtol = atol = 2e-3 of ``prefill_fn``'s (the reference's own
       decode-vs-forward bound, router capacity 16 as it sets it); the
       bf16 gap is printed beside it;
    c. offloaded MLA uncached decode, the same width and depth, from bf16
       host units: ``generate(use_cache=False)`` of 2 tokens after a
       32-token prompt, batch 1, under ``expert_paging="all"`` and then
       ``"routed"`` (768 host expert pages each, each arm's store dropped
       after it): equal tokens, the routed arm moving fewer expert
       bytes;
    d. the (data, model) mesh (phase 17 in the code's section comments),
       right after (a): a one-rank NCCL group (an in-memory store) and
       ``launch.mesh.make_host_mesh()`` on the card; one
       ``build_train_step(impl, mesh)`` step of (a)'s model and batch,
       its loss and every gathered gradient bit-equal to the unmeshed
       step (else held at 8 bf16 ULPs of each tensor's max, the gap
       printed), the overflow flag equal to the plain screen's and the
       kernel launched once a gradient's local shard (count zeroed just
       before, read just after), then True with one Inf written into one
       local shard; greedy decode through ``build_serve_step(impl, shape,
       mesh)`` under "zero3" and "tp" (8 prompt tokens, 8 new), the
       logits equal to the unmeshed serve step's at every position; the
       group destroyed after;
11. the recurrent and encoder-decoder families on the resident path
    (phases 13-15 in the code's section comments), each at full width
    with a bf16 tree drawn on the card from the seed, cut in depth only:
    jamba-v0.1-52b (``--jamba-layers``, one 8-layer interleave period: 7
    Mamba + 1 attention layer, 4 MoE + 4 dense FFNs, 26.6 GB),
    xlstm-1.3b (``--xlstm-layers``, 16 of 48 layers: 14 mLSTM + 2 sLSTM)
    and whisper-tiny (whole, frames from the seed as the stub
    frontend's).  Each runs three SGD steps (lr 1e-2, in place on the bf16
    tree) through ``build_train_step`` and the loss scaler at batch 2 x
    512 (whisper: x 448, its decoder cap) — the loss must fall, no clean
    step overflow, one overflow-kernel launch per gradient leaf a step
    (count zeroed just before, read just after) and the kernel's verdict
    equal to the plain version's on every leaf of one more step — then
    greedy decode through ``build_serve_step`` (whisper: ``encode`` ->
    ``prefill_cross_cache`` first): a 64-token prompt and 16 new tokens,
    the recurrent state bytes a layer equal after 32- and 64-token
    prompts, and a teacher-forced audit at fp32 compute over the same
    bf16 weights: the serve step's logits at all 79 positions within
    rtol = atol = 2e-3 of ``prefill_fn``'s (router capacity 16); each
    recurrent mixer (and Mamba's scan alone) is timed at the training
    shape;
12. the dry run against the card: each full-width resident run above
    (phase 10a's qwen3-4b training, the three families' training and
    decode, phase 10b's MLA decode) is run once more on the meta device
    through ``repro_torch.launch.dryrun.lower_pair`` with the same config,
    depth, shape and dtypes — in a process of its own started at the
    beginning, since it needs no card — and one line a run prints its
    flops, its eager op-by-op bytes, its predicted peak (argument + temp
    + output) beside the step's measured ``max_memory_allocated`` above
    the phase's base, the roofline floor (the larger of flops over 989
    TFLOP/s and bytes over 3.35 TB/s), the measured step or token and
    their ratio, ``roofline_share``; every training run's predicted peak
    must be within 10 % of the measured one (the rows also go to
    ``chiprun_out/dry_vs_card.json``); the same side process runs the
    pod-mesh (16x16) dry runs of qwen3-4b at full width, ``train_4k``
    (ZeRO-3) and ``decode_32k`` under "zero3" and "tp", whose rank-0
    argument, temp and peak bytes, collective bytes and counts by kind
    and roofline terms phase 10d prints (also to
    ``chiprun_out/mesh_phase.json``);
13. the paper's comparison (phase 18 in the code's section comments), run
    after the side process is done and before the training phase: the
    offloaded trainer (``make_offloadable_lm`` -> ``OffloadPolicy.preset``
    -> ``OffloadSession.train_step``) on qwen3-4b at full width and
    ``--compare-layers`` depth, the training phase's batch, Adam at the
    preset's defaults plus lr 1e-3, in five arms — ``memascend``,
    ``zero-infinity``, ``memascend-bf16`` at full overlap and
    ``memascend`` at ``sync`` and ``h2d`` — each in a spawned process of
    its own (after one that only initialises CUDA, the OS counters' base)
    loading the kernels the parent built, on a store of its own deleted
    after it: two steps, the second timed with ``synchronize`` inside the
    window; the four fp32 arms' losses bit-equal at both steps,
    memascend-bf16's step 1 equal and its step 2 finite, the overflow
    kernel launched once a gradient tensor a step (zero under
    zero-infinity, which screens on the host, count zeroed just before a
    step and read just after), zero-infinity's pinned allocations at the
    pow2 of their requests and its ``overflow_tmp`` peak at least 1.25x
    the gradient flat buffer, the other arms' within 4 KiB and 0, every
    arm's pool arena and flat buffer page-locked, each arm's
    ``optimizer_io_bytes`` what ``AdamConfig``'s widths predict, and
    zero-infinity's tracker peak above memascend's; one JSON line an arm
    (also ``chiprun_out/compare.json``) and one summary line;
14. print the ``kernels`` JSON line, the card line, and the result line.

Needs one CUDA device.  Kernel builds and the SSD stores live under
``build/`` next to this script.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import (DecodeSpec, OffloadPolicy,  # noqa: E402
                              OffloadSession)
from repro_torch.core import overflow as host_overflow  # noqa: E402
from repro_torch.core.dtypes import cast_host, to_torch  # noqa: E402
from repro_torch.core.loss_scale import DynamicLossScaler  # noqa: E402
from repro_torch.core.model_adapter import make_offloadable_lm  # noqa: E402
from repro_torch.core import (MemoryTracker, OffloadedAdam,  # noqa: E402
                              next_power_of_two)
from repro_torch.core.nvme import DirectNVMeEngine  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.fused_adam import (  # noqa: E402
    fused_adam_cuda, fused_adam_plain)
from repro_torch.kernels.overflow_check import (  # noqa: E402
    overflow_check_cuda, overflow_check_plain, overflow_flag_cuda_)
from repro_torch.kernels.swa_attention import (  # noqa: E402
    attention_path, swa_attention_cuda, swa_attention_plain)
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.dryrun import lower_pair  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     one_rank_group)
from repro_torch.launch.roofline import (HBM_BW, LINK_BW,  # noqa: E402
                                         PEAK_FLOPS, analyze)
from repro_torch.launch.train import resident_loop  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import whisper as whs  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.layers import dense  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    from_numpy_params, init_params, mixer_kind)
from repro_torch.serve import (OffloadedDecoder, Request,  # noqa: E402
                               RequestState, ServingEngine, SpecConfig,
                               build_serve_step)
from repro_torch.models.registry import TensorSpec  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402
from repro_torch.train import grads_overflow_flag  # noqa: E402
from repro_torch.train.step import tree_leaves, tree_map  # noqa: E402

# first-token logits vs the device-resident plain forward: 8 bf16 ULPs of
# each row's max logit, the repo's teacher-forced decode audit bound
# (benchmarks/bench_decode.py); a kernel or cache fault moves logits at
# row-max scale, far past it
LOGIT_TOL = 8.0 * 2.0 ** -8
BATCH, PROMPT, BUCKET = 4, 512, 64
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 512, 3
# Adam lr of the training phase: large enough that three steps on one
# batch move bf16 weights (a 1e-4 step is about one bf16 ULP of a 0.02
# weight) so the loss visibly falls
TRAIN_LR = 1e-3
# step-1 loss vs the device-resident plain forward of the same bf16
# weights: the same ops on the same values (the streamed block recompute
# runs them again), so only launch-order effects remain; 1e-3 is a
# quarter of a bf16 ULP of the loss, far below what a wrong weight,
# gradient or checkpoint would move it
LOSS_RTOL = 1e-3
# landed gradients vs the resident backward: 8 bf16 ULPs of each tensor's
# max abs (the grads are bf16 before the fp32 cast the D2H lands)
GRAD_TOL = 8.0 * 2.0 ** -8
# one master after step 1 vs torch AdamW on the card from the same fp32
# master and landed gradient: the same fp32 formula in another operation
# order, max |diff| over max |ref|
ADAM_RTOL = 1e-6


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ~2.5-3 ms of GPU-side spin (torch.cuda._sleep counts SM clock cycles)
QUEUE_CYCLES = 5_000_000


def cuda_ms(fn, reps: int = 20, warmup: int = 3, fill_ms: float = 2.0) -> float:
    """Median over ``reps`` event-timed samples of one call's device time.
    A sample runs enough back-to-back calls to fill ~``fill_ms`` and
    divides by their number, and starts behind a GPU-side spin long
    enough for the host to queue all of them: one call between two events,
    or calls the device runs faster than the host issues them, would also
    time the Python wrapper's host work."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    inner = max(1, min(20, int(fill_ms / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# -- phase 3 + 4: the attention kernel ---------------------------------------

def _qkv(gen, b, h, kh, s, d, dtype):
    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    return rnd(b, h, s, d), rnd(b, kh, s, d), rnd(b, kh, s, d)


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 1e-2}
LONG_PROMPT = 4096


def check_attention(gen) -> float:
    """Kernel vs plain on the card; returns the max error at the main
    path's shape.  Tolerances are the reference sweep's: fp32 2e-5 (same
    math, other summation order), bf16 3e-2 (one output rounding); fp16
    1e-2 (the tensor-core path rounds P and the output to fp16, whose ULP
    is 8x finer than bf16's; 1e-2 covers a one-ULP output flip at |o| in
    [4, 8)).  Each case prints the kernel it took."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for h, kh in ((4, 4), (4, 2), (8, 1)):
            for window in (0, 64, 128):
                cases.append((dtype, (2, h, kh, 256, 32), window, True))
    cases += [(torch.float32, (1, 2, 2, 128, 16), 0, False),
              (torch.bfloat16, (2, 8, 2, 200, 64), 0, True),
              (torch.float32, (1, 4, 2, 77, 128), 32, True),
              (torch.bfloat16, (1, 4, 1, 130, 256), 0, False),
              (torch.bfloat16, (2, 8, 2, 300, 256), 128, True),
              (torch.bfloat16, (1, 8, 1, 513, 256), 0, True),
              (torch.float16, (1, 4, 1, 130, 256), 0, False),
              (torch.float16, (2, 8, 1, 511, 64), 500, True),
              (torch.float16, (1, 8, 2, 700, 128), 0, False)]
    main_shape = (BATCH, 32, 8, PROMPT, 128)
    cases.append((torch.bfloat16, main_shape, 0, True))
    cases.append((torch.float16, main_shape, 0, True))
    main_err = None
    for dtype, (b, h, kh, s, d), window, causal in cases:
        q, k, v = _qkv(gen, b, h, kh, s, d, dtype)
        out = swa_attention_cuda(q, k, v, window=window, causal=causal)
        torch.cuda.synchronize()
        ref = swa_attention_plain(q, k, v, window=window, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        print(f"  swa_attention {str(dtype)[6:]:8s} B{b} H{h} KH{kh} S{s} "
              f"D{d} window {window} causal {causal}: "
              f"{attention_path(dtype):11s} max err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"swa_attention disagrees with its plain "
                                 f"version: {err} > {tol}")
        if (b, h, kh, s, d) == main_shape and dtype == torch.bfloat16:
            main_err = err
    return main_err


def time_attention(gen, b: int, s: int) -> dict:
    """Times at B ``b``, H 32, KH 8, S ``s``, D 128, bf16, causal, window
    0: the main path's prefill shape (B 4, S 512) and a long prompt."""
    h, kh, d = 32, 8, 128
    q, k, v = _qkv(gen, b, h, kh, s, d, torch.bfloat16)
    ms = cuda_ms(lambda: swa_attention_cuda(q, k, v))
    plain_ms = cuda_ms(lambda: swa_attention_plain(q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * b * h * s * d + 2 * b * kh * s * d)   # q, o, k, v
    live_pairs = ops.live_pairs(s)                          # causal band
    flops = 4 * d * live_pairs * b * h                      # QK^T and PV
    bytes_ms = 1e3 * nbytes / HBM_BW
    flops_ms = 1e3 * flops / PEAK_FLOPS
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "tflops": flops / (ms * 1e9)}


def attention_build(report: str) -> dict:
    """Registers, spills and shared memory of the tensor-core kernel at
    D 128 (bf16), from nvcc's ptxas report and the library."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if ("Function properties for" in line and "swa_tc_kernel" in line
                and "bfloat16Li128E" in line):
            spill = lines[i + 1].split()
            used = lines[i + 2].split()
            return {"registers": int(used[used.index("registers,") - 1]),
                    "spill_store_bytes": int(spill[spill.index("spill") - 2]),
                    "smem_bytes": _build.library(
                        "swa_attention").swa_attention_tc_smem_bytes(128)}
    raise AssertionError("no ptxas report for the tensor-core attention "
                         "kernel at D 128")


def zero_attention_counts() -> None:
    swa_attention_cuda.launches = 0
    for path in swa_attention_cuda.path_launches:
        swa_attention_cuda.path_launches[path] = 0


def check_attention_counts(expect: int, what: str) -> dict:
    """The run launched the kernel ``expect`` times, every one on the
    tensor-core path (the main path is bf16)."""
    total = swa_attention_cuda.launches
    paths = dict(swa_attention_cuda.path_launches)
    if total != expect or paths != {"tensor_core": expect, "simt": 0}:
        raise AssertionError(f"swa_attention launched {total} times "
                             f"{paths} in {what}; expected {expect}, all "
                             f"on the tensor cores")
    return paths


def run_attention_path(gen) -> dict:
    """Three calls of the entry point ``ops.swa_attention`` at the
    cached-decode prefill's shape (B 4, H 32, KH 8, S 512, D 128, bf16,
    causal), the launch counts zeroed just before and read just after;
    the first call's output within the bf16 tolerance of the plain
    version and the three equal.  The model paths attend through
    ``attention_scores`` (as the reference's do), so this entry point is
    where the kernel runs, as ``ops.fused_adam`` is for fused AdamW."""
    q, k, v = _qkv(gen, BATCH, 32, 8, PROMPT, 128, torch.bfloat16)
    want = swa_attention_plain(q, k, v)
    torch.cuda.synchronize()
    zero_attention_counts()
    outs = [ops.swa_attention(q, k, v) for _ in range(3)]
    torch.cuda.synchronize()
    paths = check_attention_counts(3, "three entry-point calls")
    err = (outs[0].float() - want.float()).abs().max().item()
    if not err <= ATTN_TOL[torch.bfloat16] or not all(
            torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError(f"swa_attention entry point: max err {err}, "
                             f"or the three calls differ")
    print(f"  swa_attention entry point: 3 calls at B{BATCH} H32 KH8 "
          f"S{PROMPT} D128 bf16, {paths}, max err {err:.3e}")
    return {"launches": 3, "path_launches": paths, "max_abs_err": err}


# -- phase 3 + 4: the overflow-screen kernel ----------------------------------

def _main_grad_elems() -> int:
    cfg = get_config("qwen3-4b")
    return cfg.vocab * cfg.d_model       # the embedding's gradient


def _ov_agree(x, lo=0, hi=None, expect=None) -> bool:
    """Kernel verdict on a fresh flag == plain verdict (== ``expect``)."""
    flag = torch.zeros(1, dtype=torch.int32, device=x.device)
    got = bool(overflow_flag_cuda_(x, flag, lo, hi).item())
    want = bool(overflow_check_plain(x, lo, hi))
    if got != want or (expect is not None and got != expect):
        raise AssertionError(f"overflow_check {x.dtype} n {x.numel()} "
                             f"[{lo}, {hi}): kernel {got}, plain {want}, "
                             f"expected {expect}")
    return got


def check_overflow(gen) -> tuple[float, int]:
    """Kernel vs plain on the card: the reference sweeps
    (tests/test_kernels.py: fp32/bf16/fp16 x n, +Inf/-Inf/NaN at the
    first, middle and last index, finfo.max and -0.0 never trigger), nd
    shapes, regions whose edges fall mid-vector (payload just inside and
    just outside, also from a misaligned start), a set flag staying set,
    and the main path's largest gradient.  Returns (max abs error of the
    verdicts, cases) — any disagreement raises, so the error is 0."""
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for n in (1, 127, 128, 129, 65_536, 100_001):
            base = torch.randn(n, device="cuda", generator=gen).to(dtype)
            _ov_agree(base, expect=False)
            big = base.clone()
            big[n // 2] = torch.finfo(dtype).max
            big[0] = -0.0
            _ov_agree(big, expect=False)
            cases += 2
            for payload in (float("inf"), float("-inf"), float("nan")):
                for pos in sorted({0, n // 2, n - 1}):
                    x = base.clone()
                    x[pos] = payload
                    _ov_agree(x, expect=True)
                    cases += 1
        for lo, hi in ((3, 61), (1, 2), (7, 40), (5, 997), (0, 1000),
                       (9, 9)):
            for start in (0, 1):          # 1: a misaligned first element
                for pos, inside in ((lo, True), (hi - 1, True),
                                    (lo - 1, False), (hi, False)):
                    if not 0 <= pos < 1000 or (inside and hi == lo):
                        continue
                    x = torch.zeros(1000 + start, dtype=dtype,
                                    device="cuda")[start:]
                    x[pos] = float("inf")
                    _ov_agree(x, lo, hi, expect=inside)
                    cases += 1
    for shape in ((4, 4), (3, 5, 7), (2, 2, 2, 2)):
        x = torch.randn(shape, device="cuda", generator=gen)
        if overflow_check_cuda(x) or overflow_check_plain(x):
            raise AssertionError(f"overflow_check flagged a clean {shape}")
        x.view(-1)[0] = float("-inf")
        if not (overflow_check_cuda(x) and overflow_check_plain(x)):
            raise AssertionError(f"overflow_check missed -inf in {shape}")
        cases += 2
    clean = torch.randn(4096, device="cuda", generator=gen)
    flag = torch.ones(1, dtype=torch.int32, device="cuda")
    if overflow_flag_cuda_(clean, flag).item() != 1:
        raise AssertionError("a set overflow flag was cleared")
    n = _main_grad_elems()
    x = torch.randn(n, device="cuda", generator=gen)
    _ov_agree(x, expect=False)
    x[-1] = float("inf")
    _ov_agree(x, expect=True)
    cases += 3
    print(f"  overflow_check: {cases} cases agree with the plain version "
          f"(fp32/bf16/fp16 sweeps, nd shapes, mid-vector regions, "
          f"{n} fp32)")
    return 0.0, cases


def time_overflow(gen) -> dict:
    """Times at the main path's largest gradient: the embedding's fp32
    grad, clean (the kernel reads all of it)."""
    n = _main_grad_elems()
    x = torch.randn(n, device="cuda", generator=gen)
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: overflow_flag_cuda_(x, flag))
    if flag.item() != 0:
        raise AssertionError("overflow_check flagged clean data")
    plain_ms = cuda_ms(lambda: overflow_check_plain(x))
    library_ms = cuda_ms(lambda: torch.isfinite(x).all())
    # one read of each element; a mask and a compare an element are far
    # below the card's integer rate
    bytes_ms = 1e3 * 4 * n / HBM_BW
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bytes_ms, "bound_by": "bytes"}


# -- phase 3 + 4 + 7: the fused-AdamW kernel ------------------------------------

ADAM_KW = dict(lr=3e-3, weight_decay=0.05)


def _adam_inputs(gen, n, *, moments=True):
    p, g = (torch.randn(n, device="cuda", generator=gen) for _ in range(2))
    if not moments:
        return p, g, torch.zeros_like(p), torch.zeros_like(p)
    m = 0.1 * torch.randn(n, device="cuda", generator=gen)
    v = 0.01 * torch.randn(n, device="cuda", generator=gen).abs()
    return p, g, m, v


def _adam_agree(ins, step, **kw) -> float:
    """Kernel vs plain on the same tensors; p, m, v and w16 must be equal
    bit for bit (the kernel's explicitly rounded fp32 ops are the plain
    version's unfused PyTorch ops).  Returns the max abs difference."""
    got = fused_adam_cuda(*ins, step, **kw)
    torch.cuda.synchronize()
    want = fused_adam_plain(*ins, step, **kw)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want, strict=True))
    same = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    if not same:
        raise AssertionError(f"fused_adam n {ins[0].numel()} step {step} "
                             f"{kw}: kernel differs from plain (max {err})")
    return err


def check_fused_adam(gen) -> tuple[float, int]:
    """The reference sweep (tests/test_kernels.py: shapes (16,), (100, 3),
    (8, 8, 9), (2048,) at steps 1, 10, 1000, lr 3e-3, weight decay 0.05),
    n = 1, 127, 129, 100,001 with bf16/fp16/fp32 w16, inputs that start
    mid-vector and the five-step trajectory; every output bit for bit.
    Returns (max abs error, cases)."""
    err, cases = 0.0, 0
    for shape in ((16,), (100, 3), (8, 8, 9), (2048,)):
        n = int(np.prod(shape))
        for step in (1, 10, 1000):
            ins = [t.view(shape) for t in _adam_inputs(gen, n)]
            err = max(err, _adam_agree(ins, step, **ADAM_KW))
            cases += 1
    for n in (1, 127, 129, 100_001):
        for out_dtype in (torch.bfloat16, torch.float16, torch.float32):
            err = max(err, _adam_agree(_adam_inputs(gen, n), 7,
                                       out_dtype=out_dtype, **ADAM_KW))
            cases += 1
    ins = [t[1:] for t in _adam_inputs(gen, 4097)]     # scalar path
    err = max(err, _adam_agree(ins, 3, **ADAM_KW))
    p, g0, m, v = _adam_inputs(gen, 512, moments=False)
    pr, mr, vr = p, m, v
    for t in range(1, 6):
        g = g0 * (0.9 ** t)
        p, m, v, _ = fused_adam_cuda(p, g, m, v, t, lr=1e-2)
        pr, mr, vr, _ = fused_adam_plain(pr, g, mr, vr, t, lr=1e-2)
    if not (torch.equal(p, pr) and torch.equal(m, mr) and torch.equal(v, vr)):
        raise AssertionError("fused_adam five-step trajectory differs")
    cases += 2
    print(f"  fused_adam: {cases} cases equal the plain version bit for bit "
          f"(reference sweep, ragged n, fp16/fp32 w16, misaligned inputs, "
          f"five-step trajectory)")
    return err, cases


def run_adam_path(gen) -> dict:
    """Three AdamW steps over the tied embedding's size through the entry
    point ``ops.fused_adam``, the launch count zeroed just before and read
    just after; step 1 equals the plain version bit for bit."""
    n = _main_grad_elems()
    p, g, m, v = _adam_inputs(gen, n, moments=False)
    want = fused_adam_plain(p, g, m, v, 1, **ADAM_KW)
    torch.cuda.synchronize()
    fused_adam_cuda.launches = 0
    t0 = time.perf_counter()
    state = (p, m, v)
    for step in (1, 2, 3):
        out = ops.fused_adam(state[0], g, state[1], state[2], step, **ADAM_KW)
        state = out[:3]
        if step == 1:
            first = out
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_adam_cuda.launches
    if launches != 3:
        raise AssertionError(f"fused_adam launched {launches} times in "
                             f"three steps")
    if not all(torch.equal(a, b) for a, b in zip(first, want, strict=True)):
        raise AssertionError("fused_adam step 1 over the embedding differs "
                             "from the plain version")
    if not torch.isfinite(state[0]).all():
        raise AssertionError("fused_adam produced non-finite weights")
    print(f"  fused_adam entry point: 3 steps over {n} fp32 in "
          f"{seconds:.3f} s, {launches} launches, step 1 bit-equal to plain")
    return {"launches": launches, "seconds": seconds}


def time_fused_adam(gen) -> dict:
    """Times at qwen3-4b's largest parameter tensor (the tied embedding,
    388,956,160 fp32), bf16 w16: the kernel, its plain version, one
    ``torch._fused_adamw_`` call updating copies of the same four tensors
    in place (a yardstick only: the port never calls it; it moves 28 B an
    element and emits no bf16 copy of the weights), and that call followed
    by ``w16.copy_(p)``, the same function as the kernel's."""
    n = _main_grad_elems()
    p, g, m, v = _adam_inputs(gen, n)
    ms = cuda_ms(lambda: fused_adam_cuda(p, g, m, v, 10, **ADAM_KW))
    plain_ms = cuda_ms(lambda: fused_adam_plain(p, g, m, v, 10, **ADAM_KW))
    lp, lm, lv = p.clone(), m.clone(), v.clone()
    lw16 = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    steps = [torch.tensor(10.0, device="cuda")]

    def library():
        torch._fused_adamw_(
            [lp], [g], [lm], [lv], [], steps, lr=ADAM_KW["lr"], beta1=0.9,
            beta2=0.999, weight_decay=ADAM_KW["weight_decay"], eps=1e-8,
            amsgrad=False, maximize=False)

    library_ms = cuda_ms(library)
    library_w16_ms = cuda_ms(lambda: (library(), lw16.copy_(lp)))
    del lp, lm, lv, lw16
    # each input read once (16 B), each output written once (12 B of fp32
    # p, m, v and 2 B of bf16 w16); ~40 fp32 operations an element are far
    # below the card's rate
    bytes_ms = 1e3 * 30 * n / HBM_BW
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_w16_ms": library_w16_ms,
            "bound_ms": bytes_ms, "bound_by": "bytes"}


# -- phase 5: the main path ----------------------------------------------------

def _resident(params: dict, device) -> dict:
    """One unit's weights on the device in bf16, unstreamed."""
    return {k: to_torch(cast_host(v, "bfloat16"), torch.bfloat16).to(device)
            for k, v in params.items()}


def resident_first_logits(model, prompts) -> np.ndarray:
    """Last-position logits of a plain device-resident forward of the same
    bf16 weights through the model's full-sequence block: no streaming,
    no KV cache."""
    dev = torch.device("cuda")
    tokens = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    with torch.no_grad():
        h = model.embed_apply(_resident(model.units[0].params, dev), tokens)
        for unit in model.units[1:-1]:
            h = model.block_apply(_resident(unit.params, dev), h)
        logits = model.head_logits(_resident(model.units[-1].params, dev),
                                   h[:, -1:])
    return logits[:, 0].cpu().numpy()


def run_main_path(args, workdir: str) -> dict:
    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=args.layers)
    print(f"main path: {cfg.name} d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab}, depth {cfg.n_layers} of 36 "
          f"(--layers), batch {BATCH}, prompt {PROMPT}, "
          f"{args.new_tokens} new tokens")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device="cuda")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, size=(BATCH, PROMPT), dtype=np.int64)
    spec = DecodeSpec(batch=BATCH, max_seq=PROMPT + args.new_tokens + 32,
                      bucket=BUCKET)
    # the memascend store (two striped raw regions), sized to hold the bf16
    # weights plus every KV page with room to spare
    n_params = sum(v.size for u in model.units for v in u.params.values())
    kv_bytes = 2 * 2 * BATCH * spec.max_seq * cfg.n_kv_heads * \
        cfg.head_dim * cfg.n_layers
    capacity = -(-(2 * n_params + kv_bytes) // 2) + (256 << 20)
    policy = OffloadPolicy.preset("memascend").with_store(
        factory=lambda: DirectNVMeEngine(os.path.join(workdir, "raw_store"),
                                         n_devices=2,
                                         device_capacity=capacity)).build()
    with OffloadedDecoder(model, policy, decode=spec) as dec:
        session = dec.session
        setup_s = time.perf_counter() - t0
        slot = torch.from_numpy(session.pool.arena[:4096])
        pinned = slot.is_pinned()
        torch.cuda.synchronize()

        zero_attention_counts()
        t1 = time.perf_counter()
        tokens = dec.generate(prompts, args.new_tokens)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t1
        # the prefill attends through attention_scores, as the uncached
        # pass does: no model path reaches the attention kernel
        launches = swa_attention_cuda.launches
        check_attention_counts(0, f"one prefill of {cfg.n_layers} blocks")
        if tokens.shape != (BATCH, args.new_tokens) or \
                tokens.min() < 0 or tokens.max() >= cfg.vocab:
            raise AssertionError(f"bad generated tokens {tokens.shape}")
        fetch = dec.fetch_stats
        io = session.store.stats.snapshot()
        kvo = dec.kv_overlap_stats
        ostats = session.overlap_snapshot()

        # the same entry points again, timed per phase: prefill, then the
        # greedy steps; the tokens must repeat the generate() run exactly
        kv = session.open_kv_cache()
        try:
            t2 = time.perf_counter()
            logits = session.prefill(kv, prompts)
            prefill_s = time.perf_counter() - t2
            first_logits = logits
            steps, t3 = [], time.perf_counter()
            for i in range(args.new_tokens):
                nxt = np.argmax(logits, axis=-1).astype(np.int32)
                steps.append(nxt)
                if not np.isfinite(logits).all():
                    raise AssertionError(f"non-finite logits at step {i}")
                if i + 2 < args.new_tokens:
                    logits = session.decode_step(kv, nxt[:, None])
                elif i + 1 < args.new_tokens:
                    # the last step under the profiler: device busy share
                    t_step = time.perf_counter()
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        logits = session.decode_step(kv, nxt[:, None])
                        torch.cuda.synchronize()
                    step_ms = 1e3 * (time.perf_counter() - t_step)
            decode_s = time.perf_counter() - t3
        finally:
            kv.close()
        if not np.array_equal(np.stack(steps, axis=1), tokens):
            raise AssertionError("a second run of the same prompts gave "
                                 "other tokens")
        pinned_stats = session.tracker.component("pinned")
        requested, reserved = pinned_stats.live_requested, \
            pinned_stats.live_allocated

    ref = resident_first_logits(model, prompts)
    scale = np.maximum(np.abs(ref).max(-1, keepdims=True), 1.0)
    rel = float((np.abs(first_logits - ref) / scale).max())
    print(f"  first-token logits vs device-resident plain forward: max "
          f"row-scaled diff {rel:.3e} (tol {LOGIT_TOL:.3e}), argmax agree "
          f"{int((first_logits.argmax(-1) == ref.argmax(-1)).sum())}/"
          f"{BATCH}")
    if not rel <= LOGIT_TOL:
        raise AssertionError(f"offloaded first-token logits differ from the "
                             f"resident forward: {rel} > {LOGIT_TOL}")
    # the profiled step is timed on its own and left out of the rate
    plain_steps = args.new_tokens - 2
    decode_s -= step_ms / 1e3
    per_token_ms = 1e3 * decode_s / plain_steps
    busy_ms, device_events = _device_busy_ms(prof)
    print("  profiled decode step, device time by kernel/copy (top 8):")
    for e in sorted(device_events,
                    key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.key[:60]:60s} {e.self_device_time_total / 1e3:9.3f} "
              f"ms x{e.count}")
    out = {
        "layers": cfg.n_layers, "setup_s": setup_s,
        "generate_s": generate_s, "prefill_s": prefill_s,
        "per_token_ms": per_token_ms,
        "tokens_per_s": BATCH * plain_steps / decode_s,
        "fetch_wait_s": fetch["wait_seconds"],
        # summed over concurrent reads, so an upper bound of the busy time
        "store_read_GB": io["bytes_read"] / 1e9,
        "store_read_s": io["read_seconds"],
        "h2d_wait_s": ostats["h2d_wait_seconds"],
        "prefetch_hits": f"{fetch['prefetch_hits']}/{fetch['n_gets']}",
        "kv_stage_hits": f"{kvo['kv_stage_hits']}/{kvo['kv_stage_gets']}",
        "pinned_requested_bytes": requested,
        "pinned_reserved_bytes": reserved,
        "slot_is_pinned": pinned, "swa_launches": launches,
        "logit_max_rel_diff": rel,
        # device time of one profiled step (kernels + copies, summed over
        # the compute and copy streams) over an unprofiled step's wall time
        # (the profiler's own start-up inflates the profiled one); None
        # where the profiler saw no device time
        "step_device_busy_ms": busy_ms or None,
        "device_idle_share": (1.0 - busy_ms / per_token_ms) if busy_ms
        else None,
    }
    for k, v in out.items():
        print(f"  {k}: {v}")
    if not pinned:
        raise AssertionError("pool slots are not page-locked: non_blocking "
                             "H2D would silently be a staged copy")
    return out


# -- phase 6: training -----------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _allocated(device) -> int | None:
    """Bytes the card holds now (None off the card): a phase's base, taken
    before it draws its tree."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _step_peak(fn, device, base: int | None):
    """``(fn(), peak)``: the most the card held while ``fn`` ran, above
    ``base`` (what the phase found allocated before it began; None off
    the card)."""
    if base is None:
        return fn(), None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _train_policy(workdir: str, n_params: int, name: str, act=None,
                  experts=None):
    """memascend as shipped (the host tier of activation checkpoints,
    unless ``act`` names per-block tiers; ``experts`` = (mode, page
    slots) for expert paging) on a direct-NVMe store sized for master + m
    + v (fp32) + bf16 compute weights, 14 B/param, plus slack."""
    capacity = -(-(14 * n_params) // 2) + (512 << 20)
    root = os.path.join(workdir, name)
    builder = (OffloadPolicy.preset("memascend")
               .with_adam(lr=TRAIN_LR, weight_decay=0.01)
               .with_store(factory=lambda: DirectNVMeEngine(
                   root, n_devices=2, device_capacity=capacity)))
    if act is not None:
        builder = builder.with_activations(act)
    if experts is not None:
        builder = builder.with_expert_paging(experts[0],
                                             page_slots=experts[1])
    return builder.build()


def _drop_store(workdir: str, name: str) -> None:
    """The disk holds one training store at a time."""
    shutil.rmtree(os.path.join(workdir, name), ignore_errors=True)


def _act_stages(o0: dict, o1: dict) -> tuple[int, int]:
    """(gets, hits) of staged checkpoint fetches between two snapshots."""
    return (o1["act_stage_gets"] - o0["act_stage_gets"],
            o1["act_stage_hits"] - o0["act_stage_hits"])


def _act_step_line(m: dict, stages: tuple[int, int], peak: int) -> str:
    """The activation stream's share of one train step."""
    gets, hits = stages
    return (f"act_save_wait_s {m['act_save_wait_s']:.4f}, act_fetch_wait_s "
            f"{m['act_fetch_wait_s']:.4f}, act_stage_gets {gets}, "
            f"act_stage_hits {hits}, act_write_failures "
            f"{m['act_write_failures']}, activation_checkpoints peak "
            f"{peak} B")


def resident_train_reference(model, tokens, labels, device, watched):
    """Loss and the ``watched`` parameter grads of a plain device-resident
    forward and backward of the same bf16 weights through the same
    applies: no streaming, no checkpoints, one autograd graph."""
    dev = torch.device(device)
    params = [{k: to_torch(cast_host(v, "bfloat16"), torch.bfloat16)
               .to(dev).requires_grad_() for k, v in u.params.items()}
              for u in model.units]
    tok = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    lab = torch.from_numpy(labels.astype(np.int64)).to(dev)
    with torch.enable_grad():
        h = model.embed_apply(params[0], tok)
        for p in params[1:-1]:
            h = model.block_apply(p, h)
        loss = model.head_loss(params[-1], h, lab)
        loss.backward()
    index = {u.name: i for i, u in enumerate(model.units)}
    return loss.item(), {(unit, k): params[index[unit]][k].grad.float()
                         for unit, k in watched}


def adamw_reference(init: np.ndarray, grad: np.ndarray, adam, device):
    """One plain torch AdamW step on the card from the fp32 master."""
    p = torch.from_numpy(np.array(init, np.float32)).to(device)
    p.requires_grad_()
    p.grad = torch.from_numpy(np.array(grad, np.float32)).to(device)
    opt = torch.optim.AdamW([p], lr=adam.lr, betas=(adam.beta1, adam.beta2),
                            eps=adam.eps, weight_decay=adam.weight_decay)
    opt.step()
    return p.detach().cpu().numpy()


def run_train_path(args, workdir: str,
                   device: str = "cuda") -> tuple[dict, dict]:
    """The main training phase.  Returns its numbers and what the
    activation-tiers phase is held to (the model, the batch, the losses
    and the landed watched gradients)."""
    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              n_layers=args.train_layers)
    free = shutil.disk_usage(workdir).free
    print(f"training: {cfg.name} d_model {cfg.d_model} vocab {cfg.vocab}, "
          f"depth {cfg.n_layers} of 36 (--train-layers), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps; free "
          f"disk under build/: {free / 1e9:.1f} GB")
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device=device)
    rng = np.random.default_rng(args.seed + 1)
    tokens = rng.integers(0, cfg.vocab, size=(TRAIN_BATCH, TRAIN_SEQ),
                          dtype=np.int64)
    labels = np.roll(tokens, -1, axis=1)
    n_params = sum(v.size for u in model.units for v in u.params.values())
    n_tensors = sum(len(u.params) for u in model.units)
    print(f"  {n_params} parameters in {n_tensors} tensors; store needs "
          f"{14 * n_params / 1e9:.1f} GB")
    if free < 14 * n_params + (2 << 30):
        raise RuntimeError(f"not enough disk for the training store: "
                           f"{free} B free")
    check_block, check_keys = model.units[1].name, ("attn.w_q", "ffn.w_down")
    # every block's backward is held to the resident one through its
    # attn.w_q; block 0 also through its ffn.w_down
    watched = [("embed", "embed"), *((check_block, k) for k in check_keys),
               *((u.name, "attn.w_q") for u in model.units[2:-1]),
               ("head", "head")]
    t0 = time.perf_counter()
    policy = _train_policy(workdir, n_params, "train_store")
    with OffloadSession(model, policy) as session:
        setup_s = time.perf_counter() - t0
        flat_pinned = torch.from_numpy(session.flat[:1024]).is_pinned()
        _sync(device)
        overflow_flag_cuda_.launches = 0
        host_overflow.check_region.calls = 0
        steps, walls, act_stage = [], [], []
        acts = session.tracker.component("activation_checkpoints")
        for step in range(TRAIN_STEPS):
            o0 = session.overlap_snapshot()
            t1 = time.perf_counter()
            if step == TRAIN_STEPS - 1:
                # the last step under the profiler: device busy share
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    m = dict(session.train_step(tokens, labels))
                    _sync(device)
            else:
                m = dict(session.train_step(tokens, labels))
                _sync(device)
            walls.append(time.perf_counter() - t1)
            steps.append(m)
            act_stage.append(_act_stages(o0, session.overlap_snapshot()))
            print(f"  step {step + 1}: loss {m['loss']:.6f} "
                  f"{walls[-1]:.2f} s, overflowed {m['overflowed']}, "
                  f"applied {m['applied']}; "
                  f"{_act_step_line(m, act_stage[-1], acts.peak_allocated)}")
            if step == 0:
                # step 1's landed grads (the barrier drained the writer;
                # step 2's write of a unit waits for step 1's Adam of it)
                landed = {}
                for unit, key in watched:
                    off, size, shape = \
                        session._flat_offsets[f"{unit}/{key}"]
                    landed[(unit, key)] = session.flat[off:off + size] \
                        .reshape(shape).copy()
                master1 = session.master_param(check_block, check_keys[0])
        launches = overflow_flag_cuda_.launches
        host_checks = host_overflow.check_region.calls
        # the last step's Adam stage runs on past train_step's return
        t2 = time.perf_counter()
        session.synchronize()
        adam_tail_s = time.perf_counter() - t2
        t2 = time.perf_counter()
        eval_loss = session.eval_loss(tokens, labels)
        eval_s = time.perf_counter() - t2
        io = session.store.stats.snapshot()
        pinned_stats = session.tracker.component("pinned")
        requested, reserved = pinned_stats.live_requested, \
            pinned_stats.live_allocated
        optim_io = session.optimizer.last_io_bytes
        peak_host = session.tracker.peak_allocated
        act_peak = acts.peak_allocated
        act_tiers = session._act_tiers
        adam = policy.adam
    _drop_store(workdir, "train_store")

    # (e) one launch per gradient tensor per step, no host region scan
    if launches != n_tensors * TRAIN_STEPS or host_checks != 0:
        raise AssertionError(f"overflow_check launched {launches} times "
                             f"for {n_tensors} tensors x {TRAIN_STEPS} "
                             f"steps; host check_region ran {host_checks}")
    if not all(m["applied"] and not m["overflowed"] for m in steps):
        raise AssertionError("a clean training step was skipped")
    # (d) the loss falls on the repeated batch
    losses = [m["loss"] for m in steps]
    if not (np.isfinite(losses).all() and losses[0] > losses[1] > losses[2]
            and np.isfinite(eval_loss) and eval_loss < losses[0]):
        raise AssertionError(f"losses {losses}, eval {eval_loss} do not "
                             f"fall")
    # (a), (b) against the resident forward/backward
    ref_loss, ref_grads = resident_train_reference(model, tokens, labels,
                                                   device, watched)
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    print(f"  step-1 loss {losses[0]:.6f} vs resident {ref_loss:.6f}: rel "
          f"{loss_rel:.3e} (tol {LOSS_RTOL:g})")
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"step-1 loss differs from the resident "
                             f"forward: {loss_rel}")
    grad_rel = {}
    for key in watched:
        ref = ref_grads[key].cpu().numpy()
        scale = float(np.abs(ref).max())
        diff = float(np.abs(landed[key] - ref).max())
        grad_rel[f"{key[0]}/{key[1]}"] = diff / scale
        print(f"  landed grad {key[0]}/{key[1]}: max diff {diff:.3e}, "
              f"{diff / scale:.3e} of max |g| {scale:.3e} (tol "
              f"{GRAD_TOL:.3e})")
        if not diff <= GRAD_TOL * scale:
            raise AssertionError(f"landed gradient {key} differs from the "
                                 f"resident backward")
    del ref_grads
    if act_tiers != ("host",) * cfg.n_layers:
        raise AssertionError(f"the preset ran tiers {act_tiers}, not host")
    # (c) one master after step 1 against torch AdamW on the card
    init = model.units[1].params[check_keys[0]]
    ref_master = adamw_reference(init, landed[(check_block,
                                               check_keys[0])], adam, device)
    adam_rel = float(np.abs(master1 - ref_master).max()
                     / np.abs(ref_master).max())
    print(f"  {check_block}/{check_keys[0]} master after step 1 vs torch "
          f"AdamW: {adam_rel:.3e} of max (tol {ADAM_RTOL:g})")
    if not adam_rel <= ADAM_RTOL:
        raise AssertionError(f"step-1 master differs from AdamW: {adam_rel}")

    # (f) an Inf in one weight: the step is flagged and skipped
    skip = check_overflow_skip(args, workdir, device)

    busy_ms, device_events = _device_busy_ms(prof)
    print("  profiled train step, device time by kernel/copy (top 8):")
    for e in sorted(device_events,
                    key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.key[:60]:60s} {e.self_device_time_total / 1e3:9.3f} "
              f"ms x{e.count}")
    # Step 1 drains its Adam for the checks, so step 2 starts on an idle
    # pipeline; step 3 (profiled) is the one steady-state step: it waits
    # for step 2's Adam at its fetch gates.  Its own wall time is the
    # denominator (the profiler's start-up is small against it).
    step_ms = 1e3 * walls[-1]
    out = {
        "train_layers": cfg.n_layers, "train_params": n_params,
        "train_setup_s": setup_s, "step_s": walls,
        "adam_tail_s": adam_tail_s,
        "losses": losses, "eval_loss": eval_loss, "eval_s": eval_s,
        "resident_loss": ref_loss, "loss_rel_diff": loss_rel,
        "grad_rel_diff": grad_rel, "adamw_rel_diff": adam_rel,
        **{f"{k}_per_step": [m[k] for m in steps] for k in (
            "fetch_wait_s", "h2d_wait_s", "gradwrite_drain_s",
            "optim_gate_s", "optim_prefetch_wait_s", "overflow_screen_s",
            "act_save_wait_s", "act_fetch_wait_s", "act_write_failures",
            "optimizer_io_bytes", "peak_host_bytes")},
        "act_tiers": act_tiers,
        "act_stage_gets_hits_per_step": act_stage,
        "activation_checkpoints_peak_bytes": act_peak,
        "optimizer_io_bytes_last_step": optim_io,
        "peak_host_bytes": peak_host,
        "pinned_requested_bytes": requested,
        "pinned_reserved_bytes": reserved,
        "flat_buffer_is_pinned": flat_pinned,
        "store_read_GB": io["bytes_read"] / 1e9,
        "store_read_s": io["read_seconds"],
        "store_write_GB": io["bytes_written"] / 1e9,
        "store_write_s": io["write_seconds"],
        "overflow_launches": launches, "host_region_checks": host_checks,
        "skip_step": skip,
        "step_device_busy_ms": busy_ms or None,
        "device_idle_share": (1.0 - busy_ms / step_ms) if busy_ms else None,
    }
    for k, v in out.items():
        print(f"  {k}: {v}")
    if device == "cuda" and not flat_pinned:
        raise AssertionError("the gradient flat buffer is not page-locked")
    host_run = {"model": model, "tokens": tokens, "labels": labels,
                "losses": losses, "landed": landed, "watched": watched}
    return out, host_run


def tiers_for(n_layers: int) -> tuple[str, ...]:
    """ssd, host, recompute, repeated over the blocks: an ssd fetch staged
    through the async store read, a host checkpoint fetched early to seed
    its successor's recompute."""
    return tuple(("ssd", "host", "recompute")[i % 3]
                 for i in range(n_layers))


def run_act_tiers(workdir: str, host_run: dict,
                  device: str = "cuda") -> dict:
    """A second session over the same model and batch on a fresh store,
    with per-block tiers (:func:`tiers_for`): two steps, the second
    overlapping the first's Adam stage.  Step-1 loss and landed watched
    gradients, and the step-2 loss, must equal the host-tier phase's bit
    for bit; no act store write may fail."""
    model, watched = host_run["model"], host_run["watched"]
    tokens, labels = host_run["tokens"], host_run["labels"]
    tiers = tiers_for(len(model.units) - 2)
    n_params = sum(v.size for u in model.units for v in u.params.values())
    print(f"activation tiers: {tiers}, same model and batch, fresh store")
    t0 = time.perf_counter()
    with OffloadSession(model, _train_policy(workdir, n_params, "tiers_store",
                                             tiers)) as session:
        setup_s = time.perf_counter() - t0
        act_bytes = {"written": 0, "read": 0}
        store = session.store
        real_write, real_read_async = store.write, store.read_async

        def write(key, data):
            if key.startswith("__act__/"):
                act_bytes["written"] += data.nbytes
            return real_write(key, data)

        def read_async(key, out):
            if key.startswith("__act__/"):
                act_bytes["read"] += out.nbytes
            return real_read_async(key, out)

        store.write, store.read_async = write, read_async
        acts = session.tracker.component("activation_checkpoints")
        steps, walls = [], []
        for step in range(2):
            o0 = session.overlap_snapshot()
            t1 = time.perf_counter()
            m = dict(session.train_step(tokens, labels))
            _sync(device)
            walls.append(time.perf_counter() - t1)
            steps.append(m)
            line = _act_step_line(
                m, _act_stages(o0, session.overlap_snapshot()),
                acts.peak_allocated)
            print(f"  step {step + 1}: loss {m['loss']:.6f} "
                  f"{walls[-1]:.2f} s; {line}")
            if step == 0:
                # step 1's landed grads; step 2 then runs while step 1's
                # Adam streams state through the same store
                landed = {}
                for unit, key in watched:
                    off, size, shape = \
                        session._flat_offsets[f"{unit}/{key}"]
                    landed[(unit, key)] = session.flat[off:off + size] \
                        .reshape(shape).copy()
        snap = session.overlap_snapshot()
        t2 = time.perf_counter()
        session.synchronize()
        adam_tail_s = time.perf_counter() - t2
        act_peak = acts.peak_allocated
    _drop_store(workdir, "tiers_store")
    losses = [m["loss"] for m in steps]
    host = host_run["losses"]
    out = {"tiers": tiers, "setup_s": setup_s, "step_s": walls,
           "adam_tail_s": adam_tail_s, "losses": losses,
           "host_losses": host[:2],
           **{f"{k}_per_step": [m[k] for m in steps] for k in (
               "act_save_wait_s", "act_fetch_wait_s", "act_write_failures",
               "fetch_wait_s", "optim_gate_s")},
           "act_stage_gets": snap["act_stage_gets"],
           "act_stage_hits": snap["act_stage_hits"],
           "act_store_bytes_written": act_bytes["written"],
           "act_store_bytes_read": act_bytes["read"],
           "activation_checkpoints_peak_bytes": act_peak}
    for k, v in out.items():
        print(f"  {k}: {v}")
    if any(m["act_write_failures"] for m in steps):
        raise AssertionError("an activation store write failed")
    if losses != host[:2]:
        raise AssertionError(f"tier losses {losses} differ from the host "
                             f"tier's {host[:2]}")
    for key in watched:
        if not np.array_equal(landed[key].view(np.uint32),
                              host_run["landed"][key].view(np.uint32)):
            diff = float(np.abs(landed[key] - host_run["landed"][key]).max())
            raise AssertionError(f"landed gradient {key} differs from the "
                                 f"host tier's (max {diff})")
    print(f"  step-1 loss, {len(watched)} landed gradients and the step-2 "
          f"loss equal the host tier's bit for bit")
    return out


def check_overflow_skip(args, workdir: str, device: str) -> dict:
    """A 2-layer session at full width whose block_000 ``ffn.w_down``
    holds one Inf: its step must be flagged and skipped, every master
    kept, and the scaler backed off as DynamicLossScaler.update does."""
    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=2)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device=device)
    w = model.units[1].params["ffn.w_down"]
    w[0, 0] = np.inf
    n_params = sum(v.size for u in model.units for v in u.params.values())
    tokens = np.random.default_rng(args.seed + 2).integers(
        0, cfg.vocab, size=(TRAIN_BATCH, TRAIN_SEQ), dtype=np.int64)
    t0 = time.perf_counter()
    with OffloadSession(model, _train_policy(workdir, n_params,
                                             "skip_store")) as session:
        scaler = session.scaler
        scale0 = scaler.scale
        m = session.train_step(tokens, np.roll(tokens, -1, axis=1))
        kept = session.master_param(model.units[1].name, "ffn.w_down")
        embed = session.master_param("embed", "embed")
        backed_off = max(scale0 * scaler.backoff_factor, scaler.min_scale)
        result = {"overflowed": m["overflowed"], "applied": m["applied"],
                  "loss_scale": m["loss_scale"],
                  "n_overflows": scaler.n_overflows,
                  "seconds": time.perf_counter() - t0}
    print(f"  Inf in {model.units[1].name}/ffn.w_down: {result}")
    if not (m["overflowed"] and not m["applied"]
            and scaler.n_overflows == 1 and m["loss_scale"] == backed_off):
        raise AssertionError(f"the Inf step was not skipped: {result}")
    if not (np.array_equal(kept.view(np.uint32), w.view(np.uint32))
            and np.array_equal(embed, model.units[0].params["embed"])):
        raise AssertionError("a skipped step changed the masters")
    _drop_store(workdir, "skip_store")
    return result


# -- phase 8: serving breadth ------------------------------------------------------

SERVE_BATCH, SERVE_MAX_SEQ, SERVE_BUCKET = 4, 640, 64
UNCACHED_PROMPT, UNCACHED_NEW = 128, 3
N_REQUESTS, ARRIVAL_SPAN_S = 8, 2.0
SPEC_PATTERN, SPEC_PROMPT, SPEC_NEW, SPEC_K = 32, 256, 12, 4


def _serve_decoder(args, workdir: str):
    """One ``memascend`` decoder of qwen3-4b at full width and
    ``--serve-layers`` depth, overlap ``full``, on a direct-NVMe store."""
    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              n_layers=args.serve_layers)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 3)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device="cuda")
    spec = DecodeSpec(batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
                      bucket=SERVE_BUCKET)
    n_params = sum(v.size for u in model.units for v in u.params.values())
    kv_bytes = 2 * 2 * SERVE_BATCH * SERVE_MAX_SEQ * cfg.n_kv_heads * \
        cfg.head_dim * cfg.n_layers
    capacity = -(-(2 * n_params + kv_bytes) // 2) + (256 << 20)
    policy = OffloadPolicy.preset("memascend").with_store(
        factory=lambda: DirectNVMeEngine(os.path.join(workdir, "serve_store"),
                                         n_devices=2,
                                         device_capacity=capacity)).build()
    if policy.overlap != "full":
        raise AssertionError(f"memascend overlap is {policy.overlap!r}")
    return cfg, OffloadedDecoder(model, policy, decode=spec)


def run_uncached(cfg, dec, rng) -> dict:
    """``generate(use_cache=False)`` at batch 4, prompt 128; the first
    step's logits (``step_logits``) against the cached prefill's."""
    prompts = rng.integers(0, cfg.vocab, size=(SERVE_BATCH, UNCACHED_PROMPT))
    t0 = time.perf_counter()
    tokens = dec.generate(prompts, UNCACHED_NEW, use_cache=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    first = dec.step_logits(prompts)
    cached = dec.generate(prompts, UNCACHED_NEW)
    s = dec.session
    kv = s.open_kv_cache()
    try:
        pre = s.prefill(kv, prompts)
    finally:
        kv.close()
    if tokens.shape != (SERVE_BATCH, UNCACHED_NEW) or \
            not np.isfinite(first).all():
        raise AssertionError(f"bad uncached output {tokens.shape}")
    scale = np.maximum(np.abs(pre).max(-1, keepdims=True), 1.0)
    rel = float((np.abs(first - pre) / scale).max())
    agree = float((tokens == cached).mean())
    print(f"  uncached: {UNCACHED_NEW} tokens at batch {SERVE_BATCH} from a "
          f"{UNCACHED_PROMPT}-token prompt in {seconds:.2f} s; first-step "
          f"logits vs cached prefill: max row-scaled diff {rel:.3e} (tol "
          f"{LOGIT_TOL:.3e}); token agreement with the cached path "
          f"{agree:.3f}")
    if not rel <= LOGIT_TOL:
        raise AssertionError(f"uncached first-step logits differ from the "
                             f"cached prefill's: {rel} > {LOGIT_TOL}")
    return {"uncached_s": seconds, "uncached_logit_rel_diff": rel,
            "uncached_token_agreement": agree}


def _requests(cfg, rng) -> list:
    lens = rng.integers(64, 449, N_REQUESTS)
    budgets = rng.integers(4, 9, N_REQUESTS)
    arrivals = np.sort(rng.uniform(0.0, ARRIVAL_SPAN_S, N_REQUESTS))
    arrivals[0] = 0.0
    return [Request(rid=f"r{i}", prompt=rng.integers(0, cfg.vocab, int(n)),
                    max_new_tokens=int(m), arrival=float(a))
            for i, (n, m, a) in enumerate(zip(lens, budgets, arrivals,
                                              strict=True))]


def run_continuous(cfg, dec, rng) -> dict:
    """``ServingEngine.run`` over staggered ragged requests on the wall
    clock, under the profiler (device busy share); then two requests
    re-run alone through a fresh engine."""
    reqs = _requests(cfg, rng)
    engine = ServingEngine(dec)
    torch.cuda.synchronize()
    zero_attention_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        report = engine.run(reqs)
        torch.cuda.synchronize()
    launches = swa_attention_cuda.launches
    states = [r.state for r in report.requests]
    if states != [RequestState.DONE] * N_REQUESTS:
        raise AssertionError(f"request states {states}")
    check_attention_counts(
        0, f"{report.prefills} prefill groups of {cfg.n_layers} blocks")
    if not report.kv_stats["reclaims"] > 0:
        raise AssertionError("retired slots' pages were not reclaimed")
    for r in report.requests:
        if not (1 <= len(r.output) <= r.max_new_tokens
                and all(0 <= t < cfg.vocab for t in r.output)):
            raise AssertionError(f"bad output for {r.rid}: {r.output}")
    solo = {}
    for r in (report.requests[0], report.requests[-1]):
        alone = ServingEngine(dec).run([Request(
            rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)])
        solo[r.rid] = alone.requests[0].output
        if solo[r.rid] != r.output:
            raise AssertionError(f"{r.rid} served alone gave other tokens: "
                                 f"{solo[r.rid]} vs {r.output}")
    busy_ms, _events = _device_busy_ms(prof)
    out = {"requests": N_REQUESTS, "prompt_lens": [r.prompt_len
                                                   for r in reqs],
           "duration_s": report.duration_s,
           "tokens": report.total_tokens,
           "tokens_per_s": report.tokens_per_s,
           "occupancy": report.occupancy,
           "ttft_p50_s": report.ttft_percentile(50),
           "ttft_p99_s": report.ttft_percentile(99),
           "prefill_groups": report.prefills,
           "decode_steps": report.decode_steps,
           "swa_launches": launches,
           "kv_reclaims": report.kv_stats["reclaims"],
           "device_busy_ms": busy_ms or None,
           "device_idle_share": (1.0 - busy_ms / (1e3 * report.duration_s))
           if busy_ms else None,
           "solo_equal": sorted(solo)}
    print(f"  continuous: {out}")
    return out


def run_speculative(cfg, dec, rng) -> dict:
    """``generate(spec=SpecConfig(k=4))`` against the plain greedy tokens,
    and one 4-token ``verify_step`` against the ``decode_step`` chain."""
    patterns = rng.integers(0, cfg.vocab, (SERVE_BATCH, SPEC_PATTERN))
    prompts = np.tile(patterns, (1, SPEC_PROMPT // SPEC_PATTERN))
    t0 = time.perf_counter()
    plain = dec.generate(prompts, SPEC_NEW)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = dec.generate(prompts, SPEC_NEW, spec=SpecConfig(k=SPEC_K))
    spec_s = time.perf_counter() - t0
    stats = dec.spec_stats
    if not np.array_equal(fast, plain):
        raise AssertionError(f"speculative tokens differ from plain greedy: "
                             f"{fast} vs {plain}")
    s = dec.session
    window = np.concatenate([plain[:, :1], rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SPEC_K - 1))], axis=1)
    # the chain's first step and the verify pass under the profiler: the
    # device time a window of per-position (B, 1) products costs
    kv = s.open_kv_cache()
    try:
        s.prefill(kv, prompts)
        chain = []
        for j in range(SPEC_K):
            with _maybe_profile(j == 0) as prof:
                chain.append(s.decode_step(kv, window[:, j:j + 1]))
                torch.cuda.synchronize()
            if j == 0:
                step_busy_ms, _ = _device_busy_ms(prof)
    finally:
        kv.close()
    kv = s.open_kv_cache()
    try:
        s.prefill(kv, prompts)
        with _maybe_profile(True) as prof:
            verify = s.verify_step(kv, window)
            torch.cuda.synchronize()
        verify_busy_ms, _ = _device_busy_ms(prof)
    finally:
        kv.close()
    for j in range(SPEC_K):
        if not torch.equal(torch.from_numpy(verify[:, j]),
                           torch.from_numpy(chain[j])):
            raise AssertionError(f"verify logits at window position {j} "
                                 f"differ from the decode_step chain")
    out = {"plain_s": plain_s, "spec_s": spec_s, "rounds": stats.rounds,
           "accepted_per_step": stats.accepted_per_step,
           "drafted": stats.drafted, "accepted": stats.accepted,
           "spec_overhead_s": stats.spec_overhead_s,
           "verify_equals_step_chain": True,
           "step_device_ms": step_busy_ms or None,
           "verify_device_ms": verify_busy_ms or None}
    print(f"  speculative: {out}")
    return out


def _maybe_profile(on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def run_serve_paths(args, workdir: str) -> dict:
    rng = np.random.default_rng(args.seed + 3)
    t0 = time.perf_counter()
    cfg, dec = _serve_decoder(args, workdir)
    with dec:
        out = {"serve_layers": cfg.n_layers,
               "serve_setup_s": time.perf_counter() - t0}
        print(f"serving breadth: {cfg.name} depth {cfg.n_layers} of 36 "
              f"(--serve-layers), batch {SERVE_BATCH}, max_seq "
              f"{SERVE_MAX_SEQ}, bucket {SERVE_BUCKET}; setup "
              f"{out['serve_setup_s']:.2f} s")
        for name, phase in (("uncached", run_uncached),
                            ("continuous", run_continuous),
                            ("speculative", run_speculative)):
            t = time.perf_counter()
            out[name] = phase(cfg, dec, rng)
            out[f"{name}_phase_s"] = time.perf_counter() - t
            print(f"  {name} phase: {out[f'{name}_phase_s']:.1f} s")
    return out


# -- phase 9: MoE expert paging -----------------------------------------------

MOE_BATCH, MOE_SEQ, MOE_STEPS = 2, 512, 2
# host expert-page budget: one layer's 128 experts x 3 tensors
MOE_PAGE_SLOTS = 384
MOE_DECODE_BATCH, MOE_PROMPT, MOE_NEW = 4, 512, 8


def _moe_config(n_layers: int):
    return dataclasses.replace(get_config("qwen3-30b-a3b"), n_layers=n_layers)


def _expert_counters(o0: dict, o1: dict) -> dict:
    return {k: o1[k] - o0[k] for k in ("expert_fetch_bytes",
                                      "expert_stage_gets",
                                      "expert_stage_hits")}


def resident_moe_loss(model, tokens, labels, device) -> float:
    """Loss of a plain device-resident forward of the same bf16 weights,
    each paged block's per-expert pages stacked back into (E, ...) tensors
    and run through the model's full-sequence block (free top-k)."""
    dev = torch.device(device)
    tok = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    lab = torch.from_numpy(labels.astype(np.int64)).to(dev)
    with torch.no_grad():
        h = model.embed_apply(_resident(model.units[0].params, dev), tok)
        for unit in model.units[1:-1]:
            p = _resident(unit.params, dev)
            triples = model.expert_meta[unit.name]["experts"]
            for j, name in enumerate(("moe.w_gate", "moe.w_up",
                                      "moe.w_down")):
                p[name] = torch.stack([p.pop(t[j]) for t in triples])
            h = model.block_apply(p, h)
            del p
        return model.head_loss(_resident(model.units[-1].params, dev), h,
                               lab).item()


def run_moe_train(args, workdir: str, device: str = "cuda") -> dict:
    """Two train steps under expert_paging "all", then the same two on a
    fresh store under "routed", over one model and batch."""
    cfg = _moe_config(args.moe_train_layers)
    free = shutil.disk_usage(workdir).free
    gen = torch.Generator(device=device).manual_seed(args.seed + 4)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device=device,
                                expert_paging="routed")
    rng = np.random.default_rng(args.seed + 4)
    tokens = rng.integers(0, cfg.vocab, size=(MOE_BATCH, MOE_SEQ),
                          dtype=np.int64)
    labels = np.roll(tokens, -1, axis=1)
    n_params = sum(v.size for u in model.units for v in u.params.values())
    n_tensors = sum(len(u.params) for u in model.units)
    e = cfg.moe
    print(f"MoE training: {cfg.name} d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} experts {e.n_experts} top-"
          f"{e.top_k} d_ff_expert {e.d_ff_expert} vocab {cfg.vocab}, depth "
          f"{cfg.n_layers} of 48 (--moe-train-layers), batch {MOE_BATCH} x "
          f"{MOE_SEQ}, {MOE_STEPS} steps an arm; {n_params} parameters in "
          f"{n_tensors} tensors, store {14 * n_params / 1e9:.1f} GB; free "
          f"disk {free / 1e9:.1f} GB")
    if free < 14 * n_params + (2 << 30):
        raise RuntimeError(f"not enough disk for the MoE store: {free} B")
    arms = {}
    for mode in ("all", "routed"):
        t0 = time.perf_counter()
        policy = _train_policy(workdir, n_params, f"moe_{mode}",
                               experts=(mode, MOE_PAGE_SLOTS))
        with OffloadSession(model, policy) as session:
            setup_s = time.perf_counter() - t0
            _sync(device)
            overflow_flag_cuda_.launches = 0
            steps, walls, experts = [], [], []
            for step in range(MOE_STEPS):
                o0 = session.overlap_snapshot()
                t1 = time.perf_counter()
                m = dict(session.train_step(tokens, labels))
                _sync(device)
                walls.append(time.perf_counter() - t1)
                steps.append(m)
                experts.append(_expert_counters(o0,
                                                session.overlap_snapshot()))
                print(f"  {mode} step {step + 1}: loss {m['loss']!r} "
                      f"{walls[-1]:.2f} s, optim_gate_s "
                      f"{m['optim_gate_s']:.2f}, expert_fetch_wait_s "
                      f"{m['expert_fetch_wait_s']:.3f}, {experts[-1]}")
            launches = overflow_flag_cuda_.launches
            t2 = time.perf_counter()
            session.synchronize()
            adam_tail_s = time.perf_counter() - t2
            pinned = session.tracker.component("pinned")
            arms[mode] = {
                "setup_s": setup_s, "step_s": walls,
                "adam_tail_s": adam_tail_s,
                "losses": [m["loss"] for m in steps],
                "applied": [m["applied"] for m in steps],
                "overflow_launches": launches,
                "expert_per_step": experts,
                "expert_fetch_wait_s": [m["expert_fetch_wait_s"]
                                        for m in steps],
                "optim_gate_s": [m["optim_gate_s"] for m in steps],
                "fetch_wait_s": [m["fetch_wait_s"] for m in steps],
                "peak_host_bytes": session.tracker.peak_allocated,
                "pinned_requested_bytes": pinned.live_requested,
                "pinned_reserved_bytes": pinned.live_allocated,
                "expert_cache": session.expert_cache_stats()}
        _drop_store(workdir, f"moe_{mode}")
        print(f"  {mode}: {arms[mode]}")
    ref_loss = resident_moe_loss(model, tokens, labels, device)
    got = arms["all"]["losses"]
    loss_rel = abs(got[0] - ref_loss) / abs(ref_loss)
    bytes_ = {m: sum(x["expert_fetch_bytes"]
                     for x in arms[m]["expert_per_step"]) for m in arms}
    out = {"moe_train_layers": cfg.n_layers, "moe_train_params": n_params,
           "moe_train_tensors": n_tensors, "arms": arms,
           "resident_loss": ref_loss, "loss_rel_diff": loss_rel,
           "expert_fetch_bytes": bytes_,
           "routed_over_all_bytes": bytes_["routed"] / bytes_["all"]}
    print(f"  step-1 loss {got[0]!r} vs resident {ref_loss!r}: rel "
          f"{loss_rel:.3e} (tol {LOSS_RTOL:g}); expert bytes routed/all "
          f"{out['routed_over_all_bytes']:.4f}")
    if arms["all"]["losses"] != arms["routed"]["losses"]:
        raise AssertionError(f"routed losses {arms['routed']['losses']} "
                             f"differ from all-resident "
                             f"{arms['all']['losses']}")
    if not (np.isfinite(got).all() and all(
            all(a["applied"]) for a in arms.values())):
        raise AssertionError(f"MoE losses {got} not finite or not applied")
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"MoE step-1 loss differs from the resident "
                             f"forward: {loss_rel}")
    launches = [a["overflow_launches"] for a in arms.values()]
    if launches != [n_tensors * MOE_STEPS] * 2:
        raise AssertionError(f"overflow_check launches {launches} for "
                             f"{n_tensors} tensors x {MOE_STEPS} steps")
    # at 1,024 tokens nearly every expert is routed: the routed arm saves
    # few bytes, and a mispredicted prestage may even cost some
    if not min(bytes_.values()) > 0:
        raise AssertionError(f"expert bytes {bytes_}")
    return out


def run_moe_decode(args, workdir: str) -> dict:
    """Cached greedy decode over a paged-MoE serve session under "all",
    then "routed", each on its own store (dropped after)."""
    cfg = _moe_config(args.moe_layers)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 5)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device="cuda",
                                expert_paging="routed")
    prompts = np.random.default_rng(args.seed + 5).integers(
        0, cfg.vocab, size=(MOE_DECODE_BATCH, MOE_PROMPT), dtype=np.int64)
    spec = DecodeSpec(batch=MOE_DECODE_BATCH,
                      max_seq=MOE_PROMPT + MOE_NEW + BUCKET, bucket=BUCKET)
    n_params = sum(v.size for u in model.units for v in u.params.values())
    kv_bytes = 2 * 2 * MOE_DECODE_BATCH * spec.max_seq * cfg.n_kv_heads * \
        cfg.head_dim * cfg.n_layers
    capacity = -(-(2 * n_params + kv_bytes) // 2) + (256 << 20)
    print(f"MoE decode: {cfg.name} depth {cfg.n_layers} of 48 "
          f"(--moe-layers), batch {MOE_DECODE_BATCH}, prompt {MOE_PROMPT}, "
          f"{MOE_NEW} new tokens; {n_params} parameters, serve store "
          f"{2 * n_params / 1e9:.2f} GB an arm")
    arms = {}
    for mode in ("all", "routed"):
        root = os.path.join(workdir, f"moe_serve_{mode}")
        policy = (OffloadPolicy.preset("memascend")
                  .with_expert_paging(mode, page_slots=MOE_PAGE_SLOTS)
                  .with_store(factory=lambda root=root: DirectNVMeEngine(
                      root, n_devices=2, device_capacity=capacity))
                  .build())
        t0 = time.perf_counter()
        with OffloadedDecoder(model, policy, decode=spec) as dec:
            setup_s = time.perf_counter() - t0
            s = dec.session
            o0 = s.overlap_snapshot()
            t1 = time.perf_counter()
            tokens = dec.generate(prompts, MOE_NEW)
            torch.cuda.synchronize()
            generate_s = time.perf_counter() - t1
            o1 = s.overlap_snapshot()
            arms[mode] = {"setup_s": setup_s, "generate_s": generate_s,
                          "tokens": tokens,
                          **_expert_counters(o0, o1),
                          "expert_fetch_wait_s":
                              o1["expert_fetch_wait_seconds"]
                              - o0["expert_fetch_wait_seconds"],
                          "peak_host_bytes": s.tracker.peak_allocated,
                          "expert_cache": s.expert_cache_stats()}
        shutil.rmtree(root, ignore_errors=True)
        print(f"  {mode}: " + str({k: v for k, v in arms[mode].items()
                                   if k != "tokens"}))
    toks = [arms[m].pop("tokens") for m in ("all", "routed")]
    ratio = arms["routed"]["expert_fetch_bytes"] / \
        arms["all"]["expert_fetch_bytes"]
    out = {"moe_layers": cfg.n_layers, "moe_serve_params": n_params,
           "arms": arms, "routed_over_all_bytes": ratio,
           "tokens_equal": bool(np.array_equal(*toks))}
    print(f"  tokens equal: {out['tokens_equal']}; expert bytes "
          f"routed/all {ratio:.4f}")
    if toks[0].shape != (MOE_DECODE_BATCH, MOE_NEW) or \
            not (0 <= toks[0]).all() or not (toks[0] < cfg.vocab).all():
        raise AssertionError(f"bad MoE tokens {toks[0].shape}")
    if not out["tokens_equal"]:
        raise AssertionError(f"routed decode tokens {toks[1]} differ from "
                             f"all-resident {toks[0]}")
    if not 0 < ratio < 1:
        raise AssertionError(f"routed decode moved {ratio} of the "
                             f"all-resident expert bytes")
    return out


# -- phase 10: the device-resident path ----------------------------------------

RESIDENT_STEPS = 3
# SGD lr of the resident loop (the launcher's loop is plain SGD on fp32
# masters): large enough that three steps on one batch lower the loss far
# past the bf16 compute's noise on it (on an H100 at 4 layers it fell
# 12.30 -> 11.48 -> 10.71), so "the loss falls" is a real check
RESIDENT_LR = 1e-2


def _resident_tree(cfg, model, device):
    """The offloaded model's weights as the resident tree: blocks stacked
    into one period group, each weight rounded to bf16 (the offloaded
    session's compute weights) and held in fp32 (the resident path's
    masters, as the launcher's loop keeps them)."""
    blocks = [u.params for u in model.units[1:-1]]
    tree = {"embed": model.units[0].params["embed"],
            "final_norm": model.units[-1].params["final_norm"],
            "groups": [{k: np.stack([b[k] for b in blocks])
                        for k in blocks[0]}]}
    if not cfg.tie_embeddings:
        tree["head"] = model.units[-1].params["head"]
    params = from_numpy_params(cfg, tree, torch.bfloat16, device)
    return tree_map(lambda t: t.float(), params)


def run_resident_train(host_run: dict, device: str = "cuda") -> dict:
    """Three steps of the launcher's resident loop (build_train_step, the
    loss scaler, SGD) on the training phase's qwen3-4b model and batch,
    held to that phase's offloaded step-1 loss on the same bf16
    weights."""
    model = host_run["model"]
    tokens, labels = host_run["tokens"], host_run["labels"]
    offloaded_loss = host_run["losses"][0]
    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              n_layers=len(model.units) - 2)
    n_params = sum(v.size for u in model.units for v in u.params.values())
    print(f"resident training: {cfg.name} depth {cfg.n_layers} of 36 (the "
          f"training phase's model and batch, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}), {RESIDENT_STEPS} SGD steps at lr "
          f"{RESIDENT_LR:g}; {n_params} parameters in the offloaded units")
    dev = torch.device(device)
    base = _allocated(device)
    params = _resident_tree(cfg, model, dev)
    n_leaves = len(tree_leaves(params))
    impl = build(cfg, device=dev)
    step = build_train_step(impl)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    scaler = DynamicLossScaler(scale=1.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, flags, walls = [], [], []
    clock = [time.perf_counter()]

    def on_step(i, loss, overflowed):
        _sync(device)
        walls.append(time.perf_counter() - clock[0])
        losses.append(float(loss))
        flags.append(overflowed)
        clock[0] = time.perf_counter()

    _sync(device)
    overflow_flag_cuda_.launches = 0
    clock[0] = time.perf_counter()
    params = resident_loop(step, params, [batch] * RESIDENT_STEPS,
                           lr=RESIDENT_LR, scaler=scaler, on_step=on_step)
    launches = overflow_flag_cuda_.launches
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None

    # the kernel against its plain version on every gradient leaf of one
    # more step (these launches are not the path's), whose peak the dry run
    # predicts
    (_loss, grads, overflow), step_peak = _step_peak(
        lambda: step(params, batch, scaler.scale), device, base)
    leaves = tree_leaves(grads)
    if dev.type == "cuda":
        for g in leaves:
            _ov_agree(g.contiguous(), expect=False)
        g = leaves[-1].clone()
        g.view(-1)[-1] = float("inf")
        _ov_agree(g, expect=True)
    del grads, leaves, params
    loss_rel = abs(losses[0] - offloaded_loss) / abs(offloaded_loss)
    out = {"resident_layers": cfg.n_layers, "losses": losses,
           "overflowed": flags, "step_s": walls,
           "offloaded_step1_loss": offloaded_loss, "loss_rel_diff": loss_rel,
           "gradient_leaves": n_leaves, "overflow_launches": launches,
           "max_memory_allocated": peak, "step_peak_bytes": step_peak}
    for k, v in out.items():
        print(f"  {k}: {v}")
    if any(flags) or bool(overflow):
        raise AssertionError(f"a clean resident step overflowed: {flags}")
    if not (np.isfinite(losses).all() and losses[0] > losses[1] > losses[2]):
        raise AssertionError(f"resident losses {losses} do not fall")
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"resident step-1 loss {losses[0]} differs "
                             f"from the offloaded {offloaded_loss}: "
                             f"{loss_rel}")
    # one screen launch per gradient leaf a step, on the card
    if device == "cuda" and launches != n_leaves * RESIDENT_STEPS:
        raise AssertionError(f"overflow_check launched {launches} times "
                             f"for {n_leaves} leaves x {RESIDENT_STEPS} "
                             f"steps")
    return out


# -- phase 17: the (data, model) mesh ----------------------------------------

MESH_PROMPT, MESH_NEW = 8, 8
# the meshed step's loss and gradients vs the unmeshed step's, should they
# not be bit-equal: 8 bf16 ULPs of each tensor's max abs, the repo's bf16
# bound
MESH_GRAD_ULPS = 8.0


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bf16 ULPs of ``want``'s max abs."""
    scale = float(want.abs().max())
    if scale == 0.0:
        return 0.0 if torch.equal(got, want) else float("inf")
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float((got.float() - want.float()).abs().max()) / ulp


def _greedy_logits(serve, params, cache, prompt, new: int) -> list:
    """Every step's logits: the prompt fed a token a step, then ``new``
    greedy tokens, each the argmax of the step before."""
    rows, tok = [], prompt[:, :1]
    for t in range(prompt.shape[1] + new):
        logits, cache = serve(params, cache, tok, t)
        full = logits.full_tensor() if hasattr(logits, "full_tensor") \
            else logits
        rows.append(full[:, 0])
        tok = prompt[:, t + 1:t + 2] if t + 1 < prompt.shape[1] else \
            full[:, -1:].argmax(-1).to(torch.int32)
    return rows


def run_mesh_phase(host_run: dict, device: str = "cuda") -> dict:
    """The resident steps over the 1x1 host mesh of a one-rank NCCL group:
    one train step of the training phase's qwen3-4b model and batch and
    greedy decode under "zero3" and "tp", each against the unmeshed step
    on the same inputs; the overflow kernel on the gradients' local
    shards."""
    t0 = time.perf_counter()
    model = host_run["model"]
    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              n_layers=len(model.units) - 2)
    dev = torch.device(device)
    params = _resident_tree(cfg, model, dev)
    impl = build(cfg, device=dev)
    batch = {"tokens": torch.from_numpy(host_run["tokens"]).to(dev),
             "labels": torch.from_numpy(host_run["labels"]).to(dev)}
    batch_shape = {k: TensorSpec(tuple(v.shape), v.dtype)
                   for k, v in batch.items()}
    want_loss, want, want_ov = build_train_step(impl)(params, batch, 1.0)
    shape = InputShape("mesh_decode", MESH_PROMPT + MESH_NEW, TRAIN_BATCH,
                       "decode")
    prompt = batch["tokens"][:, :MESH_PROMPT].to(torch.int32)
    serve, _specs = build_serve_step(impl, shape)
    cache = impl.init_cache(TRAIN_BATCH, shape.seq_len, torch.bfloat16)
    want_rows = _greedy_logits(serve, params, cache, prompt, MESH_NEW)
    out = {"backend": "nccl" if dev.type == "cuda" else "gloo",
           "layers": cfg.n_layers}
    with one_rank_group(out["backend"]):
        mesh = make_host_mesh(device_type=dev.type)
        step, in_pl, _out = build_train_step(impl, mesh,
                                             batch_shape=batch_shape)
        mparams = shd.place(params, in_pl[0], mesh)
        _sync(device)
        overflow_flag_cuda_.launches = 0
        t = time.perf_counter()
        loss, grads, overflow = step(mparams, batch, 1.0)
        _sync(device)
        out["train_step_s"] = time.perf_counter() - t
        out["overflow_launches_per_step"] = overflow_flag_cuda_.launches
        full = shd.full_tree(grads)
        pairs = list(zip(tree_leaves(full), tree_leaves(want)))
        out["gradient_leaves"] = len(pairs)
        out["loss"], out["unmeshed_loss"] = float(loss), float(want_loss)
        out["grads_bit_equal"] = all(torch.equal(a, b) for a, b in pairs)
        out["loss_bit_equal"] = torch.equal(loss, want_loss)
        out["loss_ulps"] = _bf16_ulps(loss, want_loss)
        out["max_grad_ulps"] = max(_bf16_ulps(a, b) for a, b in pairs)
        out["overflow"], out["unmeshed_overflow"] = bool(overflow), \
            bool(want_ov)
        del full, pairs
        # an Inf in one gradient's local shard: the kernel on the shards,
        # the flag through the group's MAX all-reduce
        g = tree_leaves(grads)[-1].to_local()
        g.view(-1)[-1] = float("inf")
        out["inf_flag"] = bool(grads_overflow_flag(grads))
        del grads, g
        for mode in ("zero3", "tp"):
            t = time.perf_counter()
            mserve, s_in, _o, _a = build_serve_step(impl, shape, mesh,
                                                    param_mode=mode)
            rows = _greedy_logits(mserve, shd.place(params, s_in[0], mesh),
                                  cache, prompt, MESH_NEW)
            out[f"{mode}_logits_equal"] = all(
                torch.equal(a, b) for a, b in zip(rows, want_rows))
            out[f"{mode}_max_logit_ulps"] = max(
                _bf16_ulps(a, b) for a, b in zip(rows, want_rows))
            out[f"{mode}_decode_s"] = time.perf_counter() - t
    del params, want
    out["phase_s"] = time.perf_counter() - t0
    print(f"mesh phase ({out['backend']} group of one rank, 1x1 "
          f"(data, model) mesh, qwen3-4b depth {cfg.n_layers}, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} train, {MESH_PROMPT} + {MESH_NEW} "
          f"greedy tokens):")
    for k, v in out.items():
        print(f"  {k}: {v}")
    if not (out["loss_bit_equal"] and out["grads_bit_equal"]) and \
            not max(out["loss_ulps"], out["max_grad_ulps"]) <= \
            MESH_GRAD_ULPS:
        raise AssertionError(f"meshed loss / gradients off the unmeshed "
                             f"step by {out['loss_ulps']} / "
                             f"{out['max_grad_ulps']} bf16 ULPs")
    if out["overflow"] != out["unmeshed_overflow"] or out["overflow"] \
            or not out["inf_flag"]:
        raise AssertionError(f"mesh overflow flags {out}")
    if device == "cuda" and \
            out["overflow_launches_per_step"] != out["gradient_leaves"]:
        raise AssertionError(f"overflow_check launched "
                             f"{out['overflow_launches_per_step']} times for "
                             f"{out['gradient_leaves']} local shards")
    if not (out["zero3_logits_equal"] and out["tp_logits_equal"]):
        raise AssertionError("meshed decode logits differ from the "
                             "unmeshed serve step's")
    return out


MESH_DRY_RUNS = {"qwen3-4b train_4k zero3": ("train_4k", "zero3"),
                 "qwen3-4b decode_32k zero3": ("decode_32k", "zero3"),
                 "qwen3-4b decode_32k tp": ("decode_32k", "tp")}


def mesh_dry_run_records() -> dict:
    """The pod-mesh (16x16) dry runs of qwen3-4b at full width, rank 0's
    numbers (no card: a fake process group of 256 ranks)."""
    out = {}
    for name, (shape, mode) in MESH_DRY_RUNS.items():
        t0 = time.perf_counter()
        rec = lower_pair("qwen3-4b", shape, "pod", serve_param_mode=mode)
        rec["wall_s"] = time.perf_counter() - t0
        out[name] = rec
    return out


def print_mesh_dry_runs(records: dict) -> dict:
    rows = {}
    print("pod-mesh dry run (16x16, rank 0; computed, not measured; "
          f"roofline at {PEAK_FLOPS:.3g} FLOP/s, {HBM_BW:.3g} B/s, "
          f"{LINK_BW:.3g} B/s a link):")
    for name, rec in records.items():
        mem = rec["memory"]
        r = analyze(rec)
        row = {"argument_bytes": mem["argument_size_in_bytes"],
               "temp_bytes": mem["temp_size_in_bytes"],
               "output_bytes": mem["output_size_in_bytes"],
               "peak_bytes": mem["argument_size_in_bytes"]
               + mem["temp_size_in_bytes"] + mem["output_size_in_bytes"],
               "collective_bytes": rec["collectives"]["bytes"],
               "collective_counts": rec["collectives"]["counts"],
               "compute_s": r.compute_s, "memory_s": r.memory_s,
               "collective_s": r.collective_s, "dominant": r.dominant,
               "fits": r.fits, "dry_run_s": rec["wall_s"]}
        rows[name] = row
        print(f"  {name}: {row}")
        if rec["collectives"]["counts"]["all-gather"] == 0:
            raise AssertionError(f"{name}: no all-gather on the pod mesh")
    return rows


# -- phase 11: resident MLA decode ---------------------------------------------

MLA_BATCH, MLA_PROMPT, MLA_NEW = 2, 64, 16
# the teacher-forced audit's router capacity, as the reference's own
# decode-vs-forward test sets it: the prefill drops over-capacity tokens
# and decode never does, a semantic difference, not a cache fault
MLA_CAPACITY = 16.0
# the audit's bound, the reference's own (tests/test_consistency_extra.py,
# rtol = atol = 2e-3), at fp32 compute over the same bf16 weights: at
# bf16 compute the router's logits are bf16, a one-ULP difference between
# the (B, 1) and (B, S) products reorders a near-tie of the 8th and 9th
# of 256 experts for a few of 158 tokens, and a swapped expert moves that
# row's logits by ~10 % of its max (0.115, with 95.6 % argmax agreement,
# on an H100 at 1 layer); at fp32 such a tie needs a ~1e-7 gap
MLA_TOL = 2e-3


def _mla_config(n_layers: int, capacity: float | None = None):
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              n_layers=n_layers)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


def _fresh_cache(impl, params, batch: int, max_seq: int, dtype,
                 frames=None):
    """A serve step's starting cache; for whisper (``frames`` given) with
    the cross K/V of the encoded frames (encoded at ``dtype``, the
    caller's compute dtype)."""
    cache = impl.init_cache(batch, max_seq, dtype=dtype)
    if frames is None:
        return cache
    with torch.no_grad():
        memory = whs.encode(impl.cfg, params, frames.to(dtype))
        return whs.prefill_cross_cache(impl.cfg, params, memory, cache)


def _teacher_forced(impl, params, seq, cache_dtype, frames=None):
    """Logits of one serve step per position of ``seq`` (B, T) through the
    cache, and prefill_fn's over all of ``seq``: (B, T, V) each, on the
    host."""
    serve, _specs = build_serve_step(impl, InputShape(
        "audit", seq.shape[1], seq.shape[0], "decode"),
        cache_dtype=cache_dtype)
    cache = _fresh_cache(impl, params, seq.shape[0], seq.shape[1],
                         cache_dtype, frames)
    steps = []
    for t in range(seq.shape[1]):
        logits, cache = serve(params, cache, seq[:, t:t + 1], t)
        steps.append(logits[:, 0].float().cpu())
    del cache
    batch = {"tokens": seq}
    if frames is not None:
        batch["frames"] = frames
    with torch.no_grad():
        full = impl.prefill_fn(params, batch).float().cpu()
    return torch.stack(steps, dim=1).numpy(), full.numpy()


def _row_gap(a, b) -> float:
    """max |a - b| over each row's max |b| (at least 1)."""
    return float((np.abs(a - b) / np.maximum(
        np.abs(b).max(-1, keepdims=True), 1.0)).max())


def run_mla_decode(args, device: str = "cuda") -> dict:
    """Greedy decode of deepseek-v3 at full width through build_serve_step
    with the latent cache (bf16), then the logits at every position of
    the same tokens held against prefill_fn's (teacher-forced), at fp32
    compute over the same bf16 weights."""
    cfg = _mla_config(args.mla_layers, MLA_CAPACITY)
    dev = torch.device(device)
    base = _allocated(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    params = init_params(gen, cfg, torch.bfloat16)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    impl = build(cfg, device=dev)
    max_seq = MLA_PROMPT + MLA_NEW
    serve, _specs = build_serve_step(impl, InputShape(
        "mla_decode", max_seq, MLA_BATCH, "decode"))
    prompts = torch.from_numpy(np.random.default_rng(args.seed + 7).integers(
        0, cfg.vocab, size=(MLA_BATCH, MLA_PROMPT), dtype=np.int64)).to(dev)
    print(f"resident MLA decode: {cfg.name} d_model {cfg.d_model} heads "
          f"{cfg.n_heads} MLA q/kv ranks {cfg.mla.q_lora_rank}/"
          f"{cfg.mla.kv_lora_rank}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k}, vocab {cfg.vocab}, depth {cfg.n_layers} of 61 "
          f"(--mla-layers) + MTP, {n_params} parameters "
          f"({2 * n_params / 1e9:.2f} GB bf16, drawn in {init_s:.1f} s); "
          f"batch {MLA_BATCH}, prompt {MLA_PROMPT}, {MLA_NEW} new tokens, "
          f"router capacity {MLA_CAPACITY:g}")
    with torch.no_grad():
        _sync(device)
        t1 = time.perf_counter()
        impl.prefill_fn(params, {"tokens": prompts})
        _sync(device)
        prefill_s = time.perf_counter() - t1
    cache = impl.init_cache(MLA_BATCH, max_seq)
    cache_bytes = sum(v.numel() * v.element_size() for c in cache
                      for v in c.values())
    per_token_layer = cache_bytes / (MLA_BATCH * max_seq * cfg.n_layers)
    steps = []
    for t in range(MLA_PROMPT):          # the prompt through the cache
        logits, cache = serve(params, cache, prompts[:, t:t + 1], t)
        steps.append(logits[:, 0])
    nxt = logits[:, 0].argmax(-1)
    new = [nxt]
    _sync(device)
    t2 = time.perf_counter()
    for i in range(MLA_NEW - 1):
        logits, cache = serve(params, cache, nxt[:, None], MLA_PROMPT + i)
        steps.append(logits[:, 0])
        nxt = logits[:, 0].argmax(-1)
        new.append(nxt)
    _sync(device)
    per_token_ms = 1e3 * (time.perf_counter() - t2) / (MLA_NEW - 1)
    _out, step_peak = _step_peak(
        lambda: serve(params, cache, nxt[:, None], max_seq - 1), device, base)
    del _out
    dec16 = torch.stack(steps, dim=1).float().cpu().numpy()
    del cache, steps
    seq = torch.cat([prompts, torch.stack(new[:-1], dim=1)], dim=1)
    with torch.no_grad():
        full16 = impl.prefill_fn(params, {"tokens": seq}).float().cpu() \
            .numpy()
    t3 = time.perf_counter()
    dec, full = _teacher_forced(
        build(cfg, compute_dtype=torch.float32, device=dev), params, seq,
        torch.float32)
    audit_s = time.perf_counter() - t3
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    del params

    excess = float((np.abs(dec - full) - (MLA_TOL + MLA_TOL
                                          * np.abs(full))).max())
    tokens = torch.stack(new, dim=1).cpu().numpy()
    out = {"mla_layers": cfg.n_layers, "params": n_params, "init_s": init_s,
           "prefill_s": prefill_s, "per_token_ms": per_token_ms,
           "step_peak_bytes": step_peak,
           "fp32_teacher_forced_gap": _row_gap(dec, full),
           "fp32_max_abs_diff": float(np.abs(dec - full).max()),
           "fp32_argmax_agreement": float(
               (dec.argmax(-1) == full.argmax(-1)).mean()),
           "bf16_teacher_forced_gap": _row_gap(dec16, full16),
           "bf16_argmax_agreement": float(
               (dec16.argmax(-1) == full16.argmax(-1)).mean()),
           "audit_s": audit_s,
           "cache_bytes_per_token_layer": per_token_layer,
           "max_memory_allocated": peak}
    for k, v in out.items():
        print(f"  {k}: {v}")
    print(f"  fp32 decode vs prefill_fn at {dec.shape[1]} positions "
          f"(capacity {MLA_CAPACITY:g}): max |diff| "
          f"{out['fp32_max_abs_diff']:.3e}, row-scaled gap "
          f"{out['fp32_teacher_forced_gap']:.3e} (tol rtol = atol = "
          f"{MLA_TOL:g}); bf16 row-scaled gap "
          f"{out['bf16_teacher_forced_gap']:.3e}, argmax agreement "
          f"{out['bf16_argmax_agreement']:.3f}")
    if tokens.shape != (MLA_BATCH, MLA_NEW) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab or not np.isfinite(dec16).all():
        raise AssertionError(f"bad MLA decode output {tokens.shape}")
    if per_token_layer != 2 * (cfg.mla.kv_lora_rank
                               + cfg.mla.qk_rope_head_dim):
        raise AssertionError(f"latent cache {per_token_layer} B a token a "
                             f"layer")
    if not excess <= 0:
        raise AssertionError(f"fp32 MLA decode logits differ from "
                             f"prefill_fn's past rtol = atol = {MLA_TOL}")
    return out


# -- phase 12: offloaded MLA uncached decode with expert paging ----------------

MLA_U_PROMPT, MLA_U_NEW = 32, 2
# host expert-page budget: one layer's 256 experts x 3 tensors (22.5 GB of
# bf16 pages), so neither arm refills a page within a pass
MLA_PAGE_SLOTS = 768


def _mem_total() -> int:
    return _kib_fields("/proc/meminfo", ("MemTotal",)).get("MemTotal", 0)


def _max_rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_mla_uncached(args, workdir: str) -> dict:
    """Uncached greedy decode of deepseek-v3 at full width through the
    SSD-offloaded session under expert_paging "all", then "routed", each
    arm on its own bf16 store (dropped after it)."""
    cfg = _mla_config(args.mla_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 8)
    # serving only: bf16 host units (26.7 GB, against 53.4 GB of fp32
    # masters, which with the 22.5 GB page cache took the process to 101
    # GB of an H100 host's 108 GB)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device="cuda",
                                expert_paging="routed", host_dtype="bfloat16")
    draw_s = time.perf_counter() - t0
    n_params = sum(v.size for u in model.units for v in u.params.values())
    prompts = np.random.default_rng(args.seed + 8).integers(
        0, cfg.vocab, size=(1, MLA_U_PROMPT), dtype=np.int64)
    capacity = -(-(2 * n_params) // 2) + (256 << 20)
    free = shutil.disk_usage(workdir).free
    print(f"offloaded MLA uncached decode: {cfg.name} depth {cfg.n_layers} "
          f"of 61, {n_params} parameters ({2 * n_params / 1e9:.2f} GB of "
          f"bf16 host units drawn in {draw_s:.1f} s, the same bytes in a "
          f"store an arm), batch 1, prompt {MLA_U_PROMPT}, {MLA_U_NEW} new "
          f"tokens, {MLA_PAGE_SLOTS} expert pages of host budget; MemTotal "
          f"{_mem_total()} B, free disk {free / 1e9:.1f} GB, max RSS so "
          f"far {_max_rss()} B")
    if free < 2 * n_params + (2 << 30):
        raise RuntimeError(f"not enough disk for the MLA store: {free} B")
    arms = {}
    for mode in ("all", "routed"):
        root = os.path.join(workdir, f"mla_serve_{mode}")
        policy = (OffloadPolicy.preset("memascend")
                  .with_expert_paging(mode, page_slots=MLA_PAGE_SLOTS)
                  .with_store(factory=lambda root=root: DirectNVMeEngine(
                      root, n_devices=2, device_capacity=capacity))
                  .build())
        t0 = time.perf_counter()
        with OffloadedDecoder(model, policy) as dec:
            setup_s = time.perf_counter() - t0
            s = dec.session
            o0 = s.overlap_snapshot()
            t1 = time.perf_counter()
            tokens = dec.generate(prompts, MLA_U_NEW, use_cache=False)
            torch.cuda.synchronize()
            generate_s = time.perf_counter() - t1
            o1 = s.overlap_snapshot()
            arms[mode] = {"setup_s": setup_s, "generate_s": generate_s,
                          "tokens": tokens, **_expert_counters(o0, o1),
                          "expert_fetch_wait_s":
                              o1["expert_fetch_wait_seconds"]
                              - o0["expert_fetch_wait_seconds"],
                          "peak_host_bytes": s.tracker.peak_allocated,
                          "max_rss_bytes": _max_rss(),
                          "expert_cache": s.expert_cache_stats()}
        shutil.rmtree(root, ignore_errors=True)
        print(f"  {mode}: " + str({k: v for k, v in arms[mode].items()
                                   if k != "tokens"}))
    del model
    toks = [arms[m].pop("tokens") for m in ("all", "routed")]
    ratio = arms["routed"]["expert_fetch_bytes"] / \
        arms["all"]["expert_fetch_bytes"]
    out = {"mla_layers": cfg.n_layers, "params": n_params, "draw_s": draw_s,
           "arms": arms, "routed_over_all_bytes": ratio,
           "tokens_equal": bool(np.array_equal(*toks)),
           "mem_total_bytes": _mem_total()}
    print(f"  tokens equal: {out['tokens_equal']}; expert bytes routed/all "
          f"{ratio:.4f}")
    if toks[0].shape != (1, MLA_U_NEW) or not (0 <= toks[0]).all() or \
            not (toks[0] < cfg.vocab).all():
        raise AssertionError(f"bad MLA tokens {toks[0].shape}")
    if not out["tokens_equal"]:
        raise AssertionError(f"routed MLA tokens {toks[1]} differ from "
                             f"all-resident {toks[0]}")
    if not 0 < ratio < 1:
        raise AssertionError(f"routed MLA decode moved {ratio} of the "
                             f"all-resident expert bytes")
    return out


# -- phases 13-15: the recurrent and encoder-decoder families ---------------

FAM_BATCH, FAM_SEQ, FAM_STEPS = 2, 512, 3
FAM_PROMPT, FAM_NEW = 64, 16
# the recurrent-state check's two prompt lengths: the state a layer must
# not grow from one to the other
STATE_PROMPTS = (32, 64)
FAM_ARCHS = {"jamba": "jamba-v0.1-52b", "xlstm": "xlstm-1.3b",
             "whisper": "whisper-tiny"}


def _family_config(name: str, args, capacity: float | None = None):
    cfg = get_config(FAM_ARCHS[name])
    if name != "whisper":
        cfg = dataclasses.replace(cfg, n_layers=getattr(args,
                                                        f"{name}_layers"))
    if capacity is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


def _sgd_steps(impl, params, batch, device: str, profile: bool,
               base: int | None = None) -> dict:
    """FAM_STEPS steps of build_train_step with the loss scaler, SGD (lr
    RESIDENT_LR) applied in place to the bf16 tree on each step the scaler
    admits.  (The launcher's ``resident_loop``, phase 10a, returns a new
    tree a step: at jamba's 26.6 GB that third copy beside the tree and
    its gradients does not fit on the card.)  Then the kernel is held to
    its plain version on every gradient leaf of one more step, run under
    the profiler if ``profile``, whose peak above ``base`` the dry run
    predicts."""
    step = build_train_step(impl)
    scaler = DynamicLossScaler(scale=1.0)
    leaves = tree_leaves(params)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, flags, walls = [], [], []
    _sync(device)
    overflow_flag_cuda_.launches = 0
    for _ in range(FAM_STEPS):
        t0 = time.perf_counter()
        scale = scaler.scale
        loss, grads, overflow = step(params, batch, scale)
        overflowed = bool(overflow)
        if scaler.update(overflowed):
            with torch.no_grad():
                for p, g in zip(leaves, tree_leaves(grads), strict=True):
                    p.sub_(g.to(p.dtype), alpha=RESIDENT_LR / scale)
        del grads
        losses.append(float(loss))
        _sync(device)
        walls.append(time.perf_counter() - t0)
        flags.append(overflowed)
    launches = overflow_flag_cuda_.launches
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else None
    # one more step (under the profiler: the device's busy time, the
    # kernels that take it), whose gradients then hold the kernel to its
    # plain version
    with _maybe_profile(on_card and profile) as prof:
        (_loss, grads, overflow), step_peak = _step_peak(
            lambda: step(params, batch, scaler.scale), device, base)
        _sync(device)
    busy_ms, events = _device_busy_ms(prof) if prof else (0.0, [])
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    g_leaves = tree_leaves(grads)
    if on_card:
        for g in g_leaves:
            _ov_agree(g.contiguous(), expect=False)
        g = g_leaves[-1].clone()
        g.view(-1)[-1] = float("inf")
        _ov_agree(g, expect=True)
    del grads, g_leaves
    out = {"losses": losses, "overflowed": flags, "step_s": walls,
           "gradient_leaves": len(leaves), "overflow_launches": launches,
           "max_memory_allocated": peak, "step_peak_bytes": step_peak,
           # against the last unprofiled step: the profiler's own cost
           # inflates the profiled one
           "step_device_busy_ms": busy_ms or None,
           "device_idle_share": (1.0 - busy_ms / (1e3 * walls[-1]))
           if busy_ms else None,
           "top_kernels_ms": [(e.key[:60], e.self_device_time_total / 1e3,
                               e.count) for e in top]}
    if any(flags) or bool(overflow):
        raise AssertionError(f"a clean step overflowed: {flags}")
    if not (np.isfinite(losses).all()
            and all(a > b for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"losses {losses} do not fall")
    if device == "cuda" and launches != len(leaves) * FAM_STEPS:
        raise AssertionError(f"overflow_check launched {launches} times "
                             f"for {len(leaves)} leaves x {FAM_STEPS} "
                             f"steps")
    return out


def _state_bytes(cfg, cache) -> dict:
    """Cache bytes a layer of each mixer kind (the recurrent ones hold a
    fixed-size state; attention's K/V grow with the cache's length)."""
    if cfg.family == "audio":
        return {"attn": sum(v.numel() * v.element_size()
                            for v in cache.values()) // cfg.n_layers}
    out: dict = {}
    for j, c in enumerate(cache):
        kind = mixer_kind(cfg, j)
        out.setdefault(kind, set()).add(
            sum(v[0].numel() * v[0].element_size() for v in c.values()))
    if any(len(v) != 1 for v in out.values()):
        raise AssertionError(f"uneven cache bytes a layer: {out}")
    return {k: v.pop() for k, v in out.items()}


def _greedy(impl, params, prompts, max_seq, device, frames=None,
            base: int | None = None):
    """The prompt through the serve step one token at a time, then
    FAM_NEW - 1 greedy steps.  Returns (logits (B, T, V) of every step on
    the host, new tokens, ms a greedy token, the cache after the
    prompt's state bytes, the device's busy ms a token, and the peak above
    ``base`` of one more serve step)."""
    serve, _specs = build_serve_step(impl, InputShape(
        "family_decode", max_seq, prompts.shape[0], "decode"))
    cache = _fresh_cache(impl, params, prompts.shape[0], max_seq,
                         torch.bfloat16, frames)
    steps = []
    for t in range(prompts.shape[1]):
        logits, cache = serve(params, cache, prompts[:, t:t + 1], t)
        steps.append(logits[:, 0])
    state = _state_bytes(impl.cfg, cache)
    nxt = logits[:, 0].argmax(-1)
    new = [nxt]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(FAM_NEW - 1):
        logits, cache = serve(params, cache, nxt[:, None],
                              prompts.shape[1] + i)
        steps.append(logits[:, 0])
        nxt = logits[:, 0].argmax(-1)
        new.append(nxt)
    _sync(device)
    per_token_ms = 1e3 * (time.perf_counter() - t0) / (FAM_NEW - 1)
    # four more steps under the profiler (not in the logits or the
    # tokens): the device's busy time a token
    on_card = torch.device(device).type == "cuda"
    with _maybe_profile(on_card) as prof:
        c = cache
        for i in range(4):
            _lg, c = serve(params, c, nxt[:, None], max_seq - 1)
        _sync(device)
    busy_ms = _device_busy_ms(prof)[0] / 4 if on_card else None
    del c, _lg
    _out, step_peak = _step_peak(
        lambda: serve(params, cache, nxt[:, None], max_seq - 1), device,
        base)
    del _out
    return (torch.stack(steps, dim=1).float().cpu().numpy(),
            torch.stack(new, dim=1), per_token_ms, state, busy_ms, step_peak)


def _time_mixer(fn, params, x, device, reps: int = 3) -> tuple:
    """(forward ms, forward + backward ms) of ``fn(params, x)`` at the
    training batch's shape, the median of ``reps``: what one layer's mixer
    costs a step is about their sum (the group's checkpointed forward,
    then its recompute and backward)."""
    fwd, both = [], []
    for _ in range(reps):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        xx = x.detach().requires_grad_()
        _sync(device)
        t0 = time.perf_counter()
        with torch.enable_grad():
            fn(p, xx)
        _sync(device)
        t1 = time.perf_counter()
        with torch.enable_grad():
            out = fn(p, xx)
            torch.autograd.grad(out, [xx] + list(p.values()),
                                grad_outputs=torch.ones_like(out))
        _sync(device)
        fwd.append(1e3 * (t1 - t0))
        both.append(1e3 * (time.perf_counter() - t1))
    return statistics.median(fwd), statistics.median(both)


def _mixer_timings(cfg, params, device, gen) -> dict:
    """Each recurrent mixer of the model (and Mamba's selective scan on its
    own) timed on the first group's weights at the training shape."""
    out = {}
    x = torch.randn((FAM_BATCH, FAM_SEQ, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    for j in range(len(params["groups"])):
        kind = mixer_kind(cfg, j)
        if kind in out or kind not in ("mamba", "mlstm", "slstm"):
            continue
        lp = {k: v[0] for k, v in params["groups"][j].items()
              if k.startswith(("ssm.", "mlstm.", "slstm."))}
        mixer = {"mamba": mamba_mod.mamba_mixer,
                 "mlstm": xlstm_mod.mlstm_mixer,
                 "slstm": xlstm_mod.slstm_mixer}[kind]
        out[kind] = _time_mixer(lambda p, xx, m=mixer: m(p, xx, cfg), lp, x,
                                device)
        if kind == "mamba":
            with torch.no_grad():
                xi = F.silu(mamba_mod.causal_conv1d(
                    dense(x, lp["ssm.w_in_x"]), lp["ssm.conv_w"])[0])
                dt, b_in, c_in = mamba_mod._ssm_params(lp, xi, cfg)

            def scan(p, xx, dt=dt, b_in=b_in, c_in=c_in):
                return mamba_mod.selective_scan(
                    xx, dt, b_in, c_in, p["ssm.a_log"], p["ssm.d_skip"],
                    chunk=cfg.ssm.chunk)[0]
            out["selective_scan"] = _time_mixer(
                scan, {k: lp[k] for k in ("ssm.a_log", "ssm.d_skip")}, xi,
                device)
    return out


def run_family(name: str, args, device: str = "cuda") -> dict:
    """One family at full width, cut in depth only: its bf16 tree drawn on
    the card from the seed, three resident SGD steps through
    build_train_step and the loss scaler, greedy decode through the serve
    step, and a teacher-forced audit at fp32 compute over the same bf16
    weights against prefill_fn."""
    cfg = _family_config(name, args)
    cfg16 = _family_config(name, args, MLA_CAPACITY)
    dev = torch.device(device)
    seed = args.seed + {"jamba": 13, "xlstm": 14, "whisper": 15}[name]
    base = _allocated(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    if cfg.family == "audio":
        params = whs.init_whisper_params(gen, cfg, torch.bfloat16)
    else:
        params = init_params(gen, cfg, torch.bfloat16)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    seq = cfg.max_decode_len if cfg.family == "audio" else FAM_SEQ
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(FAM_BATCH, seq), dtype=np.int64)).to(dev)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    frames = None
    if cfg.family == "audio":       # the stub frontend's frame embeddings
        frames = torch.randn((FAM_BATCH, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)
        batch["frames"] = frames
    print(f"{name}: {cfg.name} d_model {cfg.d_model} heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} vocab {cfg.vocab}, depth {cfg.n_layers} of "
          f"{get_config(FAM_ARCHS[name]).n_layers}, {n_params} parameters "
          f"({2 * n_params / 1e9:.2f} GB bf16, drawn in {init_s:.1f} s); "
          f"train batch {FAM_BATCH} x {seq}, {FAM_STEPS} SGD steps at lr "
          f"{RESIDENT_LR:g}")
    # no trace of xlstm's step: its sLSTM loops launch ~10^5 kernels a
    # step, and processing that trace took the phase from 54 s to 219 s
    # (NVIDIA H100 80GB HBM3, 700 W)
    train = _sgd_steps(build(cfg, device=dev), params, batch, device,
                       profile=name != "xlstm", base=base)
    for k, v in train.items():
        print(f"  {k}: {v}")
    mixers = {} if cfg.family == "audio" else \
        _mixer_timings(cfg, params, device, gen)
    for k, (f_ms, fb_ms) in mixers.items():
        print(f"  {k} at {FAM_BATCH} x {FAM_SEQ}: forward {f_ms:.2f} ms, "
              f"forward + backward {fb_ms:.2f} ms")

    impl16 = build(cfg16, device=dev)
    prompts = tokens[:, :FAM_PROMPT]
    enc = {}
    if frames is not None:
        _sync(device)
        t1 = time.perf_counter()
        with torch.no_grad():
            whs.encode(cfg, params, frames)
        _sync(device)
        enc["encode_s"] = time.perf_counter() - t1
    short = _greedy(impl16, params, prompts[:, :STATE_PROMPTS[0]],
                    STATE_PROMPTS[0] + FAM_NEW, device, frames)[3]
    dec16, new, per_token_ms, state, busy_ms, dec_peak = _greedy(
        impl16, params, prompts, FAM_PROMPT + FAM_NEW, device, frames, base)
    seq_tf = torch.cat([prompts, new[:, :-1]], dim=1)
    fb = {"tokens": seq_tf}
    if frames is not None:
        fb["frames"] = frames
    with torch.no_grad():
        full16 = impl16.prefill_fn(params, fb).float().cpu().numpy()
        # the first row alone: how far bf16 rounding alone (another GEMM
        # shape, no decode) moves the logits through this depth
        row16 = impl16.prefill_fn(params, {k: v[:1] for k, v in fb.items()})
        row16 = row16.float().cpu().numpy()
    t2 = time.perf_counter()
    dec, full = _teacher_forced(
        build(cfg16, compute_dtype=torch.float32, device=dev), params,
        seq_tf, torch.float32, frames)
    audit_s = time.perf_counter() - t2
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    del params
    excess = float((np.abs(dec - full) - (MLA_TOL + MLA_TOL
                                          * np.abs(full))).max())
    toks = new.cpu().numpy()
    out = {"layers": cfg.n_layers, "params": n_params, "init_s": init_s,
           "train": train, "mixer_ms": mixers, **enc,
           "per_token_ms": per_token_ms, "decode_step_peak_bytes": dec_peak,
           "decode_device_busy_ms_a_token": busy_ms,
           "decode_device_idle_share": (1.0 - busy_ms / per_token_ms)
           if busy_ms else None,
           "state_bytes_a_layer": {STATE_PROMPTS[0]: short,
                                   FAM_PROMPT: state},
           "fp32_max_abs_diff": float(np.abs(dec - full).max()),
           "fp32_teacher_forced_gap": _row_gap(dec, full),
           "fp32_argmax_agreement": float(
               (dec.argmax(-1) == full.argmax(-1)).mean()),
           "bf16_teacher_forced_gap": _row_gap(dec16, full16),
           "bf16_argmax_agreement": float(
               (dec16.argmax(-1) == full16.argmax(-1)).mean()),
           "bf16_prefill_row_vs_batch_gap": _row_gap(row16, full16[:1]),
           "audit_s": audit_s, "max_memory_allocated": peak}
    for k, v in out.items():
        if k not in ("train", "mixer_ms"):
            print(f"  {k}: {v}")
    print(f"  fp32 decode vs prefill_fn at {dec.shape[1]} positions: max "
          f"|diff| {out['fp32_max_abs_diff']:.3e}, row-scaled gap "
          f"{out['fp32_teacher_forced_gap']:.3e} (tol rtol = atol = "
          f"{MLA_TOL:g}); bf16 row-scaled gap "
          f"{out['bf16_teacher_forced_gap']:.3e}")
    if toks.shape != (FAM_BATCH, FAM_NEW) or toks.min() < 0 or \
            toks.max() >= cfg.vocab or not np.isfinite(dec16).all():
        raise AssertionError(f"bad {name} decode output {toks.shape}")
    for kind in ("mamba", "mlstm", "slstm"):
        if kind in state and short[kind] != state[kind]:
            raise AssertionError(f"{kind} state grew with the prompt: "
                                 f"{short[kind]} -> {state[kind]} B")
    if not excess <= 0:
        raise AssertionError(f"fp32 {name} decode logits differ from "
                             f"prefill_fn's past rtol = atol = {MLA_TOL}")
    return out


# -- phase 18: the paper's comparison ----------------------------------------

# arm -> (preset, overlap): the paper's two systems, its bf16-state mode
# and the overlap ablation (benchmarks/bench_e2e_throughput.py's five runs)
COMPARE_ARMS = {"memascend": ("memascend", "full"),
                "zero-infinity": ("zero-infinity", "full"),
                "memascend-bf16": ("memascend-bf16", "full"),
                "sync": ("memascend", "sync"),
                "h2d": ("memascend", "h2d")}
# the arms whose losses must be bit-equal at both steps: the same fp32
# Adam on the same gradients, whatever the allocator, pool, store, screen
# or thread that moves them
FP32_ARMS = ("memascend", "zero-infinity", "sync", "h2d")
COMPARE_LR = 1e-3       # the reference bench's Adam lr
# the zero-infinity screen's chained temporaries: abs(G) plus one bool mask
CHAINED_TMP_RATIO = 1.25
COMPARE_METRICS = ("fetch_wait_s", "ssd_wait_s", "optim_gate_s",
                   "optim_prefetch_wait_s", "overflow_screen_s")


def _kib_fields(path: str, names: tuple[str, ...]) -> dict:
    """``name -> bytes`` of the ``kB`` fields ``names`` of a /proc file."""
    out = {}
    with open(path) as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in names:
                out[key] = int(rest.split()[0]) * 1024
    return out


def _proc_status() -> dict:
    """This process's resident bytes: ``VmRSS`` (and ``VmHWM`` and the
    Rss split where the kernel reports them) from /proc/self/status."""
    return _kib_fields("/proc/self/status", ("VmHWM", "VmRSS", "RssAnon",
                                             "RssFile", "RssShmem"))


class _RssPeak:
    """The most ``VmRSS`` read while the block runs, sampled every 50 ms
    on a thread of its own: the card machine's /proc/self/status has no
    ``VmHWM``, and getrusage's ``ru_maxrss`` of a spawned child starts at
    its parent's resident size."""

    def __enter__(self) -> "_RssPeak":
        self.peak = _proc_status()["VmRSS"]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, _proc_status()["VmRSS"])

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _proc_status()["VmRSS"])


def _meminfo() -> dict:
    return _kib_fields("/proc/meminfo", ("Cached", "MemAvailable"))


def _cuda_child(device: str) -> None:
    """A comparison child starts here: the card, and the kernels the
    parent built (a child never compiles, and never falls back)."""
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("the comparison phase runs on the card: this "
                           "process sees no CUDA device")
    missing = [n for n in _build.sources() if not _build.built(n)]
    if missing:
        raise RuntimeError(f"no build of {missing} under "
                           f"{_build.BUILD_DIR}: the parent builds every "
                           f"kernel before it starts a comparison child")
    torch.zeros(1, device=device)
    torch.cuda.synchronize()


def compare_base(device: str = "cuda") -> dict:
    """The OS counters of a child that only initialises CUDA: the base
    every arm's counters are read above."""
    _cuda_child(device)
    return {**_proc_status(), **_meminfo()}


def _compare_policy(preset: str, overlap: str, root: str, n_params: int):
    """The preset at its defaults plus the bench's lr and ``overlap``, on
    its own store: zero-infinity's per-tensor files under ``root``, the
    others' raw store sized for master + m + v + compute weights."""
    builder = (OffloadPolicy.preset(preset).with_adam(lr=COMPARE_LR)
               .with_overlap(overlap))
    if preset == "zero-infinity":
        return builder.with_store(root).build()
    capacity = -(-(14 * n_params) // 2) + (512 << 20)
    return builder.with_store(factory=lambda: DirectNVMeEngine(
        os.path.join(root, "raw_store"), n_devices=2,
        device_capacity=capacity)).build()


def compare_prediction(model, preset: str) -> dict:
    """The tracker's bytes as the session's census and the allocators'
    rounding give them in accounting mode (no memory touched): the pinned
    pool arena and gradient flat buffer, the Adam staging arena, and under
    the chained screen its abs + mask temporaries; the peak is their sum,
    the activation checkpoints (freed before the barrier) left out."""
    policy = OffloadPolicy.preset(preset).with_store("unused").build()
    tracker = MemoryTracker()
    alloc = policy.allocator_cls(tracker=tracker, component="pinned")
    adam = policy.adam
    pool = policy.pool_cls(model.census(
        policy.inflight_blocks,
        bytes_per_elem=adam.compute_np_dtype.itemsize), alloc)
    sizes = [v.size for u in model.units for v in u.params.values()]
    flat = alloc.alloc(4 * sum(sizes))
    pinned = (tracker.live_requested, tracker.live_allocated)
    pool.close()
    flat.free()
    scratch = OffloadedAdam(None, adam, tracker=tracker) \
        ._scratch_bytes_per_elem()
    staging = 2 * (3 * max(sizes) * 4 + max(sizes) * scratch)
    tmp = 0 if policy.fused_overflow else int(CHAINED_TMP_RATIO * flat.size)
    return {"pinned_requested": pinned[0], "pinned_reserved": pinned[1],
            "adam_staging": staging, "overflow_tmp": tmp,
            "peak_allocated": pinned[1] + staging + tmp,
            "peak_requested": pinned[0] + staging + tmp}


def compare_arm(arm: str, layers: int, seed: int, root: str,
                device: str = "cuda") -> dict:
    """One arm, in a process of its own: qwen3-4b at full width and
    ``layers`` depth from the seed, the training phase's batch, two
    ``train_step``s (step 1 warms up; step 2 timed with ``synchronize``
    inside the window, so full overlap pays its Adam tail), the overflow
    kernel's launches counted over each step, the tracker's pinned
    allocations and the OS counters.  The store is deleted on the way
    out."""
    _cuda_child(device)
    preset, overlap = COMPARE_ARMS[arm]
    mem0, rss0 = _meminfo(), _proc_status()["VmRSS"]
    with _RssPeak() as rss:
        try:
            out = _compare_steps(arm, layers, seed, root, device)
            mem1 = _meminfo()
        finally:
            shutil.rmtree(root, ignore_errors=True)
    out.update(_proc_status())
    out["rss_start"], out["rss_peak"] = rss0, rss.peak
    out["cached_rise"] = mem1["Cached"] - mem0["Cached"]
    out["mem_available_fall"] = mem0["MemAvailable"] - mem1["MemAvailable"]
    return out


def _compare_steps(arm: str, layers: int, seed: int, root: str,
                   device: str) -> dict:
    preset, overlap = COMPARE_ARMS[arm]
    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    model = make_offloadable_lm(cfg, gen, torch.bfloat16, device=device)
    draw_s = time.perf_counter() - t0
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, size=(TRAIN_BATCH, TRAIN_SEQ), dtype=np.int64)
    labels = np.roll(tokens, -1, axis=1)
    n_params = sum(v.size for u in model.units for v in u.params.values())
    tracker = MemoryTracker(keep_timeline=True)
    t0 = time.perf_counter()
    with OffloadSession(model, _compare_policy(preset, overlap, root,
                                               n_params),
                        tracker=tracker) as s:
        init_s = time.perf_counter() - t0
        pinned = {"flat": torch.from_numpy(s.flat[:1024]).is_pinned(),
                  "pool": torch.from_numpy(s.pool.arena[:4096]).is_pinned()}
        steps, launches, walls, tails = [], [], [], []
        for _ in range(2):
            overflow_flag_cuda_.launches = 0
            t1 = time.perf_counter()
            steps.append(dict(s.train_step(tokens, labels)))
            launches.append(overflow_flag_cuda_.launches)
            t2 = time.perf_counter()
            s.synchronize()
            t3 = time.perf_counter()
            walls.append(t3 - t1)
            tails.append(t3 - t2)
        return {
            "arm": arm, "preset": preset, "overlap": overlap,
            "layers": layers, "params": n_params,
            "tensors": sum(len(u.params) for u in model.units),
            "allocator": type(s.allocator).__name__,
            "pool": type(s.pool).__name__, "store": type(s.store).__name__,
            "draw_s": draw_s, "init_s": init_s, "step_s": walls[1],
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / walls[1],
            "adam_tail_s": tails[1], "step1_s": walls[0],
            **{k: steps[1][k] for k in COMPARE_METRICS},
            # the step's whole Adam stage: complete after synchronize
            "optimizer_io_bytes": s.optimizer.last_io_bytes,
            "losses": [m["loss"] for m in steps],
            "losses_hex": [float(m["loss"]).hex() for m in steps],
            "applied": [m["applied"] for m in steps],
            "overflow_launches": launches,
            "flat_bytes": s.flat.nbytes, "pinned": pinned,
            "peak_allocated": tracker.peak_allocated,
            "peak_requested": tracker.peak_requested,
            "components": tracker.breakdown(),
            "predicted": compare_prediction(model, preset),
            "pinned_allocs": [(e.requested, e.allocated)
                              for e in tracker.timeline
                              if e.op == "alloc" and e.component == "pinned"],
            "store_io": s.store.stats.snapshot()}


def check_compare(arms: dict, device: str = "cuda") -> None:
    """The comparison's checks; each raises."""
    fp32 = {a: arms[a]["losses_hex"] for a in FP32_ARMS}
    if len({tuple(v) for v in fp32.values()}) != 1:
        raise AssertionError(f"fp32 arms' losses differ: {fp32}")
    mem, bf16, zi = (arms[a] for a in ("memascend", "memascend-bf16",
                                       "zero-infinity"))
    if bf16["losses_hex"][0] != mem["losses_hex"][0] or \
            not np.isfinite(bf16["losses"][1]):
        raise AssertionError(f"memascend-bf16 losses {bf16['losses']} vs "
                             f"memascend {mem['losses']}")
    for name, a in arms.items():
        want = 0 if a["preset"] == "zero-infinity" else a["tensors"]
        if a["overflow_launches"] != [want, want]:
            raise AssertionError(f"{name}: overflow kernel launched "
                                 f"{a['overflow_launches']} times a step, "
                                 f"not {want}")
        if not all(a["applied"]):
            raise AssertionError(f"{name}: a clean step was skipped")
        if device == "cuda" and not all(a["pinned"].values()):
            raise AssertionError(f"{name}: not page-locked: {a['pinned']}")
        allocs = a["pinned_allocs"]
        if not allocs:
            raise AssertionError(f"{name}: no pinned allocation recorded")
        tmp = a["components"].get("overflow_tmp", {}).get(
            "peak_allocated", 0)
        if a["allocator"] == "PowerOfTwoCachingAllocator":
            bad = [(r, c) for r, c in allocs if c != next_power_of_two(r)]
            if bad or tmp < CHAINED_TMP_RATIO * a["flat_bytes"]:
                raise AssertionError(f"{name}: pow2 allocations {bad}, "
                                     f"overflow_tmp peak {tmp} B")
        else:
            bad = [(r, c) for r, c in allocs if not 0 <= c - r < 4096]
            if bad or tmp != 0:
                raise AssertionError(f"{name}: 4 KiB allocations {bad}, "
                                     f"overflow_tmp peak {tmp} B")
        per = OffloadedAdam.io_bytes_per_param(
            OffloadPolicy.preset(a["preset"]).with_store("unused").build()
            .adam, include_grad_offload=False)
        if a["optimizer_io_bytes"] != per * a["params"]:
            raise AssertionError(f"{name}: optimizer_io_bytes "
                                 f"{a['optimizer_io_bytes']}, not {per} B "
                                 f"x {a['params']} parameters")
    if not zi["peak_allocated"] > mem["peak_allocated"]:
        raise AssertionError(f"zero-infinity's tracker peak "
                             f"{zi['peak_allocated']} B is not above "
                             f"memascend's {mem['peak_allocated']} B")


def run_compare_phase(args, workdir: str, card: str,
                      device: str = "cuda") -> dict:
    """Each arm in a spawned process of its own, one after another (its
    high-water mark and page-locked bytes its own, and torch's caching
    host allocator unable to carry one arm's blocks into the next), then
    the checks and one summary line.  Rows also go to
    ``chiprun_out/compare.json``."""
    ctx = multiprocessing.get_context("spawn")

    def child(fn, *a):
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=1, mp_context=ctx) as pool:
            return pool.submit(fn, *a).result()

    print(f"the paper's comparison: qwen3-4b at full width, depth "
          f"{args.compare_layers} of 36 (--compare-layers), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, two steps an arm, Adam lr "
          f"{COMPARE_LR:g}; arms {list(COMPARE_ARMS)}")
    base = child(compare_base, device)
    print(f"  base (a child that only initialises CUDA): {base}")
    arms = {}
    for arm in COMPARE_ARMS:
        t0 = time.perf_counter()
        a = child(compare_arm, arm, args.compare_layers, args.seed,
                  os.path.join(workdir, f"compare_{arm}"), device)
        a["os_above_base"] = a["rss_peak"] - base["VmRSS"]
        a["child_s"] = time.perf_counter() - t0
        arms[arm] = a
        print(json.dumps({k: v for k, v in a.items()
                          if k != "pinned_allocs"}, default=str))
    check_compare(arms, device)
    mem, zi = arms["memascend"], arms["zero-infinity"]
    summary = {
        "peak_reduction_tracker":
            1.0 - mem["peak_allocated"] / zi["peak_allocated"],
        "peak_reduction_os": 1.0 - mem["os_above_base"] / zi["os_above_base"],
        "peak_reduction_mem_available":
            1.0 - mem["mem_available_fall"] / zi["mem_available_fall"],
        "tokens_per_s_memascend_over_zero_infinity":
            mem["tokens_per_s"] / zi["tokens_per_s"],
        "tokens_per_s_full_over_sync":
            mem["tokens_per_s"] / arms["sync"]["tokens_per_s"],
        "bf16_step2_loss": arms["memascend-bf16"]["losses"][1],
        "fp32_step2_loss": mem["losses"][1], "card": card}
    print(f"  comparison: {json.dumps(summary)}")
    out = {"base": base, "arms": arms, "summary": summary}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare.json"), "w") as f:
        json.dump(out, f, indent=2, default=str)
    return out


# -- phase 16: the dry run against the card ---------------------------------

# the dry run's predicted peak of a training step (argument + temp + output
# bytes, repro_torch.launch.dryrun) against the step's measured peak: the
# counter follows every storage the step creates, the card's allocator
# adds 512-byte rounding and library workspaces, so a miss past 10 % is a
# fault of the counter
DRY_PEAK_RTOL = 0.10


def dry_run_specs(args) -> dict:
    """``name -> (config, InputShape, device_params_bf16)`` of each
    full-width resident run the script makes, as its phase builds it."""
    specs = {"qwen3-4b train": (
        dataclasses.replace(get_config("qwen3-4b"),
                            n_layers=args.train_layers),
        InputShape("resident_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        False)}
    for name in FAM_ARCHS:
        cfg = _family_config(name, args)
        seq = cfg.max_decode_len if cfg.family == "audio" else FAM_SEQ
        specs[f"{name} train"] = (
            cfg, InputShape("family_train", seq, FAM_BATCH, "train"), True)
        specs[f"{name} decode"] = (
            _family_config(name, args, MLA_CAPACITY),
            InputShape("family_decode", FAM_PROMPT + FAM_NEW, FAM_BATCH,
                       "decode"), True)
    specs["deepseek-v3 decode"] = (
        _mla_config(args.mla_layers, MLA_CAPACITY),
        InputShape("mla_decode", MLA_PROMPT + MLA_NEW, MLA_BATCH, "decode"),
        True)
    return specs


def side_records(specs: dict) -> tuple[dict, dict]:
    """What the side process computes: :func:`dry_run_records` and
    :func:`mesh_dry_run_records`."""
    return dry_run_records(specs), mesh_dry_run_records()


def dry_run_records(specs: dict) -> dict:
    """Each spec's dry run on the meta device.  It needs no card: the
    script runs it in a process of its own while the card's phases run."""
    out = {}
    for name, (cfg, shape, bf16) in specs.items():
        t0 = time.perf_counter()
        rec = lower_pair(cfg, shape, device_params_bf16=bf16)
        rec["wall_s"] = time.perf_counter() - t0
        out[name] = rec
    return out


def run_dry_vs_card(records: dict, measured: dict, card: str) -> dict:
    """One line a run: the dry run's flops, bytes and predicted peak, the
    roofline floor with the H100's constants, the measured step (or
    token) and its peak.  A training step's predicted peak must be within
    DRY_PEAK_RTOL of its measured one."""
    rows, misses = {}, []
    print(f"dry run vs the card ({card}; floor = max(flops / "
          f"{PEAK_FLOPS:.3g}, bytes / {HBM_BW:.3g}), the eager program's "
          f"op-by-op bytes):")
    for name, rec in records.items():
        step_ms, peak = measured[name]
        mem = rec["memory"]
        pred = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                + mem["output_size_in_bytes"])
        flops, nbytes = rec["cost"]["flops"], rec["cost"]["bytes accessed"]
        compute_ms = 1e3 * flops / PEAK_FLOPS
        memory_ms = 1e3 * nbytes / HBM_BW
        floor_ms = max(compute_ms, memory_ms)
        row = {"kind": rec["kind"], "layers": rec["n_layers"],
               "batch": rec["global_batch"], "seq": rec["seq_len"],
               "flops": flops, "bytes_accessed": nbytes,
               "transcendentals": rec["cost"]["transcendentals"],
               "argument_bytes": mem["argument_size_in_bytes"],
               "temp_bytes": mem["temp_size_in_bytes"],
               "output_bytes": mem["output_size_in_bytes"],
               "predicted_peak_bytes": pred, "measured_peak_bytes": peak,
               "peak_ratio": pred / peak if peak else None,
               "compute_ms": compute_ms, "memory_ms": memory_ms,
               "floor_ms": floor_ms,
               "bound_by": "operations" if compute_ms >= memory_ms
               else "bytes",
               "measured_ms": step_ms,
               "roofline_share": floor_ms / step_ms,
               "dry_run_s": rec["wall_s"]}
        rows[name] = row
        print(f"  {name} ({rec['n_layers']} layers, {rec['global_batch']} x "
              f"{rec['seq_len']}): {flops:.4e} flops, {nbytes:.4e} B; "
              f"predicted peak {pred} B (argument "
              f"{mem['argument_size_in_bytes']} + temp "
              f"{mem['temp_size_in_bytes']} + output "
              f"{mem['output_size_in_bytes']}) vs max_memory_allocated "
              f"{peak} B (ratio {row['peak_ratio']}); floor "
              f"{floor_ms:.4f} ms ({row['bound_by']}), measured "
              f"{step_ms:.4f} ms, roofline_share "
              f"{row['roofline_share']:.4f}")
        if rec["kind"] == "train" and peak is not None and \
                not abs(pred - peak) <= DRY_PEAK_RTOL * peak:
            misses.append(f"{name}: predicted {pred} B, measured {peak} B")
    if misses:
        raise AssertionError(f"dry-run peak off the card's by more than "
                             f"{DRY_PEAK_RTOL:.0%}: {misses}")
    return rows


def _device_busy_ms(prof) -> tuple[float, list]:
    """Device-side events only (kernels and copies): the host ops that
    launched them carry the same time again."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3, events


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2,
                    help="qwen3-4b depth (the full model has 36)")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--train-layers", type=int, default=3,
                    help="qwen3-4b depth of the training phase")
    ap.add_argument("--serve-layers", type=int, default=1,
                    help="qwen3-4b depth of the serving-breadth phases")
    ap.add_argument("--moe-train-layers", type=int, default=1,
                    help="qwen3-30b-a3b depth of the MoE training phase "
                         "(the full model has 48)")
    ap.add_argument("--moe-layers", type=int, default=1,
                    help="qwen3-30b-a3b depth of the MoE decode phase")
    ap.add_argument("--mla-layers", type=int, default=1,
                    help="deepseek-v3-671b depth of the MLA phases (the "
                         "full model has 61)")
    ap.add_argument("--jamba-layers", type=int, default=8,
                    help="jamba-v0.1-52b depth, a multiple of its 8-layer "
                         "interleave period (the full model has 32)")
    ap.add_argument("--xlstm-layers", type=int, default=16,
                    help="xlstm-1.3b depth, a multiple of 8 (the full "
                         "model has 48)")
    ap.add_argument("--compare-layers", type=int, default=1,
                    help="qwen3-4b depth of the paper's comparison (each "
                         "arm's store holds 14 B a parameter)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.new_tokens < 3 or min(args.layers, args.train_layers,
                                  args.serve_layers, args.moe_train_layers,
                                  args.moe_layers, args.mla_layers,
                                  args.compare_layers) < 1:
        ap.error("needs --new-tokens >= 3 and every --*layers >= 1")
    if min(args.jamba_layers, args.xlstm_layers) < 8 or \
            args.jamba_layers % 8 or args.xlstm_layers % 8:
        ap.error("--jamba-layers and --xlstm-layers take multiples of 8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # the dry runs need no card: a process of their own, beside the phases
    dry_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    dry_future = dry_pool.submit(side_records, dry_run_specs(args))
    card = card_line()
    print(card)
    print(f"host MemTotal {_mem_total()} B")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"total_memory "
          f"{torch.cuda.get_device_properties(0).total_memory} B")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 checks in fp32
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t
    print(f"build: {sorted(reports) or 'cached'} in {build_s:.2f} s "
          f"(one nvcc per source, all at once)")
    for name, report in reports.items():
        regs = [int(w) for line in report.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(int(line.split()[4]) for line in report.splitlines()
                     if "spill stores" in line)
        print(f"  {name}: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers a thread, {spills} bytes "
              f"of spill stores")

    attn_build = attention_build(_build.report("swa_attention"))
    print(f"  swa_attention tensor-core kernel, bf16 D128: {attn_build}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    print("kernel vs plain:")
    max_err = check_attention(gen)
    timing = time_attention(gen, BATCH, PROMPT)
    long_timing = time_attention(gen, 1, LONG_PROMPT)
    for (b, s), t_ in (((BATCH, PROMPT), timing), ((1, LONG_PROMPT),
                                                    long_timing)):
        print(f"  swa_attention at B{b} H32 KH8 S{s} D128 bf16 causal: "
              f"{t_['ms']:.4f} ms ({t_['tflops']:.0f} TFLOP/s), plain "
              f"{t_['plain_ms']:.4f} ms, sdpa {t_['library_ms']:.4f} ms, "
              f"bound {t_['bound_ms']:.4f} ms ({t_['bound_by']})")
    ov_err, _cases = check_overflow(gen)
    ov_timing = time_overflow(gen)
    print(f"  overflow_check at {_main_grad_elems()} fp32: "
          f"{ov_timing['ms']:.4f} ms, plain {ov_timing['plain_ms']:.4f} ms, "
          f"isfinite().all() {ov_timing['library_ms']:.4f} ms, bound "
          f"{ov_timing['bound_ms']:.4f} ms (bytes)")
    adam_err, _cases = check_fused_adam(gen)
    adam_timing = time_fused_adam(gen)
    print(f"  fused_adam at {_main_grad_elems()} fp32, bf16 w16: "
          f"{adam_timing['ms']:.4f} ms, plain {adam_timing['plain_ms']:.4f} "
          f"ms, torch._fused_adamw_ (no w16) "
          f"{adam_timing['library_ms']:.4f} ms, + w16.copy_(p) "
          f"{adam_timing['library_w16_ms']:.4f} ms, bound "
          f"{adam_timing['bound_ms']:.4f} ms (bytes)")
    torch.cuda.empty_cache()
    print(f"kernel phases: {time.perf_counter() - t_start:.1f} s")

    phase_s = {}
    t = time.perf_counter()
    adam_path = run_adam_path(gen)
    attn_path = run_attention_path(gen)
    torch.cuda.empty_cache()
    phase_s["entry_points"] = time.perf_counter() - t
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_store_") as workdir:
        t = time.perf_counter()
        main_path = run_main_path(args, workdir)
        phase_s["cached_decode"] = time.perf_counter() - t
        t = time.perf_counter()
        run_serve_paths(args, workdir)
        phase_s["serving_breadth"] = time.perf_counter() - t
    t = time.perf_counter()
    dry_records, mesh_records = dry_future.result()
    dry_pool.shutdown()
    phase_s["dry_run_wait"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_compare_") as workdir:
        t = time.perf_counter()
        compare = run_compare_phase(args, workdir, card)
        phase_s["comparison"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_train_") as workdir:
        t = time.perf_counter()
        train, host_run = run_train_path(args, workdir)
        phase_s["training"] = time.perf_counter() - t
        t = time.perf_counter()
        run_act_tiers(workdir, host_run)
        phase_s["activation_tiers"] = time.perf_counter() - t
        t = time.perf_counter()
        resident = run_resident_train(host_run)
        torch.cuda.empty_cache()
        phase_s["resident_training"] = time.perf_counter() - t
        t = time.perf_counter()
        mesh = run_mesh_phase(host_run)
        mesh["dry_runs"] = print_mesh_dry_runs(mesh_records)
        del host_run
        torch.cuda.empty_cache()
        phase_s["mesh"] = time.perf_counter() - t
        print(f"mesh phase: {phase_s['mesh']:.1f} s")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_moe_") as workdir:
        t = time.perf_counter()
        moe_train = run_moe_train(args, workdir)
        torch.cuda.empty_cache()
        phase_s["moe_training"] = time.perf_counter() - t
        t = time.perf_counter()
        run_moe_decode(args, workdir)
        phase_s["moe_decode"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_mla_") as workdir:
        t = time.perf_counter()
        mla = run_mla_decode(args)
        torch.cuda.empty_cache()
        phase_s["mla_resident_decode"] = time.perf_counter() - t
        t = time.perf_counter()
        run_mla_uncached(args, workdir)
        phase_s["mla_offloaded_uncached"] = time.perf_counter() - t
    families = {}
    for name in FAM_ARCHS:
        t = time.perf_counter()
        families[name] = run_family(name, args)
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t
    measured = {"qwen3-4b train": (1e3 * min(resident["step_s"]),
                                   resident["step_peak_bytes"]),
                "deepseek-v3 decode": (mla["per_token_ms"],
                                       mla["step_peak_bytes"])}
    for name, fam in families.items():
        measured[f"{name} train"] = (1e3 * min(fam["train"]["step_s"]),
                                     fam["train"]["step_peak_bytes"])
        measured[f"{name} decode"] = (fam["per_token_ms"],
                                      fam["decode_step_peak_bytes"])
    dry_vs_card = run_dry_vs_card(dry_records, measured, card)
    print(f"phase seconds: {phase_s}")

    kernels = [{
        "name": "swa_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa_attention.py:104",
        "launches": attn_path["launches"], "max_abs_err": max_err,
        **timing, "path_launches": attn_path["path_launches"],
        "model_path_launches": main_path["swa_launches"],
        "long_prompt": {"shape": f"B1 H32 KH8 S{LONG_PROMPT} D128 bf16 "
                                 f"causal", **long_timing},
        "build": attn_build, "build_s": build_s}, {
        "name": "overflow_check", "route": "cuda",
        "source": "src/repro_torch/csrc/overflow_check.cu",
        "replaces": "src/repro/kernels/overflow_check.py:71",
        "launches": train["overflow_launches"], "max_abs_err": ov_err,
        **ov_timing, "moe_launches": {
            m: a["overflow_launches"]
            for m, a in moe_train["arms"].items()},
        "resident_launches": resident["overflow_launches"],
        "mesh_launches_per_step": mesh["overflow_launches_per_step"],
        "compare_launches": {a: r["overflow_launches"]
                             for a, r in compare["arms"].items()},
        "family_launches": {n: f["train"]["overflow_launches"]
                            for n, f in families.items()}}, {
        "name": "fused_adam", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_adam.cu",
        "replaces": "src/repro/kernels/fused_adam.py:72",
        "launches": adam_path["launches"], "max_abs_err": adam_err,
        **adam_timing}]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dry_vs_card.json"),
              "w") as f:
        json.dump({"card": card, "total_memory":
                   torch.cuda.get_device_properties(0).total_memory,
                   "runs": dry_vs_card}, f, indent=2)
    with open(os.path.join(ROOT, "chiprun_out", "mesh_phase.json"),
              "w") as f:
        json.dump({"card": card, **mesh}, f, indent=2, default=str)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
