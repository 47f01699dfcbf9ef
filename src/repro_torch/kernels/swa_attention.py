"""Banded flash attention: the Hopper kernel's wrapper and its plain version.

Port of the Pallas TPU kernel ``swa_attention_pallas``
(``src/repro/kernels/swa_attention.py``); the CUDA source and its design
note are ``repro_torch/csrc/swa_attention.cu``.

* :func:`swa_attention_cuda` launches the kernel on CUDA tensors and counts
  its launches in ``swa_attention_cuda.launches``.
* :func:`swa_attention_plain` is the torch port of the reference oracle
  ``ref_swa_attention`` (``src/repro/kernels/ref.py``): materialised scores,
  fp32 softmax, output in q's dtype.  The CPU tests and the card check use
  it; :func:`repro_torch.kernels.ops.swa_attention` routes CPU tensors to it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)


def swa_attention_plain(q, k, v, *, window: int = 0, causal: bool = True):
    """Materialised-score banded attention.  q: (B, H, S, D); k, v:
    (B, KH, S, D), KH | H.  Returns (B, H, S, D) in q's dtype."""
    b, h, s, d = q.shape
    n_rep = h // k.shape[1]
    k = k.repeat_interleave(n_rep, dim=1)
    v = v.repeat_interleave(n_rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    if window:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                   device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _fn():
    fn = _build.library("swa_attention").swa_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
    return fn


def swa_attention_cuda(q, k, v, *, window: int = 0, causal: bool = True):
    """Launch the Hopper kernel.  Shapes and semantics as
    :func:`swa_attention_plain`; any strides whose last dimension is 1
    (so a (B, S, H, D) layout passes as a transposed view, uncopied).  The
    output has q's memory layout."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("swa_attention_cuda takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPE_CODE)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B,H,S,D) and k, v (B,KH,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % kh:
        raise ValueError(f"GQA requires KH | H, got H={h}, KH={kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride in its last "
                             f"dimension, got strides {t.stride()}")
    out = torch.empty_like(q)
    if out.stride(3) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(
        st for t in (q, k, v, out) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
                    _DTYPE_CODE[q.dtype], b, h, s, d, h // kh, int(window),
                    int(bool(causal)), 1.0 / math.sqrt(d),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swa_attention kernel launch failed with CUDA "
                           f"error {err}")
    swa_attention_cuda.launches += 1
    return out


swa_attention_cuda.launches = 0
