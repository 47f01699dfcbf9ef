"""Banded flash attention: the Hopper kernels' wrapper and its plain version.

Port of the Pallas TPU kernel ``swa_attention_pallas``
(``src/repro/kernels/swa_attention.py``); the CUDA source and its design
note are ``repro_torch/csrc/swa_attention.cu``.

* :func:`swa_attention_cuda` launches a kernel on CUDA tensors, chosen by
  dtype (:func:`attention_path`): bf16 and fp16 take the tensor-core kernel
  (wgmma fed by TMA), fp32 the SIMT kernel (fp32 FMAs; wgmma would round
  fp32 to TF32).  It counts every launch in ``swa_attention_cuda.launches``
  and each path's in ``swa_attention_cuda.path_launches``.
* :func:`swa_attention_plain` is the torch port of the reference oracle
  ``ref_swa_attention`` (``src/repro/kernels/ref.py``): materialised scores,
  fp32 softmax, output in q's dtype.  The CPU tests and the card check use
  it; :func:`repro_torch.kernels.ops.swa_attention` routes CPU tensors to it.
* :func:`validate_operands`, :func:`attention_path` and :func:`tma_strides`
  are the wrapper's host-side rules; they run on tensors of any device.
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


def attention_path(dtype) -> str:
    """``"tensor_core"`` for bf16 and fp16, ``"simt"`` for fp32."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"swa_attention takes {list(_DTYPE_CODE)}, got "
                        f"{dtype}")
    return "simt" if dtype == torch.float32 else "tensor_core"


def validate_operands(q, k, v, window: int = 0) -> tuple[int, int, int, int,
                                                         int]:
    """Check dtypes, shapes, head_dim, window and unit last strides;
    returns ``(B, H, S, D, KH)``."""
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
    return b, h, s, d, kh


def tma_strides(t, name: str = "operand") -> tuple[int, int, int]:
    """(batch, head, seq) element strides of a (B, H, S, D) operand as the
    tensor-core kernel's TMA maps take them.  TMA needs a 16-byte aligned
    base and strides in multiples of 16 bytes; a dimension of size 1 is
    never stepped, so its stride is replaced by the contiguous one.  Raises
    on what TMA cannot take (no copy is made)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}'s data is not 16-byte aligned (address "
                         f"{t.data_ptr():#x}); the tensor-core kernel loads "
                         f"it with TMA")
    size = t.element_size()
    _b, h, s, d = t.shape
    dense = (h * s * d, s * d, d)
    out = []
    for dim, label, want in zip(range(3), ("batch", "head", "seq"), dense,
                                strict=True):
        st = want if t.shape[dim] == 1 else t.stride(dim)
        if (st * size) % 16:
            raise ValueError(f"{name}'s {label} stride {st} elements is not "
                             f"a multiple of 16 bytes; the tensor-core "
                             f"kernel loads it with TMA")
        out.append(st)
    return tuple(out)


_ENTRY = {"tensor_core": "swa_attention_fwd_tc",
          "simt": "swa_attention_fwd_simt"}


def _fn(path: str):
    fn = getattr(_build.library("swa_attention"), _ENTRY[path])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
    return fn


def swa_attention_cuda(q, k, v, *, window: int = 0, causal: bool = True):
    """Launch the Hopper kernel of q's dtype.  Shapes and semantics as
    :func:`swa_attention_plain`; any strides whose last dimension is 1
    (so a (B, S, H, D) layout passes as a transposed view, uncopied), and
    for bf16/fp16 the TMA rules of :func:`tma_strides`.  The output has
    q's memory layout."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("swa_attention_cuda takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    b, h, s, d, kh = validate_operands(q, k, v, window)
    path = attention_path(q.dtype)
    if path == "tensor_core":
        operand_strides = [tma_strides(t, name)
                           for name, t in (("q", q), ("k", k), ("v", v))]
    else:
        operand_strides = [t.stride()[:3] for t in (q, k, v)]
    out = torch.empty_like(q)
    if out.stride(3) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(
        st for t in (*operand_strides, out.stride()[:3]) for st in t))
    with torch.cuda.device(q.device):
        err = _fn(path)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), _DTYPE_CODE[q.dtype], b,
            h, s, d, h // kh, int(window), int(bool(causal)),
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        what = ("the driver refused a TMA tensor map" if err < 0
                else "CUDA error")
        raise RuntimeError(f"swa_attention {path} kernel launch failed: "
                           f"{what} {err}")
    swa_attention_cuda.launches += 1
    swa_attention_cuda.path_launches[path] += 1
    return out


swa_attention_cuda.launches = 0
swa_attention_cuda.path_launches = {"tensor_core": 0, "simt": 0}
