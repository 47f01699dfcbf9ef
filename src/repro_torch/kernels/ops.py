"""Dispatch for the port's kernels: the Hopper kernel on CUDA tensors, the
plain torch version on CPU tensors, and an error for anything else.

The counterpart of ``src/repro/kernels/ops.py``.  The choice follows the
tensors' device only: a CUDA tensor always reaches the kernel (a launch
failure raises; nothing falls back to the plain version).
"""

from __future__ import annotations

import torch

from .fused_adam import fused_adam_cuda, fused_adam_plain
from .overflow_check import (overflow_check_cuda, overflow_check_plain,
                             overflow_flag_cuda_)
from .swa_attention import swa_attention_cuda, swa_attention_plain


def _device_type(t, name: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return t.device.type


def swa_attention(q, k, v, *, window: int = 0, causal: bool = True):
    """Banded flash attention (B, H, S, D) x (B, KH, S, D) -> (B, H, S, D)."""
    if _device_type(q, "swa_attention") == "cuda":
        return swa_attention_cuda(q, k, v, window=window, causal=causal)
    return swa_attention_plain(q, k, v, window=window, causal=causal)


def overflow_check(x) -> bool:
    """True iff any element of ``x`` is Inf or NaN (fp32/bf16/fp16)."""
    if _device_type(x, "overflow_check") == "cuda":
        return overflow_check_cuda(x.contiguous())
    return bool(overflow_check_plain(x))


def overflow_flag_(x, flag, lo: int = 0, hi: int | None = None):
    """OR the Inf/NaN verdict of the ``[lo, hi)`` element region of the
    contiguous ``x`` into the one-element int32 ``flag`` (on ``x``'s
    device).  On CUDA this launches the kernel and does not sync."""
    if _device_type(x, "overflow_flag_") == "cuda":
        return overflow_flag_cuda_(x, flag, lo, hi)
    return flag.bitwise_or_(overflow_check_plain(x, lo, hi).to(flag.dtype))


def fused_adam(p, g, m, v, step, *, lr=1e-4, beta1=0.9, beta2=0.999,
               eps=1e-8, weight_decay=0.0, out_dtype=torch.bfloat16):
    """One fused AdamW step on fp32 ``p, g, m, v`` of any common shape;
    returns ``(p_new, m_new, v_new, w16)`` with ``w16`` the new weights in
    ``out_dtype``.  ``step`` is the 1-based step count of the bias
    correction, a runtime value."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, out_dtype=out_dtype)
    if _device_type(p, "fused_adam") == "cuda":
        return fused_adam_cuda(*(t.contiguous() for t in (p, g, m, v)),
                               step, **kw)
    return fused_adam_plain(p, g, m, v, step, **kw)
