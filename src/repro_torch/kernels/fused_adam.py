"""Fused AdamW step: the Hopper kernel's wrapper and its plain version.

Port of the Pallas TPU kernel ``fused_adam_pallas``
(``src/repro/kernels/fused_adam.py``); the CUDA source and its design note
are ``repro_torch/csrc/fused_adam.cu``.  The contract is the reference's
``ops.fused_adam``: one AdamW step on fp32 ``p, g, m, v`` of any common
shape, returning ``(p_new, m_new, v_new, w16)`` with ``w16`` the new
weights cast to ``out_dtype`` (bf16, fp16 or fp32).  The step is a runtime
value; lr, the betas, eps and the weight decay are per-call constants.

The bias terms are computed once per call on the host
(:func:`adam_constants`), in fp32 as ``ref_fused_adam`` computes them
(``1 - beta**t``, not the Pallas kernel's ``1 - exp(t * ln beta)``), and
both versions take them from there:

* :func:`fused_adam_cuda` launches the kernel on contiguous CUDA tensors;
  its launches count in ``fused_adam_cuda.launches``.
* :func:`fused_adam_plain` is the same arithmetic in unfused torch ops, in
  ``ref_fused_adam``'s order; the CPU tests and the card check use it, and
  :mod:`repro_torch.kernels.ops` routes CPU tensors to it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclass(frozen=True)
class AdamConstants:
    """The per-call scalars of one step, each rounded to fp32 as the
    reference rounds them (python floats holding fp32 values)."""

    b1: float
    c1: float        # 1 - beta1
    b2: float
    c2: float        # 1 - beta2
    lr: float
    eps: float
    wd: float
    bias1: float     # 1 - beta1 ** step
    bias2: float     # 1 - beta2 ** step


def adam_constants(step, *, lr, beta1, beta2, eps,
                   weight_decay) -> AdamConstants:
    """fp32 constants of one step.  ``beta ** step`` is taken in float64
    from the fp32 beta and rounded once, then subtracted from 1 in fp32:
    that is the fp32 power ``ref_fused_adam`` computes, correctly
    rounded."""
    f32 = np.float32
    t = float(f32(int(step)))

    def bias(beta):
        return float(f32(1.0) - f32(float(f32(beta)) ** t))

    return AdamConstants(
        b1=float(f32(beta1)), c1=float(f32(1.0 - beta1)),
        b2=float(f32(beta2)), c2=float(f32(1.0 - beta2)),
        lr=float(f32(lr)), eps=float(f32(eps)),
        wd=float(f32(weight_decay)), bias1=bias(beta1), bias2=bias(beta2))


def _out_code(out_dtype) -> int:
    try:
        return _OUT_CODE[out_dtype]
    except KeyError:
        raise TypeError(f"fused_adam: out_dtype must be float32, bfloat16 "
                        f"or float16, got {out_dtype}") from None


def fused_adam_plain(p, g, m, v, step, *, lr=1e-4, beta1=0.9, beta2=0.999,
                     eps=1e-8, weight_decay=0.0, out_dtype=torch.bfloat16):
    """One AdamW step in torch ops, in ``ref_fused_adam``'s order.  The
    divisors are device tensors, not python scalars: PyTorch's CUDA
    division by a CPU scalar multiplies by its reciprocal instead."""
    _out_code(out_dtype)
    c = adam_constants(step, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                       weight_decay=weight_decay)
    p = p.float()
    g = g.float()
    m = c.b1 * m + c.c1 * g
    v = c.b2 * v + c.c2 * (g * g)
    bias1 = torch.tensor(c.bias1, dtype=torch.float32, device=p.device)
    bias2 = torch.tensor(c.bias2, dtype=torch.float32, device=p.device)
    update = (m / bias1) / (torch.sqrt(v / bias2) + c.eps)
    if weight_decay:
        update = update + c.wd * p
    p_new = p - c.lr * update
    return p_new, m, v, p_new.to(out_dtype)


def _fn():
    fn = _build.library("fused_adam").fused_adam
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        ptr, f = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [ptr] * 8 + [ctypes.c_longlong, ctypes.c_int] + \
            [f] * 9 + [ptr]
    return fn


def fused_adam_cuda(p, g, m, v, step, *, lr=1e-4, beta1=0.9, beta2=0.999,
                    eps=1e-8, weight_decay=0.0, out_dtype=torch.bfloat16):
    """One AdamW step by the kernel on contiguous fp32 CUDA tensors of one
    shape.  Launches on the current stream, no sync; an empty tensor
    launches nothing.  Returns fresh ``(p_new, m_new, v_new, w16)``."""
    code = _out_code(out_dtype)
    ins = (p, g, m, v)
    if not all(t.is_cuda and t.device == p.device for t in ins):
        raise ValueError(f"fused_adam_cuda takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"fused_adam_cuda takes fp32 p, g, m, v, got "
                        f"{[t.dtype for t in ins]}")
    if any(t.shape != p.shape for t in ins):
        raise ValueError(f"fused_adam_cuda: shapes differ: "
                         f"{[tuple(t.shape) for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("fused_adam_cuda needs contiguous tensors")
    c = adam_constants(step, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                       weight_decay=weight_decay)
    p_new, m_new, v_new = (torch.empty_like(p) for _ in range(3))
    w16 = torch.empty(p.shape, dtype=out_dtype, device=p.device)
    if p.numel() == 0:
        return p_new, m_new, v_new, w16
    with torch.cuda.device(p.device):
        err = _fn()(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    p_new.data_ptr(), m_new.data_ptr(), v_new.data_ptr(),
                    w16.data_ptr(), p.numel(), code, c.b1, c.c1, c.b2, c.c2,
                    c.lr, c.eps, c.wd, c.bias1, c.bias2,
                    torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed with CUDA error "
                           f"{err}")
    fused_adam_cuda.launches += 1
    return p_new, m_new, v_new, w16


fused_adam_cuda.launches = 0
