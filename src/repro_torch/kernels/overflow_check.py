"""Fused gradient-overflow screen: the Hopper kernel's wrappers and its plain
version.

Port of the Pallas TPU kernel ``overflow_check_pallas``
(``src/repro/kernels/overflow_check.py``); the CUDA source and its design
note are ``repro_torch/csrc/overflow_check.cu``.  The contract is the
reference's: True iff any element is Inf or NaN, decided by the
all-ones-exponent test (masks ``0x7F800000`` fp32, ``0x7F80`` bf16,
``0x7C00`` fp16); ``finfo.max`` and ``-0.0`` never trigger it; any other
dtype raises ``TypeError`` before a launch.

* :func:`overflow_flag_cuda_` ORs the verdict of a ``[lo, hi)`` element
  region of a contiguous CUDA tensor into a device int32 flag, with no
  sync; the training session screens each gradient tensor with it.  Its
  launches count in ``overflow_flag_cuda_.launches``.
* :func:`overflow_check_cuda` is the same on a fresh flag, read back (a
  sync).
* :func:`overflow_check_plain` is the torch version of the same test; the
  CPU tests and the card check use it, and
  :mod:`repro_torch.kernels.ops` routes CPU tensors to it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# dtype -> (element bytes, exponent mask, same-width integer dtype)
_SPEC = {torch.float32: (4, 0x7F80_0000, torch.int32),
         torch.bfloat16: (2, 0x7F80, torch.int16),
         torch.float16: (2, 0x7C00, torch.int16)}


def _spec(dtype):
    try:
        return _SPEC[dtype]
    except KeyError:
        raise TypeError(f"overflow check: unsupported dtype {dtype} (fp32, "
                        f"bf16 and fp16 only)") from None


def _region(x, lo: int, hi: int | None) -> tuple[int, int]:
    n = x.numel()
    hi = n if hi is None else int(hi)
    lo = int(lo)
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"region [{lo}, {hi}) outside a tensor of {n} "
                         f"elements")
    return lo, hi


def overflow_check_plain(x, lo: int = 0, hi: int | None = None):
    """0-dim bool tensor on ``x``'s device: any Inf/NaN in the ``[lo, hi)``
    element region of ``x`` (all of it by default)."""
    _nbytes, mask, itype = _spec(x.dtype)
    lo, hi = _region(x, lo, hi)
    bits = x.reshape(-1)[lo:hi].view(itype)
    return ((bits & mask) == mask).any()


def _fn():
    fn = _build.library("overflow_check").overflow_flag
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, p,
                       p]
    return fn


def overflow_flag_cuda_(x, flag, lo: int = 0, hi: int | None = None):
    """OR into ``flag`` (a one-element int32 CUDA tensor) whether the
    ``[lo, hi)`` element region of the contiguous CUDA tensor ``x`` holds
    an Inf or NaN.  Launches on the current stream, no sync; an empty
    region launches nothing.  Returns ``flag``."""
    nbytes, mask, _itype = _spec(x.dtype)
    if not (x.is_cuda and flag.is_cuda) or x.device != flag.device:
        raise ValueError(f"overflow_flag_cuda_ takes CUDA tensors on one "
                         f"device, got {x.device} and {flag.device}")
    if not x.is_contiguous():
        raise ValueError("overflow_flag_cuda_ needs a contiguous tensor")
    if flag.dtype != torch.int32 or flag.numel() != 1:
        raise ValueError(f"flag must be one int32 element, got "
                         f"{flag.dtype} of {flag.numel()}")
    lo, hi = _region(x, lo, hi)
    if hi == lo:
        return flag
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr() + lo * nbytes, hi - lo, nbytes, mask,
                    flag.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"overflow_check kernel launch failed with CUDA "
                           f"error {err}")
    overflow_flag_cuda_.launches += 1
    return flag


overflow_flag_cuda_.launches = 0


def overflow_check_cuda(x) -> bool:
    """True iff any element of the contiguous CUDA tensor ``x`` is Inf or
    NaN: one launch into a fresh flag, then a read back (a sync)."""
    _spec(x.dtype)
    flag = torch.zeros(1, dtype=torch.int32, device=x.device)
    return bool(overflow_flag_cuda_(x, flag).item())
