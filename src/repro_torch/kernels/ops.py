"""Dispatch for the port's kernels: the Hopper kernel on CUDA tensors, the
plain torch version on CPU tensors, the dry run's charge on meta tensors,
and an error for anything else.

The counterpart of ``src/repro/kernels/ops.py``.  The choice follows the
tensors' device only: a CUDA tensor always reaches the kernel (a launch
failure raises; nothing falls back to the plain version).

On the meta device (:mod:`repro_torch.launch.dryrun`) a dispatcher runs no
arithmetic: it charges the *kernel's own* work to the active dry run — the
bytes it moves and the operations it does, the formulas ``chip_smoke.py``
bounds each kernel with — and returns its outputs as meta tensors.
Outside a dry run, meta tensors raise.
"""

from __future__ import annotations

import contextlib

import torch

from .fused_adam import fused_adam_cuda, fused_adam_plain
from .overflow_check import (overflow_check_cuda, overflow_check_plain,
                             overflow_flag_cuda_)
from .swa_attention import swa_attention_cuda, swa_attention_plain


# the active dry run's counter: ``kernel(name, flops=, transcendentals=,
# nbytes=)`` charges one launch and returns a context inside which the
# ops that make the outputs are not counted (set by ``dry_run_counter``)
_dry_run = None


@contextlib.contextmanager
def dry_run_counter(counter):
    """Route the meta branches' charges to ``counter`` for the block."""
    global _dry_run
    prev, _dry_run = _dry_run, counter
    try:
        yield counter
    finally:
        _dry_run = prev


def _device_type(t, name: str) -> str:
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name} runs on cuda, cpu or meta tensors, got "
                         f"{t.device}")
    return t.device.type


def _charge(name: str, *, flops: int, transcendentals: int, nbytes: int):
    if _dry_run is None:
        raise RuntimeError(f"{name} got meta tensors outside a dry run "
                           f"(repro_torch.launch.dryrun): nothing runs on "
                           f"the meta device")
    return _dry_run.kernel(name, flops=flops,
                           transcendentals=transcendentals, nbytes=nbytes)


def live_pairs(s: int, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs the banded attention computes at length ``s``:
    a query ``i`` sees keys ``(i - window, i]`` (causal) or ``(i - window,
    s)`` (not), all of them or all up to ``i`` when ``window`` is 0."""
    w = window if 0 < window < s else 0
    if causal:
        return w * (w + 1) // 2 + (s - w) * w if w else s * (s + 1) // 2
    return s * s - (s - w) * (s - w + 1) // 2 if w else s * s


def swa_attention(q, k, v, *, window: int = 0, causal: bool = True):
    """Banded flash attention (B, H, S, D) x (B, KH, S, D) -> (B, H, S, D)."""
    dev = _device_type(q, "swa_attention")
    if dev == "meta":
        b, h, s, d = q.shape
        kh = k.shape[1]
        pairs = live_pairs(s, window, causal) * b * h
        # q, o, k, v once each; QK^T and PV, one exp a live pair
        with _charge("swa_attention", flops=4 * d * pairs,
                     transcendentals=pairs,
                     nbytes=q.element_size() * (2 * b * h * s * d
                                                + 2 * b * kh * s * d)):
            return torch.empty_like(q)
    if dev == "cuda":
        return swa_attention_cuda(q, k, v, window=window, causal=causal)
    return swa_attention_plain(q, k, v, window=window, causal=causal)


def overflow_check(x) -> bool:
    """True iff any element of ``x`` is Inf or NaN (fp32/bf16/fp16).  A
    host bool: meta tensors, which hold no values, raise (a dry run screens
    through :func:`overflow_flag_`)."""
    if _device_type(x, "overflow_check") == "meta":
        raise ValueError("overflow_check reads its verdict back to the "
                         "host; a meta tensor has none")
    if x.device.type == "cuda":
        return overflow_check_cuda(x.contiguous())
    return bool(overflow_check_plain(x))


def overflow_flag_(x, flag, lo: int = 0, hi: int | None = None):
    """OR the Inf/NaN verdict of the ``[lo, hi)`` element region of the
    contiguous ``x`` into the one-element int32 ``flag`` (on ``x``'s
    device).  On CUDA this launches the kernel and does not sync."""
    dev = _device_type(x, "overflow_flag_")
    if dev == "meta":
        n = (x.numel() if hi is None else hi) - lo
        # one read of the region and the flag's 4 bytes; one exponent test
        # an element
        with _charge("overflow_check", flops=n, transcendentals=0,
                     nbytes=n * x.element_size() + 4):
            return flag
    if dev == "cuda":
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
    dev = _device_type(p, "fused_adam")
    if dev == "meta":
        n = p.numel()
        w16_bytes = torch.finfo(out_dtype).bits // 8
        # p, g, m, v read once (16 B), p, m, v and w16 written once (12 B
        # and w16's); the two moment updates, the bias-corrected step, the
        # decay and the cast: 16 operations and one sqrt an element
        with _charge("fused_adam", flops=16 * n, transcendentals=n,
                     nbytes=(28 + w16_bytes) * n):
            return (torch.empty_like(p), torch.empty_like(m),
                    torch.empty_like(v),
                    torch.empty_like(p, dtype=out_dtype))
    if dev == "cuda":
        return fused_adam_cuda(*(t.contiguous() for t in (p, g, m, v)),
                               step, **kw)
    return fused_adam_plain(p, g, m, v, step, **kw)
