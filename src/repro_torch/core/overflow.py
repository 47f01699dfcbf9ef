"""Gradient-overflow checking on the host: the paper's §III-C / §IV-D.

Port of the numpy half of ``src/repro/core/overflow.py``.  Mixed-precision
training with dynamic loss scaling must test, every iteration, whether any
gradient became Inf/NaN.  The ZeRO-Infinity/PyTorch baseline does this with
a chain of whole-tensor ops on the fp32 gradient flat buffer::

    abs(G) -> isinf -> any   then   isnan(G) -> any

which materializes a full fp32 temporary (1.0x) plus boolean masks (0.25x
each): a peak of ~2.25x the flat buffer.  MemAscend's fused check uses
IEEE-754: a value is Inf or NaN **iff its exponent bits are all ones**, so
one bitwise pass over the raw words, with early exit, decides it::

    overflow = any((bits & EXP_MASK) == EXP_MASK)

* :func:`baseline_overflow_check` — the chained version (it charges its
  temporaries to a MemoryTracker; the ``zero-infinity`` preset measures
  that peak),
* :func:`fused_overflow_check` — the single-pass bitwise check, chunked so
  the working set stays cache-resident, early exit between chunks,
* :func:`flat_overflow_check` / :func:`check_region` — the policy
  dispatcher and the per-region screen of the gradient flat buffer.

Host bf16 is ``uint16`` bit patterns (:mod:`repro_torch.core.dtypes`), so a
``uint16`` array is screened as bf16.  On the card the session screens each
unit's device gradients with the Hopper kernel instead
(:mod:`repro_torch.kernels.overflow_check`); these host scans remain the
``zero-infinity`` barrier and the fallback for a region without a verdict.
"""

from __future__ import annotations

import numpy as np

from .dtypes import BF16_HOST, bf16_to_f32_
from .memory_tracker import MemoryTracker, GLOBAL_TRACKER

# IEEE-754 exponent masks per dtype (all-ones exponent <=> Inf or NaN).
_EXP_MASK = {
    np.dtype(np.float32): (np.uint32, np.uint32(0x7F80_0000)),
    np.dtype(np.float16): (np.uint16, np.uint16(0x7C00)),
}
# bfloat16: same exponent layout as fp32, packed in the top 16 bits.
_BF16_MASK = np.uint16(0x7F80)

#: chunk size (elements) for the fused pass — 4 MiB of fp32 stays in LLC,
#: mirroring the paper's OpenMP tile.
FUSED_CHUNK = 1 << 20


def _is_bf16(dtype: np.dtype) -> bool:
    # uint16 bits are the port's host bf16; a named bfloat16 dtype (an
    # ml_dtypes array handed in by a caller) has the same layout
    return dtype == BF16_HOST or dtype.name == "bfloat16"


def _masks_for(dtype: np.dtype):
    dtype = np.dtype(dtype)
    if dtype == np.dtype(np.float32) or dtype == np.dtype(np.float16):
        return _EXP_MASK[dtype]
    if _is_bf16(dtype):
        return (np.uint16, _BF16_MASK)
    raise TypeError(f"overflow check only defined for float types, got {dtype}")


def baseline_overflow_check(grad: np.ndarray, *,
                            tracker: MemoryTracker | None = None,
                            component: str = "overflow_tmp",
                            execute: bool = True) -> bool:
    """Chained isinf/isnan check, charging its temporaries.

    Timeline (matches the paper's Fig. 3):
      step 2: ``abs(G)``    -> full-size fp temporary          (+1.0x)
      step 3: ``isinf``     -> boolean mask                    (+0.25x for fp32)
      step 4: ``any``       -> scalar; abs temp still live
      step 5: ``isnan(G)``  -> boolean mask                    (+0.25x)
      step 6: ``any``       -> scalar
    Peak = payload * (1 + 1 + 0.25) = 2.25x for fp32.  bf16 bits are
    widened to fp32 first (exact), outside the charged timeline.
    """
    tracker = tracker or GLOBAL_TRACKER
    _masks_for(grad.dtype)                  # float types only
    nbytes = grad.nbytes
    bool_bytes = grad.size  # numpy/torch bool = 1 byte/elem
    if execute and _is_bf16(grad.dtype):
        grad = bf16_to_f32_(grad.view(np.uint16),
                            np.empty(grad.shape, np.float32))

    h_abs = tracker.alloc(component, nbytes, tag="abs_tmp")
    try:
        a = np.abs(grad) if execute else None
        h_inf = tracker.alloc(component, bool_bytes, tag="isinf_mask")
        try:
            inf_any = bool(np.isinf(a).any()) if execute else False
        finally:
            tracker.free(h_inf)
    finally:
        tracker.free(h_abs)
        a = None

    h_nan = tracker.alloc(component, bool_bytes, tag="isnan_mask")
    try:
        nan_any = bool(np.isnan(grad).any()) if execute else False
    finally:
        tracker.free(h_nan)
    return inf_any or nan_any


def flat_overflow_check(grad: np.ndarray, *, fused: bool,
                        tracker: MemoryTracker | None = None,
                        component: str = "overflow_tmp") -> bool:
    """Policy-dispatched flat-buffer screen — the ``OverflowCheckOp`` entry
    point.  ``grad`` may be the whole gradient flat buffer or any region of
    it: both checks are pure elementwise reductions, so the OR of
    per-region verdicts over **any partition** of the buffer equals the
    whole-buffer verdict (the invariant the per-unit screen relies on)."""
    check = fused_overflow_check if fused else baseline_overflow_check
    return check(grad, tracker=tracker, component=component)


def check_region(flat: np.ndarray, lo: int, hi: int, *, fused: bool,
                 tracker: MemoryTracker | None = None,
                 component: str = "overflow_tmp") -> bool:
    """Screen one ``[lo, hi)`` element region of the gradient flat buffer —
    the per-unit half of the fused check (§IV-D run incrementally) on the
    host.  The region slice is a view; no copy is made.  Each call counts
    in ``check_region.calls``."""
    check_region.calls += 1
    return flat_overflow_check(flat[lo:hi], fused=fused, tracker=tracker,
                               component=component)


check_region.calls = 0


def fused_overflow_check(grad: np.ndarray, *,
                         tracker: MemoryTracker | None = None,
                         component: str = "overflow_tmp",
                         chunk: int = FUSED_CHUNK) -> bool:
    """MemAscend's single-pass bitwise check (Algorithm 1), chunked.

    Peak extra memory is one chunk's boolean intermediate (<= 1 MiB),
    charged to the tracker for honest comparison; early-exits on the first
    overflowing chunk.
    """
    tracker = tracker or GLOBAL_TRACKER
    uint_t, mask = _masks_for(grad.dtype)
    flat = grad.reshape(-1).view(uint_t)
    n = flat.size
    chunk_bytes = min(chunk, n) * np.dtype(uint_t).itemsize
    handle = tracker.alloc(component, chunk_bytes, tag="fused_chunk")
    try:
        for start in range(0, n, chunk):
            piece = flat[start:start + chunk]
            # (bits & EXP_MASK) == EXP_MASK  <=> exponent all-ones <=> Inf/NaN
            if np.any((piece & mask) == mask):
                return True
        return False
    finally:
        tracker.free(handle)
