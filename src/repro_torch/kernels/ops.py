"""Dispatch for the port's kernels: the Hopper kernel on CUDA tensors, the
plain torch version on CPU tensors, and an error for anything else.

The counterpart of ``src/repro/kernels/ops.py``.  The choice follows the
tensors' device only: a CUDA tensor always reaches the kernel (a launch
failure raises; nothing falls back to the plain version).
"""

from __future__ import annotations

from .swa_attention import swa_attention_cuda, swa_attention_plain


def swa_attention(q, k, v, *, window: int = 0, causal: bool = True):
    """Banded flash attention (B, H, S, D) x (B, KH, S, D) -> (B, H, S, D)."""
    if q.device.type == "cuda":
        return swa_attention_cuda(q, k, v, window=window, causal=causal)
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, window=window, causal=causal)
    raise ValueError(f"swa_attention runs on cuda or cpu tensors, got "
                     f"{q.device}")
