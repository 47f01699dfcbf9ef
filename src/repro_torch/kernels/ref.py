"""Plain torch oracles for every hand-written kernel (the allclose
references).

Port of ``src/repro/kernels/ref.py``: the same three functions, written
independently of the kernels' own plain versions (``*_plain`` in
:mod:`.overflow_check`, :mod:`.fused_adam`, :mod:`.swa_attention`), so a
test can hold a kernel and its plain version to a third statement of the
contract.
"""

from __future__ import annotations

import math

import torch


def ref_overflow_check(x) -> torch.Tensor:
    """0-dim bool tensor: any Inf/NaN in x."""
    x32 = x.float()
    return torch.isinf(x32).any() | torch.isnan(x32).any()


def ref_fused_adam(p, g, m, v, step, *, lr=1e-4, beta1=0.9, beta2=0.999,
                   eps=1e-8, weight_decay=0.0, out_dtype=torch.bfloat16):
    p = p.float()
    g = g.float()
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * torch.square(g)
    t = torch.as_tensor(step, dtype=torch.float32, device=p.device)
    bias1 = 1.0 - beta1 ** t
    bias2 = 1.0 - beta2 ** t
    update = (m / bias1) / (torch.sqrt(v / bias2) + eps)
    if weight_decay:
        update = update + weight_decay * p
    p_new = p - lr * update
    return p_new, m, v, p_new.to(out_dtype)


def ref_swa_attention(q, k, v, *, window: int = 0, causal: bool = True):
    """Materialized-score banded attention.  Shapes as the kernel:
    (B, H, S, D) x (B, KH, S, D) -> (B, H, S, D)."""
    _b, h, s, d = q.shape
    n_rep = h // k.shape[1]
    k = torch.repeat_interleave(k, n_rep, dim=1)
    v = torch.repeat_interleave(v, n_rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
