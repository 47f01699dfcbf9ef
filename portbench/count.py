"""Frozen FLOP and byte arithmetic, from a configuration's widths.

The benchmark's own counts, kept apart from ``repro_torch.launch.roofline``
so that a change to the program cannot move the yardstick.

* model FLOPs of a training step: 6 x the matrix parameters a token
  passes through (every block's attention projections and MLP, or its
  router and its top-k experts; the head; not the embedding gather) x the
  tokens, plus causal attention's two products (4 x head_dim FLOPs a
  (query, key) pair a head forward, 3x that with the backward); recompute
  is not counted;
* the overflow screen's bytes: every gradient leaf read once in fp32,
  plus its 4-byte flag, one launch a leaf.

Peaks are NVIDIA's data sheet for one H100 SXM (dense bf16; HBM3).
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


def block_matmul_params(cfg: dict) -> int:
    """Matrix parameters one token passes through in one block."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    q_dim = cfg["num_attention_heads"] * hd
    kv_dim = cfg["num_key_value_heads"] * hd
    attn = d * q_dim + 2 * d * kv_dim + q_dim * d
    if cfg.get("num_experts"):
        ffn = d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d * \
            cfg["moe_intermediate_size"]
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn + ffn


def token_matmul_params(cfg: dict) -> int:
    """Matrix parameters one token passes through: the blocks and the
    head."""
    return cfg["num_hidden_layers"] * block_matmul_params(cfg) + \
        cfg["hidden_size"] * cfg["vocab_size"]


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def attention_flops(cfg: dict, batch: int, seq: int) -> int:
    """Forward FLOPs of causal attention's QK^T and PV products."""
    return 4 * cfg["head_dim"] * cfg["num_attention_heads"] * batch * \
        causal_pairs(seq) * cfg["num_hidden_layers"]


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step (forward and backward)."""
    return 6 * token_matmul_params(cfg) * batch * seq + \
        3 * attention_flops(cfg, batch, seq)


def overflow_screen_bytes(leaf_sizes: list[int]) -> int:
    """Bytes one training step's overflow screen must move: each fp32
    gradient leaf read once and its flag written once."""
    return sum(4 * n + 4 for n in leaf_sizes)
