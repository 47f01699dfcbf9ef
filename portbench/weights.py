"""Weights and token streams drawn from ``--seed``: the one set of arrays
that both the port and the plain reference are given.

A configuration's parameters are laid out as :class:`Leaf` entries, each
naming the port's unit and parameter key (how the program takes a model)
and the reference's tensor (how :mod:`reference.qwen3` reads one).  The
whole model is drawn into one flat fp32 buffer on the device in one
truncated-normal call, each leaf then scaled to its own standard
deviation, so a redraw from the same seed gives the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

EMBED_STD = 0.02
SEED_MOD = 1 << 64


@dataclass(frozen=True)
class Leaf:
    unit: str           # the port's unit ("embed", "block_000", "head")
    key: str            # the port's parameter key within the unit
    shape: tuple
    std: float          # 0.0: drawn as zeros (norm weights)
    ref: str            # the reference's tensor
    expert: int | None  # index along the reference tensor's expert axis

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return f"{self.unit}/{self.key}"

    @property
    def is_expert(self) -> bool:
        return ".moe.w_" in self.ref and not self.ref.endswith("w_router")


def is_moe(cfg: dict) -> bool:
    return bool(cfg.get("num_experts"))


def layout(cfg: dict, expert_paging: str = "off") -> list[Leaf]:
    """Every parameter of ``cfg`` in the port's unit order.  With
    ``expert_paging`` other than "off" each expert's three matrices are
    leaves of their own (the port's expert pages); otherwise the experts
    are stacked along a leading axis."""
    if cfg["tie_word_embeddings"]:
        raise ValueError(f"{cfg['name']}: a tied table is not run here (the "
                         f"port trains it as two copies); state the untied "
                         f"variant and list tie_word_embeddings in reduced")
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    hd = cfg["head_dim"]
    q_dim = cfg["num_attention_heads"] * hd
    kv_dim = cfg["num_key_value_heads"] * hd
    out = [Leaf("embed", "embed", (v, d), EMBED_STD, "embed", None)]
    for i in range(cfg["num_hidden_layers"]):
        unit, pre = f"block_{i:03d}", f"layers.{i}."

        def add(key, shape, std="fan_in", ref=None, expert=None):
            if std == "fan_in":
                std = 1.0 / math.sqrt(shape[-2])
            out.append(Leaf(unit, key, tuple(shape), std,
                            pre + (ref or key), expert))

        add("norm_mixer", (d,), 0.0)
        add("attn.w_q", (d, q_dim))
        add("attn.w_k", (d, kv_dim))
        add("attn.w_v", (d, kv_dim))
        add("attn.w_o", (q_dim, d))
        add("attn.q_norm", (hd,), 0.0)
        add("attn.k_norm", (hd,), 0.0)
        add("norm_ffn", (d,), 0.0)
        if not is_moe(cfg):
            f = cfg["intermediate_size"]
            add("ffn.w_gate", (d, f))
            add("ffn.w_up", (d, f))
            add("ffn.w_down", (f, d))
            continue
        e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        add("moe.w_router", (d, e))
        shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
        if expert_paging == "off":
            for w, shape in shapes.items():
                add(f"moe.{w}", (e, *shape), 1.0 / math.sqrt(shape[0]))
            continue
        for x in range(e):
            for w, shape in shapes.items():
                add(f"moe.expert{x}.{w}", shape, ref=f"moe.{w}", expert=x)
    out.append(Leaf("head", "final_norm", (d,), 0.0, "final_norm", None))
    out.append(Leaf("head", "head", (d, v), 1.0 / math.sqrt(d), "head", None))
    return out


def n_params(leaves: list[Leaf]) -> int:
    return sum(leaf.size for leaf in leaves)


def offsets(leaves: list[Leaf]) -> list[tuple[Leaf, int]]:
    out, off = [], 0
    for leaf in leaves:
        out.append((leaf, off))
        off += leaf.size
    return out


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % SEED_MOD)


def draw(leaves: list[Leaf], seed: int, device) -> torch.Tensor:
    """The whole model as one flat fp32 tensor on ``device``: one
    truncated-normal draw (cut at 2 sigma) over every element, each leaf
    then scaled to its standard deviation or zeroed."""
    flat = torch.empty(n_params(leaves), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=generator(seed, device))
    for leaf, off in offsets(leaves):
        view = flat[off:off + leaf.size]
        if leaf.std:
            view.mul_(leaf.std)
        else:
            view.zero_()
    return flat


def checksum(flat: torch.Tensor) -> float:
    return float(flat.sum(dtype=torch.float64))


def host_units(leaves: list[Leaf], flat: torch.Tensor,
               dtype: str = "float32") -> dict[str, dict[str, np.ndarray]]:
    """``{unit: {key: array}}`` views of one host copy of ``flat``: fp32,
    or bf16 bits (uint16) rounded on the device for a served model."""
    if dtype == "bfloat16":
        host = flat.to(torch.bfloat16).view(torch.int16).cpu().numpy() \
            .view(np.uint16)
    elif dtype == "float32":
        host = flat.cpu().numpy()
    else:
        raise ValueError(f"host dtype {dtype!r}")
    units: dict[str, dict[str, np.ndarray]] = {}
    for leaf, off in offsets(leaves):
        units.setdefault(leaf.unit, {})[leaf.key] = \
            host[off:off + leaf.size].reshape(leaf.shape)
    return units


def reference_tree(leaves: list[Leaf], flat: torch.Tensor,
                   round_bf16: bool = False) -> dict[str, torch.Tensor]:
    """The reference's fp32 tensors over the same values: views of
    ``flat`` where a leaf is a whole tensor, expert pages stacked along
    their expert axis.  ``round_bf16`` first rounds every value to bf16
    (the weights of a served model)."""
    if round_bf16:
        flat = flat.to(torch.bfloat16).float()
    tree: dict[str, torch.Tensor] = {}
    pages: dict[str, dict[int, torch.Tensor]] = {}
    for leaf, off in offsets(leaves):
        view = flat[off:off + leaf.size].view(leaf.shape)
        if leaf.expert is None:
            tree[leaf.ref] = view
        else:
            pages.setdefault(leaf.ref, {})[leaf.expert] = view
    for ref, by_x in pages.items():
        tree[ref] = torch.stack([by_x[x] for x in range(len(by_x))])
    return tree


def leaf_of(tree: dict[str, torch.Tensor], leaf: Leaf) -> torch.Tensor:
    """The part of a reference tensor (a value, a gradient, a change)
    that is the port's ``leaf``."""
    t = tree[leaf.ref]
    return t if leaf.expert is None else t[leaf.expert]


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % SEED_MOD, *stream])


TRAIN_STREAM, PROMPT_STREAM = 1, 2


def train_batch(seed: int, step: int, batch: int, seq: int,
                vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """Step ``step``'s (tokens, labels), each (batch, seq) int64: one
    stream of ``seq + 1`` uniform ids a row, the labels shifted by one."""
    ids = rng(seed, TRAIN_STREAM, step).integers(
        0, vocab, size=(batch, seq + 1), dtype=np.int64)
    return np.ascontiguousarray(ids[:, :-1]), np.ascontiguousarray(ids[:, 1:])


def prompts(seed: int, index: int, batch: int, length: int,
            vocab: int) -> np.ndarray:
    """Batch ``index``'s (batch, length) int64 prompts, uniform ids."""
    return rng(seed, PROMPT_STREAM, index).integers(
        0, vocab, size=(batch, length), dtype=np.int64)
