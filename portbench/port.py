"""How the benchmark hands its configuration, weights and traffic mix to
the system under test: ``repro_torch``, the PyTorch and CUDA port."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import (MemoryTracker, OffloadPolicy, OffloadSession,
                              OffloadUnit)
from repro_torch.core.model_adapter import from_numpy_units

import weights

GIB = 1 << 30


def model_config(cfg: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file."""
    moe = None
    if weights.is_moe(cfg):
        if not cfg["norm_topk_prob"] or cfg["decoder_sparse_step"] != 1 \
                or cfg["mlp_only_layers"]:
            raise ValueError(f"{cfg['name']}: the port runs every layer as "
                             f"a top-k expert layer with renormalised "
                             f"probabilities")
        moe = MoEConfig(n_experts=cfg["num_experts"],
                        top_k=cfg["num_experts_per_tok"],
                        d_ff_expert=cfg["moe_intermediate_size"],
                        capacity_factor=cfg["moe_capacity_factor"])
    return ModelConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["head_dim"], qk_norm=True, gated_act="swiglu",
        rope_theta=cfg["rope_theta"], rms_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], moe=moe,
        source=cfg["source"])


def offloadable(cfg: dict, units: dict, device):
    """The port's offloadable model over the benchmark's host arrays."""
    kinds = {"embed": "standalone", "head": "standalone"}
    return from_numpy_units(
        model_config(cfg),
        [OffloadUnit(name, kinds.get(name, "block"), params)
         for name, params in units.items()],
        torch.bfloat16, device=device)


def policy(mix: dict, store_factory) -> OffloadPolicy:
    """The mix's preset as shipped, with the mix's overlap, expert paging
    and Adam settings, over ``store_factory``."""
    preset = OffloadPolicy.preset(mix["policy"]).with_overlap(mix["overlap"])
    if "lr" in mix:
        preset = preset.with_adam(lr=mix["lr"],
                                  weight_decay=mix["weight_decay"])
    if mix.get("expert_paging", "off") != "off":
        preset = preset.with_expert_paging(
            mix["expert_paging"], page_slots=mix["expert_page_slots"])
    return preset.with_store(factory=store_factory).build()


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


__all__ = ["GIB", "MemoryTracker", "OffloadSession", "device_info",
           "model_config", "offloadable", "policy"]
