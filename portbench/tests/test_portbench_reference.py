"""The plain reference agrees with the port where both compute in fp32:
``train_step``'s losses, first gradients and changes over three steps,
and cached decode's logits, at a tiny qwen3 and a tiny qwen3 MoE.  (The
benchmark's runs compare the port's bf16 path; here the reference's
equations are held to the port's to rounding.)"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch

from conftest import REPO, TINY_CONFIGS

sys.path[:0] = [str(REPO / "portbench"), str(REPO / "src")]

import compare  # noqa: E402
import port  # noqa: E402
import weights  # noqa: E402
from drivers import train  # noqa: E402
from reference import qwen3  # noqa: E402
from stores.host_arena import HostArenaStore  # noqa: E402

from repro_torch.core import (DecodeSpec, DirectNVMeEngine,  # noqa: E402
                              OffloadSession, OffloadUnit)
from repro_torch.core.model_adapter import from_numpy_units  # noqa: E402


def tiny(name: str) -> dict:
    base, changes = TINY_CONFIGS[name]
    cfg = json.loads((REPO / "portbench" / "configs" / f"{base}.json")
                     .read_text())
    cfg.update(changes, name=name)
    return cfg


def fp32_model(cfg, units):
    kinds = {"embed": "standalone", "head": "standalone"}
    return from_numpy_units(
        port.model_config(cfg),
        [OffloadUnit(n, kinds.get(n, "block"), p) for n, p in units.items()],
        torch.float32, device="cpu")


def fp32_policy(mix, factory):
    policy = port.policy(mix, factory)
    return policy.replace(adam=dataclasses.replace(policy.adam,
                                                   compute_dtype="float32"))


@pytest.mark.parametrize("name, paging", [("qwen3-tiny", "off"),
                                          ("qwen3-moe-tiny", "routed"),
                                          ("qwen3-moe-tiny", "off")])
def test_training_steps_agree_in_fp32(name, paging):
    cfg = tiny(name)
    mix = {"policy": "memascend", "overlap": "full", "lr": 1e-3,
           "weight_decay": 0.0, "setup_steps": 3, "expert_paging": paging,
           "expert_page_slots": 48 if paging != "off" else None}
    leaves = weights.layout(cfg, paging)
    flat = weights.draw(leaves, 5, "cpu")
    units = weights.host_units(leaves, flat)
    store = HostArenaStore(train.arena_bytes(leaves, 4, 4))
    ctx = types.SimpleNamespace(mix=mix, device=torch.device("cpu"),
                                spans=lambda _: contextlib.nullcontext(),
                                log=lambda _: None)

    def batch(i):
        return weights.train_batch(5, i, 2, 32, cfg["vocab_size"])

    with OffloadSession(fp32_model(cfg, units),
                        fp32_policy(mix, lambda: store)) as s:
        prog = train.setup_steps(ctx, s, store, leaves, units, batch)
    ref = train.reference(cfg, mix, 5, torch.device("cpu"), leaves,
                          weights.checksum(flat), [batch(i) for i in (1, 2, 3)])
    numbers = compare.train_numbers(prog, ref)
    assert numbers["loss_gap"] < 1e-6, numbers
    assert numbers["grad_norm_gap"] < 1e-5, numbers
    assert numbers["change_norm_gap"] < 1e-3, numbers


def test_cached_decode_logits_agree_in_fp32(tmp_path):
    cfg = tiny("qwen3-tiny")
    leaves = weights.layout(cfg)
    flat = weights.draw(leaves, 9, "cpu")
    units = weights.host_units(leaves, flat)
    mix = {"policy": "memascend", "overlap": "full"}
    policy = fp32_policy(mix, lambda: DirectNVMeEngine(str(tmp_path)))
    prompts = weights.prompts(9, 1, 4, 32, cfg["vocab_size"])
    with OffloadSession(fp32_model(cfg, units), policy, mode="serve",
                        decode=DecodeSpec(batch=4, max_seq=64,
                                          bucket=16)) as s:
        kv = s.open_kv_cache()
        logits = [s.prefill(kv, prompts)]
        tokens = [logits[-1].argmax(-1)]
        for _ in range(3):
            logits.append(s.decode_step(kv, tokens[-1][:, None]))
            tokens.append(logits[-1].argmax(-1))
        kv.close()
    got, tokens = np.stack(logits, 1), np.stack(tokens, 1)
    seq = torch.from_numpy(np.concatenate([prompts, tokens[:, :-1]], 1))
    with torch.no_grad():
        want = qwen3.Model(cfg).logits(weights.reference_tree(leaves, flat),
                                       seq)[:, 31:35].numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_fp8_control_rounds_every_product():
    cfg = tiny("qwen3-tiny")
    leaves = weights.layout(cfg)
    tree = weights.reference_tree(leaves, weights.draw(leaves, 3, "cpu"))
    tokens = torch.from_numpy(weights.prompts(3, 0, 2, 16,
                                              cfg["vocab_size"]))
    with torch.no_grad():
        exact = qwen3.Model(cfg).logits(tree, tokens)
        low = qwen3.Model(cfg, fp8=True).logits(tree, tokens)
    rel = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < rel < 0.5
