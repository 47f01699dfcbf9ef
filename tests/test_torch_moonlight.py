"""Moonlight-16B-A3B's block in the port (which the JAX package has not)
held to the plain reference of ``portbench/reference/deepseek_v3.py``
at a tiny size on the CPU: the sigmoid gate with its selection bias, MLA
with no query latent, and a model of one leading dense layer and two MoE
layers (two shared experts each) trained through
``OffloadSession.train_step`` with routed expert paging over fewer page
slots than pages.  Also: routed paging equals all-resident bit for bit,
and the session's routed / dropped pair counters equal the reference's
routing."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "portbench")]

import compare  # noqa: E402
import layout_deepseek_v3 as layout  # noqa: E402
import port  # noqa: E402
import weights  # noqa: E402
from drivers import train_deepseek_v3 as driver  # noqa: E402
from drivers.train import arena_bytes, setup_steps  # noqa: E402
from reference import deepseek_v3  # noqa: E402
from stores.host_arena import HostArenaStore  # noqa: E402

from repro_torch.configs import PORT_MODELS, get_config  # noqa: E402
from repro_torch.core import OffloadSession, OffloadUnit  # noqa: E402
from repro_torch.core.model_adapter import from_numpy_units  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import mla_attention  # noqa: E402
from repro_torch.models.moe import route_top_k, router_logits  # noqa: E402

torch.set_num_threads(2)

TINY = dict(name="moonlight-tiny", hidden_size=64, intermediate_size=96,
            moe_intermediate_size=24, n_routed_experts=16,
            num_experts_per_tok=4, num_attention_heads=4,
            num_key_value_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, kv_lora_rank=32, vocab_size=512,
            num_hidden_layers=3)
SEQ = 32


def tiny(**changes) -> dict:
    cfg = json.loads((REPO / "portbench" / "configs" /
                      "moonlight-16b-a3b.json").read_text())
    cfg.update(TINY, **changes)
    return cfg


def tree_of(cfg, seed, paging="off"):
    leaves = layout.layout(cfg, paging)
    flat = weights.draw(leaves, seed, "cpu")
    return leaves, flat, weights.reference_tree(leaves, flat)


def test_the_config_is_the_port_s_own():
    cfg = get_config("moonlight-16b-a3b")
    assert cfg is PORT_MODELS["moonlight-16b-a3b"]
    assert (cfg.moe.scoring, cfg.moe.routed_scale, cfg.mla.q_lora_rank,
            cfg.first_dense_layers) == ("sigmoid", 2.446, None, 1)
    from repro_torch.configs import ALL_MODELS
    assert cfg.name not in ALL_MODELS


def test_the_sigmoid_gate_picks_as_the_reference():
    cfg = tiny()
    pcfg = layout.model_config(cfg)
    _, _, tree = tree_of(cfg, 3)
    pre = "layers.1."
    xf = torch.randn(256, cfg["hidden_size"],
                     generator=torch.Generator().manual_seed(4))
    params = {"moe.w_router": tree[pre + "moe.w_router"],
              "moe.router_bias": tree[pre + "moe.router_bias"]}
    w, idx, aux = route_top_k(router_logits(xf, params, pcfg), params, pcfg)
    with deepseek_v3.exact_fp32():
        want_i, want_w = deepseek_v3.Model(cfg).gate(tree, pre, xf)
    assert torch.equal(idx, want_i)
    torch.testing.assert_close(w, want_w, rtol=1e-6, atol=0)
    assert float(aux) == 0.0
    # the weights: unbiased scores renormalised, times the routed scale
    torch.testing.assert_close(w.sum(-1), torch.full((256,), 2.446),
                               rtol=1e-6, atol=0)
    # the drawn bias changes choices
    unbiased = dict(params, **{"moe.router_bias": torch.zeros(16)})
    _, idx0, _ = route_top_k(router_logits(xf, unbiased, pcfg), unbiased,
                             pcfg)
    assert (idx.sort(-1).values != idx0.sort(-1).values).any()


def test_mla_without_a_query_latent_agrees():
    cfg = tiny()
    pcfg = layout.model_config(cfg)
    _, _, tree = tree_of(cfg, 5)
    pre = "layers.0."
    params = {k[len(pre):]: v for k, v in tree.items()
              if k.startswith(pre + "attn.")}
    assert "attn.w_q" in params and "attn.w_dq" not in params
    x = torch.randn(2, SEQ, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(6))
    got = mla_attention(params, x, pcfg)
    with deepseek_v3.exact_fp32():
        want = deepseek_v3.Model(cfg).attention(tree, pre, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _model(cfg, units, dtype):
    kinds = {"embed": "standalone", "head": "standalone"}
    return from_numpy_units(
        layout.model_config(cfg),
        [OffloadUnit(n, kinds.get(n, "block"), p) for n, p in units.items()],
        dtype, device="cpu")


def _mix(paging, slots):
    return {"policy": "memascend", "overlap": "full", "lr": 1e-3,
            "weight_decay": 0.0, "setup_steps": 3, "expert_paging": paging,
            "expert_page_slots": slots}


def _policy(mix, store):
    """The mix's policy computing in fp32 (the reference's precision)."""
    policy = port.policy(mix, lambda: store)
    return policy.replace(adam=dataclasses.replace(policy.adam,
                                                   compute_dtype="float32"))


def _ctx(mix):
    return types.SimpleNamespace(mix=mix, device=torch.device("cpu"),
                                 spans=lambda _: contextlib.nullcontext(),
                                 log=lambda _: None)


def _batch(cfg, i):
    return weights.train_batch(7, i, 2, SEQ, cfg["vocab_size"])


def test_training_steps_agree_in_fp32():
    """Three steps of the tiny model through ``train_step`` (one dense
    layer, two MoE layers; 48 page slots for 96 expert pages) against
    the reference's: losses, first gradients and changes."""
    cfg = tiny()
    mix = _mix("routed", 48)
    leaves, flat, _ = tree_of(cfg, 7, "routed")
    units = weights.host_units(leaves, flat)
    store = HostArenaStore(arena_bytes(leaves, 4, 4))
    with OffloadSession(_model(cfg, units, torch.float32),
                        _policy(mix, store)) as s:
        prog = setup_steps(_ctx(mix), s, store, leaves, units,
                           lambda i: _batch(cfg, i))
        refills = s.expert_cache_stats()["refills"]
    assert refills > 96           # pages were evicted and read back
    ref = driver.reference(cfg, mix, 7, torch.device("cpu"), leaves,
                           weights.checksum(flat),
                           [_batch(cfg, i) for i in (1, 2, 3)])
    numbers = compare.train_numbers(
        prog, ref, [leaf.name for leaf in leaves if leaf.is_expert])
    assert numbers["loss_gap"] < 1e-6, numbers
    assert numbers["grad_norm_gap"] < 1e-5, numbers
    assert numbers["change_norm_gap"] < 1e-3, numbers
    # the bias only picks: no gradient, no change, in both
    bias = [leaf.name for leaf in leaves if leaf.key == "moe.router_bias"]
    assert bias and all(prog["grad_norms"][n] == ref["grad_norms"][n] == 0
                        for n in bias)
    assert all(prog["change_norms"][n] == ref["change_norms"][n] == 0
               for n in bias)


def _run(cfg, paging, slots, steps=2):
    """Losses and final masters of ``steps`` bf16 steps."""
    mix = _mix(paging, slots)
    leaves = layout.layout(cfg, paging)
    units = weights.host_units(leaves, weights.draw(leaves, 9, "cpu"))
    store = HostArenaStore(arena_bytes(leaves, 4, 2))
    model = driver.offloadable(layout.model_config(cfg), units, "cpu")
    with OffloadSession(model, port.policy(mix, lambda: store)) as s:
        losses = [s.train_step(*_batch(cfg, i))["loss"]
                  for i in range(1, steps + 1)]
        s.synchronize()
        masters = {leaf.name: store.view(leaf.name + ".master", np.float32,
                                         leaf.shape).copy()
                   for leaf in leaves}
    return losses, masters


def test_routed_paging_equals_all_resident_bit_for_bit():
    cfg = tiny()
    routed, everything = _run(cfg, "routed", 48), _run(cfg, "all", None)
    assert routed[0] == everything[0]
    for name, value in everything[1].items():
        assert np.array_equal(routed[1][name], value), name


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_pair_counters_equal_the_reference_routing(capacity_factor):
    """One step's forward routing: the (token, choice) pairs of each MoE
    layer, and those past their expert's capacity, as the reference's
    routing of the same weights and batch counts them (fp32, so both
    pick alike)."""
    cfg = tiny(moe_capacity_factor=capacity_factor)
    mix = _mix("routed", 48)
    leaves, flat, tree = tree_of(cfg, 7, "routed")
    units = weights.host_units(leaves, flat)
    store = HostArenaStore(arena_bytes(leaves, 4, 4))
    tokens, labels = _batch(cfg, 1)
    with OffloadSession(_model(cfg, units, torch.float32),
                        _policy(mix, store)) as s:
        s.train_step(tokens, labels)
        s.synchronize()
        snap = s.overlap_snapshot()
    ref = deepseek_v3.Model(cfg)
    t, k, e = 2 * SEQ, cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    capacity = int(max(k * t // e * capacity_factor,
                       cfg["moe_capacity_min"]))
    routed = dropped = 0
    with torch.no_grad(), deepseek_v3.exact_fp32():
        inputs = ref.block_inputs(tree, torch.from_numpy(tokens))
        for i in range(1, cfg["num_hidden_layers"]):
            choice = ref.routing(tree, inputs[i], i)
            counts = np.bincount(choice.reshape(-1).numpy(), minlength=e)
            routed += choice.numel()
            dropped += int(np.maximum(counts - capacity, 0).sum())
    assert snap["expert_routed_pairs"] == routed == 2 * t * k
    assert snap["expert_dropped_pairs"] == dropped
    if capacity_factor < 1:
        assert dropped > 0
    assert snap["expert_route_readback_seconds"] > 0


def test_the_resident_model_runs_the_leading_dense_layer():
    """``init_params`` / ``forward`` of the resident model: the leading
    dense layer ahead of the stacked MoE groups, the loss the reference's
    over the same tensors."""
    cfg = tiny()
    pcfg = layout.model_config(cfg)
    params = transformer.init_params(0, pcfg, device="cpu")
    assert len(params["lead"]) == 1 and "ffn.w_gate" in params["lead"][0]
    shared = {"moe.shared_gate": "shared.w_gate",
              "moe.shared_up": "shared.w_up",
              "moe.shared_down": "shared.w_down"}
    tree = {k: params[k] for k in ("embed", "final_norm", "head")}
    tree.update({f"layers.0.{k}": v for k, v in params["lead"][0].items()})
    for k, v in params["groups"][0].items():
        for g in range(v.shape[0]):
            tree[f"layers.{g + 1}.{shared.get(k, k)}"] = v[g]
    tokens, labels = (torch.from_numpy(a) for a in _batch(cfg, 1))
    with torch.no_grad(), deepseek_v3.exact_fp32():
        got = transformer.lm_loss(pcfg, params, {"tokens": tokens,
                                                 "labels": labels},
                                  compute_dtype=torch.float32, remat=False)
        want = deepseek_v3.Model(cfg).loss(tree, tokens, labels)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
