"""Kimi Linear's block in the port (which the JAX package has not) held to
the plain reference of ``portbench/reference/kimi_linear.py`` at a tiny
size on the CPU: the chunked KDA against the token recurrence (a strong
decay among the cases), the KDA mixer and MLA with no rope, a model of
one leading dense KDA layer and the KDA, KDA, MLA, KDA period trained
through ``OffloadSession.train_step`` with routed expert paging over a
held share of the experts, paging off and routed giving the same bits,
the expert share adding up to the uncut layer, the session's pair and
KDA counters, and cached decode refused."""

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
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "portbench")]

import layout_kimi_linear as layout  # noqa: E402
import port  # noqa: E402
import weights  # noqa: E402
from drivers import train_kimi_linear as driver  # noqa: E402
from drivers.train import arena_bytes, setup_steps  # noqa: E402
from reference import kimi_linear  # noqa: E402
from stores.host_arena import HostArenaStore  # noqa: E402

from repro_torch.configs import PORT_MODELS, get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import (DecodeSpec, OffloadSession,  # noqa: E402
                              OffloadUnit)
from repro_torch.core import trace  # noqa: E402
from repro_torch.core.model_adapter import (block_kinds,  # noqa: E402
                                            from_numpy_units)
from repro_torch.models import kda  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import mla_attention  # noqa: E402
from repro_torch.models.layers import dense  # noqa: E402
from repro_torch.models.moe import (_bmm, _capacity, _route,  # noqa: E402
                                    moe_ffn, router_logits)

torch.set_num_threads(2)

TINY = dict(name="kimi-tiny", hidden_size=64, intermediate_size=96,
            moe_intermediate_size=24, router_experts=16, num_experts=8,
            held_experts=[4, 12], num_experts_per_token=4,
            num_attention_heads=4, num_key_value_heads=4,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            kv_lora_rank=32, vocab_size=512, num_hidden_layers=5,
            linear_attn_config={"full_attn_layers": [4], "head_dim": 16,
                                "kda_layers": [1, 2, 3, 5], "num_heads": 4,
                                "short_conv_kernel_size": 4})
SEQ = 32


def tiny(**changes) -> dict:
    cfg = json.loads((REPO / "portbench" / "configs" /
                      "kimi-linear-48b-a3b.json").read_text())
    cfg.update(TINY, **changes)
    return cfg


def tree_of(cfg, seed, paging="off"):
    leaves = layout.layout(cfg, paging)
    flat = layout.draw(leaves, seed, "cpu")
    return leaves, flat, weights.reference_tree(leaves, flat)


# -- the configuration ---------------------------------------------------------

def test_the_config_is_the_port_s_own():
    cfg = get_config("kimi-linear-48b-a3b")
    assert cfg is PORT_MODELS["kimi-linear-48b-a3b"]
    from repro_torch.configs import ALL_MODELS
    assert cfg.name not in ALL_MODELS
    kinds = [transformer.mixer_kind(cfg, i) for i in range(cfg.n_layers)]
    assert kinds.count("kda") == 20 and kinds.count("mla") == 7
    assert kinds[3::4] == ["mla"] * 6 and kinds[-1] == "mla"
    assert (cfg.d_model, cfg.kda.n_heads, cfg.kda.head_dim,
            cfg.kda.conv_kernel, cfg.moe.n_experts, cfg.moe.n_held,
            cfg.moe.top_k, cfg.mla.use_rope) == (2304, 32, 128, 4, 256, 256,
                                                 8, False)


def test_the_cell_s_config_has_the_published_widths_and_its_share():
    cfg = json.loads((REPO / "portbench" / "configs" /
                      "kimi-linear-48b-a3b.json").read_text())
    pcfg = layout.model_config(cfg)
    assert (pcfg.moe.n_experts, pcfg.moe.held_range, pcfg.moe.top_k) == \
        (256, (0, 64), 8)
    assert [transformer.mixer_kind(pcfg, i) for i in range(5)] == \
        ["kda", "kda", "kda", "mla", "kda"]
    assert [transformer.ffn_kind(pcfg, i) for i in range(5)] == \
        ["dense"] + ["moe"] * 4
    leaves = layout.layout(cfg, "routed")
    assert weights.n_params(leaves) == 2_848_500_608
    by_unit: dict = {}
    for leaf in leaves:
        by_unit[leaf.unit] = by_unit.get(leaf.unit, 0) + leaf.size
    assert by_unit["embed"] + by_unit["head"] - 2304 == 754_974_720
    assert by_unit["block_000"] == 103_223_968
    assert by_unit["block_001"] == by_unit["block_004"] == 500_175_776
    assert by_unit["block_003"] == 489_772_288
    # the port's census covers every streamed KDA matrix
    shapes = pcfg.block_param_shapes(1)
    assert {k for k in shapes if k.startswith("kda.")} == {
        leaf.key for leaf in leaves
        if leaf.unit == "block_001" and leaf.key.startswith("kda.")
        and len(leaf.shape) == 2}
    assert sum(k.startswith("moe.expert") for k in shapes) == 3 * 64
    assert {pcfg.class_of_param(k) for k in shapes
            if k.startswith("kda.")} == {"qo_proj", "kv_proj", "ssm"}


# -- the chunked KDA -----------------------------------------------------------

def _kda_inputs(b, s, h, d, *, seed=0, strong=False):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    q, k = (kda.l2_normalize(rand(b, s, h, d)) for _ in range(2))
    v = rand(b, s, h, d)
    if strong:
        # A = 16 and large softplus inputs: a chunk's decays sum to
        # thousands, past what exp(-Gamma) holds in fp32
        g = -16.0 * F.softplus(4.0 + 2.0 * rand(b, s, h, d))
    else:
        g = -torch.exp(rand(h, 1)) * F.softplus(rand(b, s, h, d) - 2.0)
    beta = torch.sigmoid(rand(b, s, h))
    return q, k, v, g, beta


@pytest.mark.parametrize("seq", [1, 63, 64, 100, 200])
def test_the_chunked_form_is_the_recurrence(seq):
    x = _kda_inputs(2, seq, 3, 16, seed=seq)
    got = kda.chunked_delta_rule(*x)
    want, _ = kimi_linear.recurrence(*x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_a_strong_decay_stays_finite_where_exp_minus_gamma_overflows():
    q, k, v, g, beta = _kda_inputs(2, 200, 3, 16, seed=5, strong=True)
    chunk_gamma = g[:, :64].cumsum(1)
    assert torch.isinf(torch.exp(-chunk_gamma)).any()    # the one-sided form
    got = kda.chunked_delta_rule(q, k, v, g, beta)
    assert torch.isfinite(got).all()
    want, _ = kimi_linear.recurrence(q, k, v, g, beta)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_the_backward_differentiates_the_kept_graph():
    """Gradients as the recurrence's, from one chunked forward: the
    backward runs on the forward's graph, not a recompute."""
    x = [t.requires_grad_() for t in _kda_inputs(2, 100, 3, 16, seed=7)]
    calls = []
    whole = kda.chunked_delta_rule

    def counted(*a, **kw):
        calls.append(1)
        return whole(*a, **kw)

    ledger = trace.KDALedger()
    kda.chunked_delta_rule = counted
    try:
        with trace.counting(ledger):
            out = kda.delta_rule(*x)
        assert trace.kda_ledger() is None
        got = torch.autograd.grad(out.square().sum(), x)
    finally:
        kda.chunked_delta_rule = whole
    assert len(calls) == 1
    assert ledger.snapshot() == {"kda_calls": 1, "kda_tokens": 200,
                                 "kda_device_seconds": 0.0}
    ref = [t.detach().clone().requires_grad_() for t in x]
    want = torch.autograd.grad(
        kimi_linear.recurrence(*ref)[0].square().sum(), ref)
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seq,segment,strong", [
    (1, 256, False), (63, 256, False), (100, 7, False), (100, 7, True),
    (200, 64, True)])
def test_the_reference_gradient_is_the_recurrences(monkeypatch, seq,
                                                   segment, strong):
    """The reference's written-out gradient (recomputed a segment at a
    time) against autograd over the plain token recurrence, in float64."""
    monkeypatch.setattr(kimi_linear, "SEGMENT", segment)
    x = [t.double().requires_grad_()
         for t in _kda_inputs(2, seq, 3, 8, seed=seq, strong=strong)]
    ref = [t.detach().clone().requires_grad_() for t in x]
    got = kimi_linear.delta_rule(*x)
    want = kimi_linear.recurrence(*ref)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    weight = torch.randn(got.shape, dtype=got.dtype,
                         generator=torch.Generator().manual_seed(seq))
    for a, b in zip(torch.autograd.grad((got * weight).sum(), x),
                    torch.autograd.grad((want * weight).sum(), ref),
                    strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def _unit_params(tree, i):
    pre = f"layers.{i}."
    return {k[len(pre):]: v for k, v in tree.items() if k.startswith(pre)}


def test_the_kda_mixer_agrees():
    cfg = tiny()
    pcfg = layout.model_config(cfg)
    _, _, tree = tree_of(cfg, 3)
    x = torch.randn(2, SEQ, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    got = kda.kda_mixer(_unit_params(tree, 1), x, pcfg)
    with kimi_linear.exact_fp32():
        want = kimi_linear.Model(cfg).kda(tree, "layers.1.", x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_mla_without_rope_ignores_rope_theta():
    cfg = tiny()
    pcfg = layout.model_config(cfg)
    _, _, tree = tree_of(cfg, 5)
    params = {k: v for k, v in _unit_params(tree, 3).items()
              if k.startswith("attn.")}
    x = torch.randn(2, SEQ, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(6))
    got = mla_attention(params, x, pcfg)
    other = dataclasses.replace(pcfg, rope_theta=123.0)
    assert torch.equal(mla_attention(params, x, other), got)
    roped = dataclasses.replace(
        pcfg, mla=dataclasses.replace(pcfg.mla, use_rope=True))
    assert not torch.equal(mla_attention(params, x, roped), got)
    with kimi_linear.exact_fp32():
        want = kimi_linear.Model(cfg).attention(tree, "layers.3.", x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# -- the offloaded trainer -----------------------------------------------------

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
    """Three steps of the tiny model through ``train_step`` (a dense KDA
    layer, then KDA, KDA, MLA, KDA with experts 4-11 of 16 held; 12 page
    slots for 96 expert pages) against the reference's: losses, first
    gradients and changes, the KDA leaves' gradients among them."""
    cfg = tiny()
    mix = _mix("routed", 12)
    leaves, flat, _ = tree_of(cfg, 7, "routed")
    units = weights.host_units(leaves, flat)
    store = HostArenaStore(arena_bytes(leaves, 4, 4))
    model = _model(cfg, units, torch.float32)
    assert [block_kinds(u.params) for u in model.units[1:-1]] == \
        [("kda", "dense")] + [("kda", "moe")] * 2 + [("mla", "moe"),
                                                      ("kda", "moe")]
    with OffloadSession(model, _policy(mix, store)) as s:
        prog = setup_steps(_ctx(mix), s, store, leaves, units,
                           lambda i: _batch(cfg, i))
        refills = s.expert_cache_stats()["refills"]
    assert refills > 0            # pages were evicted and read back
    ref = driver.reference(cfg, mix, 7, torch.device("cpu"), leaves,
                           weights.checksum(flat),
                           [_batch(cfg, i) for i in (1, 2, 3)])
    numbers = driver.numbers(prog, ref, leaves)
    assert numbers["loss_gap"] < 1e-6, numbers
    assert numbers["grad_norm_gap"] < 1e-5, numbers
    assert numbers["kda_grad_gap"] < 1e-5, numbers
    assert numbers["change_norm_gap"] < 1e-3, numbers
    kda_leaves = [leaf.name for leaf in leaves if ".a_log" in leaf.key]
    assert len(kda_leaves) == 4 and all(ref["grad_norms"][n] > 0
                                        for n in kda_leaves)


def _stacked(units: dict) -> dict:
    """Paged units with each MoE block's expert pages stacked back into
    ``moe.w_{gate,up,down}`` (the units of paging "off")."""
    out = {}
    for name, params in units.items():
        pages = sorted(k for k in params if k.startswith("moe.expert"))
        out[name] = {k: v for k, v in params.items() if k not in pages}
        held = len(pages) // 3
        for w in ("w_gate", "w_up", "w_down") if pages else ():
            out[name][f"moe.{w}"] = np.stack(
                [params[f"moe.expert{x}.{w}"] for x in range(held)])
    return out


def _run(cfg, paging, slots, steps=2):
    """Losses and final masters of ``steps`` bf16 steps, from the paged
    layout's draw."""
    mix = _mix(paging, slots)
    leaves = layout.layout(cfg, "routed")
    units = weights.host_units(leaves, layout.draw(leaves, 9, "cpu"))
    if paging == "off":
        units = _stacked(units)
    store = HostArenaStore(arena_bytes(leaves, 4, 2))
    model = driver.offloadable(layout.model_config(cfg), units, "cpu")
    with OffloadSession(model, port.policy(mix, lambda: store)) as s:
        losses = [s.train_step(*_batch(cfg, i))["loss"]
                  for i in range(1, steps + 1)]
        s.synchronize()
        masters = {f"{u}/{k}": store.view(f"{u}/{k}.master", np.float32,
                                          v.shape).copy()
                   for u, params in units.items() for k, v in params.items()}
    return losses, masters


def test_paging_off_and_routed_give_the_same_bits():
    cfg = tiny()
    off, routed = _run(cfg, "off", None), _run(cfg, "routed", 12)
    assert off[0] == routed[0]
    for name, want in routed[1].items():
        if ".expert" not in name:
            assert np.array_equal(off[1][name], want), name
            continue
        unit, key = name.split("/")
        x, w = key[len("moe.expert"):].split(".")
        assert np.array_equal(off[1][f"{unit}/moe.{w}"][int(x)], want), name


def test_the_pair_and_kda_counters():
    """One step's forward routing: the held experts' (token, choice)
    pairs, those past their capacity and the pairs routed to other
    chips' experts, as the reference's routing of the same weights and
    batch counts them (fp32); KDA's chunked forwards and tokens."""
    cfg = tiny(moe_capacity_factor=0.5)
    mix = _mix("routed", 12)
    leaves, flat, tree = tree_of(cfg, 7, "routed")
    units = weights.host_units(leaves, flat)
    store = HostArenaStore(arena_bytes(leaves, 4, 4))
    tokens, labels = _batch(cfg, 1)
    with OffloadSession(_model(cfg, units, torch.float32),
                        _policy(mix, store)) as s:
        before = s.overlap_snapshot()
        # the session's own ledger: other sessions' KDA is not counted
        assert before["kda_calls"] == before["kda_tokens"] == 0
        s.train_step(tokens, labels)
        s.synchronize()
        snap = s.overlap_snapshot()
    ref = kimi_linear.Model(cfg)
    t, k, e = 2 * SEQ, cfg["num_experts_per_token"], cfg["router_experts"]
    capacity = int(max(k * t // e * 0.5, cfg["moe_capacity_min"]))
    first, end = cfg["held_experts"]
    routed = dropped = unheld = 0
    with torch.no_grad(), kimi_linear.exact_fp32():
        inputs = ref.block_inputs(tree, torch.from_numpy(tokens))
        for i in range(1, cfg["num_hidden_layers"]):
            choice = ref.routing(tree, inputs[i], i).reshape(-1).numpy()
            mine = choice[(choice >= first) & (choice < end)]
            counts = np.bincount(mine, minlength=e)
            routed += mine.size
            unheld += choice.size - mine.size
            dropped += int(np.maximum(counts - capacity, 0).sum())
    assert snap["expert_routed_pairs"] == routed > 0
    assert snap["expert_unheld_pairs"] == unheld > 0
    assert routed + unheld == 4 * t * k
    assert snap["expert_dropped_pairs"] == dropped > 0
    # four KDA blocks: a forward each and a recompute each in the backward
    assert snap["kda_calls"] - before["kda_calls"] == 8
    assert snap["kda_tokens"] - before["kda_tokens"] == 8 * t
    assert snap["kda_device_seconds"] == 0.0


def test_cached_decode_is_refused_naming_kda(tmp_path):
    cfg = tiny()
    leaves, flat, _ = tree_of(cfg, 1)
    model = _model(cfg, weights.host_units(leaves, flat), torch.float32)
    mix = _mix("off", None)
    store = HostArenaStore(arena_bytes(leaves, 4, 4))
    with pytest.raises(ValueError, match="cached-decode.*KDA"):
        OffloadSession(model, _policy(mix, store), mode="serve",
                       decode=DecodeSpec(batch=1, max_seq=64, bucket=16))


# -- the expert share ----------------------------------------------------------

def _moe_params(cfg, tree, i, held=None):
    """Layer ``i``'s MoE params in the port's names, the stacks cut to
    ``held`` [first, end) of the tree's experts."""
    pre = f"layers.{i}."
    names = {"moe.w_router": "moe.w_router",
             "moe.router_bias": "moe.router_bias",
             "moe.shared_gate": "shared.w_gate", "moe.shared_up":
             "shared.w_up", "moe.shared_down": "shared.w_down"}
    p = {k: tree[pre + v] for k, v in names.items()}
    lo, hi = held or (0, tree[pre + "moe.w_gate"].shape[0])
    for w in ("w_gate", "w_up", "w_down"):
        p[f"moe.{w}"] = tree[pre + f"moe.{w}"][lo:hi]
    return p


def test_the_shares_add_up_to_the_uncut_layer():
    """Four chips' shares of a 16-expert layer, each routed over all 16,
    plus the shared expert counted once, give what the uncut reference
    gives for the whole layer."""
    whole = tiny(num_experts=16, held_experts=[0, 16])
    pcfg = layout.model_config(whole)
    _, _, tree = tree_of(whole, 11)
    x = torch.randn(2, SEQ, whole["hidden_size"],
                    generator=torch.Generator().manual_seed(12))
    with torch.no_grad(), kimi_linear.exact_fp32():
        want = kimi_linear.Model(whole).experts(tree, "layers.1.", x)
        total = 0
        for lo in range(0, 16, 4):
            share = dataclasses.replace(
                pcfg, moe=dataclasses.replace(pcfg.moe, held=(lo, lo + 4)))
            params = _moe_params(whole, tree, 1, (lo, lo + 4))
            if lo:                      # the shared expert once
                params = {k: v for k, v in params.items()
                          if not k.startswith("moe.shared_")}
            total = total + moe_ffn(params, x, share)[0]
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)


def _parent_moe_ffn(params, x, cfg):
    """The dispatch every expert ran before a held range existed."""
    e = cfg.moe
    b, s, d = x.shape
    t, k = b * s, e.top_k
    xf = x.reshape(t, d)
    w, flat_e, pos, aux = _route(router_logits(xf, params, cfg), params, cfg)
    capacity = _capacity(cfg, t)
    keep = pos < capacity
    scratch = e.n_experts * capacity
    row = torch.where(keep, flat_e * capacity + pos,
                      torch.full_like(pos, scratch))
    rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    dispatched = x.new_zeros((scratch + 1, d)).index_put(
        (row,), rep)[:scratch].reshape(e.n_experts, capacity, d)
    up = _bmm(dispatched, params["moe.w_up"])
    gate = _bmm(dispatched, params["moe.w_gate"])
    out_e = _bmm(F.silu(gate) * up, params["moe.w_down"])
    out_rows = torch.cat([out_e.reshape(scratch, d), x.new_zeros((1, d))])
    wk = (w.reshape(-1) * keep).to(x.dtype)
    contrib = (out_rows[row] * wk[:, None]).reshape(t, k, d)
    yf = x.new_zeros((t, d))
    for j in range(k):
        yf = yf + contrib[:, j]
    if "moe.shared_up" in params:
        yf = yf + dense(F.silu(dense(xf, params["moe.shared_gate"]))
                        * dense(xf, params["moe.shared_up"]),
                        params["moe.shared_down"])
    return yf.reshape(b, s, d), aux * e.router_aux_weight


@pytest.mark.parametrize("arch", ["qwen3-30b-a3b", "moonlight-16b-a3b"])
def test_holding_every_expert_keeps_the_parent_s_bits(arch):
    cfg = get_config(arch)
    cfg = dataclasses.replace(
        cfg, d_model=64, moe=dataclasses.replace(cfg.moe, n_experts=16,
                                                 d_ff_expert=24))
    gen = torch.Generator().manual_seed(13)
    e, d, f = 16, 64, 24
    params = {"moe.w_router": torch.randn(d, e, generator=gen),
              "moe.w_gate": torch.randn(e, d, f, generator=gen) / 8,
              "moe.w_up": torch.randn(e, d, f, generator=gen) / 8,
              "moe.w_down": torch.randn(e, f, d, generator=gen) / 5}
    if cfg.moe.scoring == "sigmoid":
        params["moe.router_bias"] = torch.randn(e, generator=gen) * 0.02
    if cfg.moe.n_shared:
        params.update({"moe.shared_gate": torch.randn(d, 48, generator=gen),
                       "moe.shared_up": torch.randn(d, 48, generator=gen),
                       "moe.shared_down": torch.randn(48, d, generator=gen)})
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    x = torch.randn(2, 40, d, generator=gen).to(torch.bfloat16)
    want = _parent_moe_ffn(params, x, cfg)
    for held in (None, (0, e)):
        share = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, held=held))
        got = moe_ffn(params, x, share)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="held experts"):
        MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, held=(2, 6))


# -- periods longer than one ---------------------------------------------------

def test_a_hybrid_period_trains_offloaded(tmp_path):
    """Blocks take their kinds from their own parameters, so a period of
    eight (jamba: Mamba and attention, dense and MoE FFNs) streams
    through the offloaded trainer: its first loss is the resident
    model's over the same weights (fp32; no load-balance loss, which the
    offloaded loss leaves out)."""
    from repro_torch.core import OffloadPolicy
    from repro_torch.core.model_adapter import make_offloadable_lm
    cfg = get_config("jamba-v0.1-52b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0))
    assert transformer.layer_period(cfg) == cfg.n_layers == 8
    model = make_offloadable_lm(cfg, 0, torch.float32, device="cpu")
    blocks = model.units[1:-1]
    assert {block_kinds(u.params) for u in blocks} == {
        ("mamba", "dense"), ("mamba", "moe"), ("attn", "moe")}
    params = {"embed": torch.from_numpy(model.units[0].params["embed"]),
              "final_norm": torch.from_numpy(
                  model.units[-1].params["final_norm"]),
              "head": torch.from_numpy(model.units[-1].params["head"]),
              "groups": [{k: torch.from_numpy(v)[None]
                          for k, v in u.params.items()} for u in blocks]}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, SEQ))
    with torch.no_grad():
        want = transformer.lm_loss(
            cfg, params, {"tokens": torch.from_numpy(tokens),
                          "labels": torch.from_numpy(tokens)},
            compute_dtype=torch.float32, remat=False)
    policy = OffloadPolicy.preset("memascend").with_store(
        str(tmp_path)).build()
    policy = policy.replace(adam=dataclasses.replace(
        policy.adam, compute_dtype="float32"))
    with OffloadSession(model, policy) as s:
        got = s.train_step(tokens, tokens)["loss"]
    assert got == pytest.approx(float(want), rel=1e-5)
