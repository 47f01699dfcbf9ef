"""The dry run over the production meshes (``lower_pair(..., mesh="pod")``):
the step on DTensors over rank 0's meta shards inside a ``"fake"`` group
of 256 (16x16) or 512 (2x16x16) ranks, at reduced widths.

* The record keeps the reference's keys (read from the reference's
  ``lower_pair`` source: importing ``repro.launch.dryrun`` would set its
  512-device XLA flag in this process), its collectives the reference's
  five kinds, with ``"mesh": "16x16"`` and ``n_chips`` 256.
* Rank 0's argument bytes are exactly the local shards that
  ``param_specs`` / ``batch_specs`` imply.
* A ZeRO-3 train step all-gathers at least each data-sharded weight's
  bytes once; a "tp" decode step moves fewer all-gather bytes than a
  "zero3" one; the roofline's collective term reads the record.
* Every family lowers: train and decode of each architecture.
"""

import ast
import dataclasses
import json
import math
import pathlib

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import sharding as shd
from repro_torch.launch.dryrun import lower_pair
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.models import build
from repro_torch.models.registry import param_shapes
from repro_torch.train.step import tree_leaves

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 32, 64
TRAIN = InputShape("t", S, B, "train")
DECODE = InputShape("d", 128, B, "decode")


def _reference_names():
    """The keys of the reference's ``lower_pair`` record and its
    ``_COLLECTIVES``, from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    kinds = keys = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "_COLLECTIVES" for t in node.targets):
            kinds = tuple(e.value for e in node.value.elts)
        if isinstance(node, ast.FunctionDef) and node.name == "lower_pair":
            dicts = [n.value for n in ast.walk(node)
                     if isinstance(n, ast.Return)
                     and isinstance(n.value, ast.Dict)]
            keys = {k.value for k in max(dicts, key=lambda d: len(d.keys))
                    .keys}
    return keys, kinds


_RECS: dict = {}


def _rec(arch, shape, mesh="pod", *, layers=None, **kw):
    """The record of ``arch`` reduced, or at full width cut to ``layers``."""
    key = (arch, shape.name, shape.kind, mesh, layers,
           tuple(sorted(kw.items())))
    if key not in _RECS:
        cfg = get_config(arch)
        cfg = cfg.reduced() if layers is None else \
            dataclasses.replace(cfg, n_layers=layers)
        _RECS[key] = lower_pair(cfg, shape, mesh, **kw)
    return _RECS[key]


def test_pod_record_keeps_the_reference_keys():
    keys, kinds = _reference_names()
    rec = _rec("qwen3-4b", TRAIN)
    assert keys <= set(rec)
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert rec["calibrated"] is False and rec["status"] == "ok"
    for coll in (rec["collectives"], rec["collectives_raw"]):
        assert tuple(coll["bytes"]) == kinds == tuple(coll["counts"])
        assert coll["total_bytes"] == sum(coll["bytes"].values())
    assert rec["collectives"]["counts"]["all-gather"] > 0
    # one screen launch a gradient leaf, on its local shard, and one MAX
    # all-reduce of the flag
    n_leaves = len(tree_leaves(param_shapes(get_config("qwen3-4b")
                                            .reduced())))
    assert rec["kernels"]["overflow_check"]["launches"] == n_leaves
    assert rec["collectives"]["counts"]["all-reduce"] >= 1


def test_multipod_record_counts_512_chips():
    rec = _rec("qwen3-4b", DECODE, "multipod")
    assert rec["mesh"] == "2x16x16" and rec["n_chips"] == 512


def _local_bytes(tree, specs, mesh) -> int:
    out = []
    shd.spec_map(lambda spec, t: out.append(
        math.prod(shd.local_shape(t.shape, spec, mesh))
        * t.dtype.itemsize), specs, tree)
    return sum(out)


def test_argument_bytes_are_rank_0_s_local_shards():
    cfg = get_config("qwen3-4b").reduced()
    params = param_shapes(cfg)
    batch = build(cfg, device="meta").input_specs(TRAIN)
    with fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        want = (_local_bytes(params, shd.param_specs(cfg, params, mesh),
                             mesh)
                + _local_bytes(batch, shd.batch_specs(cfg, batch, mesh),
                               mesh) + 4)
        full = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rec = _rec("qwen3-4b", TRAIN)
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert want < full


def test_zero3_train_gathers_each_data_sharded_weight():
    cfg = get_config("qwen3-4b").reduced()
    params = param_shapes(cfg)
    with fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        specs = shd.param_specs(cfg, params, mesh)
        gathered = []

        def over_data(spec, t):
            if any("data" in shd._names(p) for p in spec if p is not None):
                model = [p for p in spec if p is not None
                         and "model" in shd._names(p)]
                n = 16 if model else 1
                gathered.append(t.numel() * t.element_size() // n)
        shd.spec_map(over_data, specs, params)
    assert gathered
    rec = _rec("qwen3-4b", TRAIN)
    assert rec["collectives"]["bytes"]["all-gather"] >= sum(gathered)


def test_tp_decode_gathers_fewer_bytes_than_zero3():
    """At qwen3-4b's width (one layer), where the weights outweigh a decode
    step's activations: "zero3" gathers them a token, "tp" holds them.  (At
    the reduced widths the activations are the larger, and DTensor gathers
    whichever is smaller.)"""
    zero3 = _rec("qwen3-4b", DECODE, layers=1, serve_param_mode="zero3")
    tp = _rec("qwen3-4b", DECODE, layers=1, serve_param_mode="tp")
    assert zero3["serve_param_mode"] == "zero3" and tp["serve_param_mode"] \
        == "tp"
    assert tp["collectives"]["bytes"]["all-gather"] < \
        zero3["collectives"]["bytes"]["all-gather"]
    # tp holds every weight whole across data: more argument bytes
    assert tp["memory"]["argument_size_in_bytes"] > \
        zero3["memory"]["argument_size_in_bytes"]


def test_act_hint_is_a_flag():
    rec = _rec("qwen3-4b", TRAIN, act_hint=True)
    assert rec["act_hint"] is True and rec["status"] == "ok"


def test_roofline_reads_the_collective_term(tmp_path):
    # the roofline's useful ratio reads the arch and shape by name
    rec = dict(_rec("qwen3-4b", TRAIN), arch="qwen3-4b", shape="train_4k")
    r = roofline.analyze(rec)
    assert r.mesh == "16x16"
    assert r.collective_s == pytest.approx(
        roofline.link_bytes(rec["collectives"]) / roofline.LINK_BW)
    assert r.collective_s > 0
    (tmp_path / "a.json").write_text(json.dumps(rec))
    text = roofline.report(str(tmp_path), "pod")
    assert "16x16" in text and "32 eight-GPU nodes" in text
    assert "| qwen3-4b | train_4k |" in text


def test_cli_writes_under_the_mesh(tmp_path, capsys):
    dryrun.run_all(["qwen3-4b"], ["long_500k"], str(tmp_path / "pod"),
                   mesh="pod", serve_param_mode="tp")
    rec = json.loads((tmp_path / "pod" / "qwen3-4b__long_500k.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["serve_param_mode"] == "tp"


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_family_lowers_on_the_pod_mesh(arch):
    cfg = get_config(arch).reduced()
    seq = S + (cfg.prefix_len or 0)
    train = _rec(arch, InputShape("t", seq, B, "train"))
    decode = _rec(arch, DECODE)
    for rec in (train, decode):
        assert rec["status"] == "ok" and rec["n_chips"] == 256
        assert rec["cost"]["flops"] > 0
    assert train["collectives"]["counts"]["all-gather"] > 0
    assert train["kernels"]["overflow_check"]["launches"] > 0


def test_moe_experts_stay_split_over_model():
    """Expert parallel on the pod mesh: with 16 experts over the 16-way
    "model" axis each rank holds one expert's stacks, gathered over "data"
    only, so it gathers far less than the stacks (a layout that ran every
    expert on every rank would gather each stack whole) and computes a
    small share of the one-card step's flops."""
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=16, d_ff_expert=1024))
    stacks = []
    shd.tree_map_with_path(
        lambda path, t: stacks.append(t.numel() * t.element_size())
        if shd._leaf_key(path) in ("moe.w_gate", "moe.w_up", "moe.w_down")
        else None, param_shapes(cfg))
    pod = lower_pair(cfg, TRAIN, "pod")
    one = lower_pair(cfg, TRAIN)
    assert pod["collectives"]["bytes"]["all-gather"] < sum(stacks) / 2
    assert pod["cost"]["flops"] < one["cost"]["flops"] / 16
