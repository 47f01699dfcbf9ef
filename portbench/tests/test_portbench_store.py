"""``HostArenaStore`` against the ``TensorStore`` contract, and the port's
trainer over it against the same trainer over its direct-NVMe store."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from conftest import REPO

sys.path[:0] = [str(REPO / "portbench"), str(REPO / "src")]

import port  # noqa: E402
import weights  # noqa: E402
from drivers import train  # noqa: E402
from stores.host_arena import HostArenaStore  # noqa: E402

from repro_torch.core import DirectNVMeEngine, OffloadSession  # noqa: E402
from repro_torch.core.dtypes import BF16_HOST  # noqa: E402


@pytest.mark.parametrize("dtype", [np.float32, np.int64, BF16_HOST])
def test_round_trips(dtype):
    store = HostArenaStore(1 << 20)
    a = (np.arange(1000) % 251).astype(dtype).reshape(10, 100)
    store.write("a", a)
    assert np.array_equal(store.read_new("a", dtype, a.shape), a)
    out = np.empty_like(a)
    assert store.read_async("a", out).result() is out
    assert np.array_equal(out, a)
    store.write_async("a", a[::-1]).result()      # in place, same size
    assert np.array_equal(store.read_new("a", dtype, a.shape), a[::-1])
    assert np.array_equal(store.view("a", dtype, a.shape), a[::-1])
    stats = store.stats.snapshot()
    assert (stats["n_writes"], stats["n_reads"]) == (2, 3)
    assert stats["bytes_written"] == 2 * a.nbytes
    assert stats["bytes_read"] == 3 * a.nbytes
    store.close()


def test_keys_delete_and_errors():
    store = HostArenaStore(3 * 4096)
    store.write("x", np.zeros(10, np.float32))
    store.write("y", np.ones(4096, np.uint8))
    assert sorted(store.keys()) == ["x", "y"] and store.contains("x")
    with pytest.raises(ValueError, match="size change"):
        store.write("x", np.zeros(11, np.float32))
    with pytest.raises(ValueError, match="size mismatch"):
        store.read("x", np.empty(9, np.float32))
    with pytest.raises(IOError, match="full"):
        store.write("z", np.zeros(4097, np.uint8))
    store.delete("x")
    assert not store.contains("x")
    with pytest.raises(KeyError):
        store.read_new("x", np.float32, (10,))
    store.write("z", np.zeros(4096, np.uint8))
    assert sorted(store.keys()) == ["y", "z"]
    store.close()


def test_the_arena_is_resident_from_the_start():
    import rss
    before = rss.vm_rss()
    store = HostArenaStore(64 << 20)
    assert rss.vm_rss() - before >= 60 << 20
    store.close()


@pytest.mark.parametrize("paging", ["off", "routed"])
def test_trainer_over_the_arena_equals_the_direct_nvme_store(paging,
                                                             tmp_path):
    name = "qwen3-4b" if paging == "off" else "qwen3-30b-a3b"
    cfg = json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(hidden_size=64, intermediate_size=96, moe_intermediate_size=24,
               num_experts=8, num_experts_per_tok=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, vocab_size=256)
    if paging == "off":
        cfg.pop("num_experts")
    mix = {"policy": "memascend", "overlap": "full", "lr": 1e-3,
           "weight_decay": 0.0, "expert_paging": paging,
           "expert_page_slots": 24 if paging != "off" else None}
    leaves = weights.layout(cfg, paging)
    units = weights.host_units(leaves, weights.draw(leaves, 4, "cpu"))
    batches = [weights.train_batch(4, i, 2, 16, 256) for i in (1, 2)]
    arena = HostArenaStore(train.arena_bytes(leaves, 4, 2))
    stores = {"arena": lambda: arena,
              "nvme": lambda: DirectNVMeEngine(str(tmp_path), n_devices=2,
                                               device_capacity=1 << 24)}
    got = {}
    for kind, factory in stores.items():
        model = port.offloadable(cfg, units, "cpu")
        with OffloadSession(model, port.policy(mix, factory)) as s:
            losses = [s.train_step(*b)["loss"] for b in batches]
            masters = [s.master_param(leaf.unit, leaf.key)
                       for leaf in leaves]
        got[kind] = losses, masters
    assert got["arena"][0] == got["nvme"][0]
    for a, b in zip(got["arena"][1], got["nvme"][1], strict=True):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
