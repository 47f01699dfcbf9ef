"""Trainer checkpoints and the synthetic data loader in the port, held to
the reference package.

* ``save_pytree`` / ``load_pytree`` round trips through both store
  engines, fp32, int32 and bf16 leaves, bit for bit;
* cross-package reads: what the reference's ``save_pytree`` wrote, the
  port's ``load_pytree`` reads, and the reverse, bit for bit and with the
  same manifest;
* resume: four straight ``OffloadedTrainer`` steps (``memascend`` as
  shipped, the host tier of activation checkpoints) equal two steps,
  snapshot, clobber, restore and two more, atol 1e-6 (the reference's own
  bound in ``tests/test_checkpoint.py``), and equal the reference's four
  losses within rtol 1e-5 at fp32 (the same math in another summation
  order, as in ``tests/test_torch_train.py``);
* ``SyntheticTextDataset`` / ``DataLoader`` batches equal the reference's.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import (DirectNVMeEngine as JDirect,
                        FilesystemEngine as JFilesystem,
                        OffloadedTrainer as JTrainer,
                        memascend_policy as jax_memascend)
from repro.core import checkpoint as jckpt
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.data import DataLoader as JLoader
from repro.data import SyntheticTextDataset as JDataset
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (DirectNVMeEngine, FilesystemEngine,
                              OffloadedTrainer, memascend_policy)
from repro_torch.core import checkpoint as tckpt
from repro_torch.core.dtypes import cast_host
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.data import DataLoader, SyntheticTextDataset

torch.set_num_threads(2)


def _arrays(seed=0):
    """fp32, int32 and bf16 (uint16 bits) leaves, made with numpy."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "c": np.arange(6, dtype=np.int32).reshape(2, 3),
            "g": cast_host(rng.standard_normal((2, 5)).astype(np.float32),
                           "bfloat16"),
            "p": rng.standard_normal(3).astype(np.float32),
            "q": np.array([7, -3], np.int32)}


def _port_tree(x):
    """The port's form: numpy leaves, bf16 as a torch tensor."""
    g = torch.from_numpy(x["g"].view(np.int16)).view(torch.bfloat16)
    return {"a": x["a"], "nested": {"c": torch.from_numpy(x["c"]),
                                    "b": x["b"]},
            "groups": [g], "pair": (x["p"], x["q"])}


def _jax_tree(x):
    return {"a": jnp.asarray(x["a"]),
            "nested": {"c": jnp.asarray(x["c"]), "b": jnp.asarray(x["b"])},
            "groups": [jnp.asarray(x["g"].view(ml_dtypes.bfloat16))],
            "pair": (jnp.asarray(x["p"]), jnp.asarray(x["q"]))}


def _bits(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = (leaf.view(torch.int16) if leaf.dtype == torch.bfloat16
                else leaf).numpy()
    return np.asarray(leaf).view(np.uint8).ravel()


def _leaves(tree) -> list:
    """Leaves in the order both packages walk them (sorted dict keys)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for sub in tree for v in _leaves(sub)]
    return [tree]


def _same_bits(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _store(pkg, engine, root):
    if engine == "direct":
        cls = DirectNVMeEngine if pkg == "port" else JDirect
        return cls(root, n_devices=2, device_capacity=1 << 22)
    cls = FilesystemEngine if pkg == "port" else JFilesystem
    return cls(root, fsync=False)


@pytest.mark.parametrize("engine", ["direct", "filesystem"])
def test_pytree_roundtrip(tmp_path, engine):
    x = _arrays(1)
    tree = _port_tree(x)
    store = _store("port", engine, str(tmp_path))
    try:
        manifest = tckpt.save_pytree(store, "ckpt0", tree)
        assert manifest["leaves"]["groups/0"] == {"dtype": "bfloat16",
                                                  "shape": [2, 5]}
        assert tckpt.load_manifest(store, "ckpt0") == manifest
        back = tckpt.load_pytree(store, "ckpt0", tree)
        assert back["groups"][0].dtype == torch.bfloat16
        assert isinstance(back["pair"], tuple)
        assert list(back["nested"]) == ["c", "b"]   # like's own key order
        _same_bits(back, tree)
        # without tensors in ``like``, bf16 comes back as uint16 bits
        plain = tckpt.load_pytree(store, "ckpt0", {
            "a": 0, "nested": {"b": 0, "c": 0}, "groups": [0],
            "pair": (0, 0)})
        assert plain["groups"][0].dtype == np.uint16
        np.testing.assert_array_equal(plain["groups"][0], x["g"])
    finally:
        store.close()


@pytest.mark.parametrize("engine", ["direct", "filesystem"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_package_reads(tmp_path, engine, writer):
    """Each package reads what the other wrote, bit for bit, under the
    same manifest.  A direct-NVMe store keeps its extent map in memory,
    so both packages go through the writer's store object; filesystem
    stores are reopened by the reader's own engine."""
    x = _arrays(2)
    root = str(tmp_path)
    pkg, save = (("ref", jckpt.save_pytree) if writer == "reference"
                 else ("port", tckpt.save_pytree))
    store = _store(pkg, engine, root)
    reader = store
    try:
        tree = _jax_tree(x) if writer == "reference" else _port_tree(x)
        manifest = save(store, "ck", tree)
        if engine == "filesystem":
            reader = _store("port" if writer == "reference" else "ref",
                            engine, root)
        if writer == "reference":
            back = tckpt.load_pytree(reader, "ck", _port_tree(x))
            assert tckpt.load_manifest(reader, "ck") == manifest
        else:
            back = jckpt.load_pytree(reader, "ck",
                                     jax.eval_shape(lambda: _jax_tree(x)))
            assert jckpt.load_manifest(reader, "ck") == manifest
        _same_bits(back, _port_tree(x))
        # the other package writes the same tree under the same manifest,
        # byte for byte (key order included)
        twin = _store("port" if writer == "reference" else "ref",
                      "filesystem", str(tmp_path / "twin"))
        try:
            twin_manifest = (
                tckpt.save_pytree(twin, "ck", _port_tree(x))
                if writer == "reference" else
                jckpt.save_pytree(twin, "ck", _jax_tree(x)))
            assert json.dumps(twin_manifest) == json.dumps(manifest)
        finally:
            twin.close()
    finally:
        if reader is not store:
            reader.close()
        store.close()


CFG_KW = dict(name="ck", family="dense", n_layers=2, d_model=48, n_heads=4,
              n_kv_heads=2, d_ff=96, vocab=128)


def _resume_batches(n, loader=DataLoader, dataset=SyntheticTextDataset):
    dl = loader(dataset(vocab=128, seed=5), batch=2, seq_len=16)
    return [dl.next_batch() for _ in range(n)]


def test_trainer_resume(tmp_path):
    """Resume continues the exact trajectory: 4 straight steps vs 2 steps
    + snapshot + clobber + restore + 2 steps, on the port's trainer with
    the preset's host tier; and the reference trainer's 4 losses."""
    units = jax_lm(JConfig(**CFG_KW), jax.random.PRNGKey(0), jnp.float32)
    cfg = ModelConfig(**CFG_KW)

    def trainer(root):
        model = from_numpy_units(cfg, units.units, torch.float32,
                                 device="cpu")
        return OffloadedTrainer(model, memascend_policy(
            root, lr=1e-3, compute_dtype="float32"))

    bs = _resume_batches(4)
    tr = trainer(str(tmp_path / "a"))
    assert tr.session._act_tiers == ("host", "host")
    straight = [tr.train_step(b["tokens"], b["labels"])["loss"] for b in bs]
    tr.close()

    tr2 = trainer(str(tmp_path / "b"))
    part1 = [tr2.train_step(b["tokens"], b["labels"])["loss"]
             for b in bs[:2]]
    tckpt.snapshot_trainer(tr2)
    tr2.scaler.scale = 123.0           # clobber, then restore
    tr2.optimizer.step_count = 999
    state = tckpt.restore_trainer_step(tr2)
    assert state["optimizer_step"] == 2 and tr2.scaler.scale == 1.0
    part2 = [tr2.train_step(b["tokens"], b["labels"])["loss"]
             for b in bs[2:]]
    tr2.close()
    tr2.tracker.assert_quiescent()
    np.testing.assert_allclose(straight, part1 + part2, atol=1e-6)

    jtr = JTrainer(units, jax_memascend(str(tmp_path / "j"), lr=1e-3,
                                        compute_dtype="float32"))
    try:
        ref = [jtr.train_step(b["tokens"], b["labels"])["loss"]
               for b in _resume_batches(4, JLoader, JDataset)]
    finally:
        jtr.close()
    np.testing.assert_allclose(straight, ref, rtol=1e-5)


@pytest.mark.parametrize("seed,index,count", [(0, 0, 1), (5, 0, 1),
                                              (123, 1, 2)])
def test_synthetic_batches_match_reference(seed, index, count):
    kw = dict(batch=3, seq_len=48, process_index=index, process_count=count)
    port = DataLoader(SyntheticTextDataset(vocab=256, seed=seed), **kw)
    ref = JLoader(JDataset(vocab=256, seed=seed), **kw)
    for _ in range(4):
        got, want = port.next_batch(), ref.next_batch()
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(port.ds.doc(7), ref.ds.doc(7))
