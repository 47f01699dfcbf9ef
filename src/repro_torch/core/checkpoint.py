"""Checkpointing: save/restore parameter trees through a TensorStore.

Port of ``src/repro/core/checkpoint.py``.  In a MemAscend deployment the SSD
store already holds the authoritative training state (fp32 masters +
optimizer moments, updated in place every step), so checkpointing is a
*manifest* plus optional export, not a copy of device memory:

* :func:`save_pytree` / :func:`load_pytree` — write/read a tree of nested
  dicts, lists and tuples whose leaves are numpy arrays or torch tensors
  through a store.  Keys derive from tree paths and the manifest (shapes,
  dtypes) is stored alongside, in the reference's layout byte for byte: dict
  keys are walked in sorted order, as ``jax.tree_util`` walks them, so each
  package reads what the other wrote;
* :func:`snapshot_trainer` / :func:`restore_trainer_step` — persist the
  trainer's scalar state (step count, loss scale) so a run can resume
  against its existing store.

bf16 leaves are stored as their 16-bit payload under the manifest dtype
``"bfloat16"``, as the reference writes them; on the way back they become
torch bf16 tensors or ``uint16`` bit arrays (:mod:`repro_torch.core.dtypes`),
never ``ml_dtypes`` arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .dtypes import BF16_HOST, to_host, to_torch
from .nvme import TensorStore

MANIFEST_KEY = "__manifest__"


def _flatten(tree, path=()) -> list[tuple[tuple, object]]:
    """(path, leaf) pairs in ``jax.tree_util`` order: dict keys sorted,
    sequences by index, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _flatten(tree[key], (*path, key))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, sub in enumerate(tree)
                for pair in _flatten(sub, (*path, i))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are taken from the
    iterator ``leaves`` in :func:`_flatten` order."""
    if like is None:
        return None
    if isinstance(like, dict):
        built = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: built[key] for key in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _path_key(path) -> str:
    return "/".join(str(entry) for entry in path)


def _host_leaf(leaf) -> tuple[np.ndarray, str]:
    """The bytes to store and the manifest dtype of one leaf."""
    if isinstance(leaf, torch.Tensor):
        arr = to_host(leaf)
        return arr, ("bfloat16" if leaf.dtype == torch.bfloat16
                     else str(arr.dtype))
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # an ml_dtypes array
        return arr.view(BF16_HOST), "bfloat16"
    return arr, str(arr.dtype)


def _stored_nbytes(store: TensorStore, key: str) -> int:
    if hasattr(store, "_locations"):       # DirectNVMeEngine
        return sum(e.length for e in store._locations[key][2])
    return os.path.getsize(store._path(key))   # FilesystemEngine


def _read_json(store: TensorStore, key: str) -> dict:
    raw = store.read_new(key, np.uint8, (_stored_nbytes(store, key),))
    return json.loads(bytes(raw).decode())


def _write_json(store: TensorStore, key: str, obj: dict) -> None:
    store.write(key, np.frombuffer(json.dumps(obj).encode(),
                                   dtype=np.uint8).copy())


def save_pytree(store: TensorStore, prefix: str, tree) -> dict:
    """Write every leaf of ``tree`` to the store; returns the manifest."""
    manifest = {"leaves": {}}
    for path, leaf in _flatten(tree):
        arr, dtype = _host_leaf(leaf)
        store.write(f"{prefix}/{_path_key(path)}", arr)
        manifest["leaves"][_path_key(path)] = {
            "dtype": dtype, "shape": list(arr.shape)}
    _write_json(store, f"{prefix}/{MANIFEST_KEY}", manifest)
    return manifest


def load_manifest(store: TensorStore, prefix: str) -> dict:
    return _read_json(store, f"{prefix}/{MANIFEST_KEY}")


def load_pytree(store: TensorStore, prefix: str, like):
    """Read a tree previously saved with :func:`save_pytree` (by either
    package).

    ``like`` supplies the structure (any tree of the same shape; its leaf
    values are not read).  A leaf that is a ``torch.Tensor`` in ``like``
    comes back as a CPU tensor of the stored dtype, any other leaf as a
    numpy array — bf16 as ``uint16`` bits.
    """
    manifest = load_manifest(store, prefix)
    leaves = []
    for path, like_leaf in _flatten(like):
        meta = manifest["leaves"][_path_key(path)]
        bf16 = meta["dtype"] == "bfloat16"
        arr = store.read_new(f"{prefix}/{_path_key(path)}",
                             BF16_HOST if bf16 else np.dtype(meta["dtype"]),
                             tuple(meta["shape"]))
        if isinstance(like_leaf, torch.Tensor):
            leaves.append(to_torch(arr, torch.bfloat16) if bf16
                          else torch.from_numpy(arr))
        else:
            leaves.append(arr)
    return _unflatten(like, iter(leaves))


def _drain_pipeline(trainer) -> None:
    """Under full overlap an optimizer stage may still be streaming; the
    scalar state (step count) and the on-store masters are only coherent
    once it lands."""
    sync = getattr(trainer, "synchronize", None)
    if callable(sync):
        sync()


def snapshot_trainer(trainer, prefix: str = "ckpt") -> None:
    """Persist the trainer's scalar state; tensor state already lives on
    the store (masters/moments are updated in place each step)."""
    _drain_pipeline(trainer)
    _write_json(trainer.store, f"{prefix}/trainer_state", {
        "optimizer_step": trainer.optimizer.step_count,
        "loss_scale": trainer.scaler.scale,
        "n_overflows": trainer.scaler.n_overflows,
        "n_steps": trainer.scaler.n_steps,
    })


def restore_trainer_step(trainer, prefix: str = "ckpt") -> dict:
    """Load the scalar state :func:`snapshot_trainer` wrote back onto the
    trainer; returns it."""
    _drain_pipeline(trainer)
    state = _read_json(trainer.store, f"{prefix}/trainer_state")
    trainer.optimizer.step_count = state["optimizer_step"]
    trainer.scaler.scale = state["loss_scale"]
    trainer.scaler.n_overflows = state["n_overflows"]
    trainer.scaler.n_steps = state["n_steps"]
    return state
