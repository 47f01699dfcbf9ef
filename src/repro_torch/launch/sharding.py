"""Sharding rules: parameter / batch / cache specs per architecture, as
DTensor placements.

Port of ``src/repro/launch/sharding.py``.  ZeRO-3-flavored layout: every
weight is sharded over BOTH the ``data`` axis (stage-3 parameter
partitioning: DTensor's sharding propagation all-gathers each weight
where it is used, the per-layer all-gather ZeRO-Infinity performs
explicitly, paper Fig. 1) and the ``model`` axis (tensor parallelism:
column/row splits, vocab-sharded embeddings, expert parallelism for MoE
stacks).

All assignments are divisibility-gated: a dim is only sharded by an axis
(set) whose total size divides it — whisper's 6 heads or MQA's single KV
head simply stay replicated on that dim.

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: ``None``, an axis name, or a tuple of axis names.
:func:`to_placements` turns it into one placement per mesh dim: a tensor
dim sharded over an axis tuple gets ``Shard(d)`` on each of those mesh
dims.  Every tuple the rules choose is in mesh order (("pod", "data"),
("data", "model")), so the major axis splits first, as in the reference,
and no strided shard is needed.

Trees are the port's dicts, lists and tuples; a path is the tuple of the
dict keys and sequence indices down to a leaf.  Leaves are tensors or
anything with a ``.shape`` (:class:`repro_torch.models.registry.TensorSpec`).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from .mesh import batch_axes


# ---------------------------------------------------------------------------
# generic machinery
# ---------------------------------------------------------------------------

def _names(cand) -> tuple:
    return cand if isinstance(cand, tuple) else (cand,)


def _axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))


def greedy_spec(mesh, shape, dim_prefs) -> tuple:
    """Assign each dim the first candidate axis(es) that divide it, without
    reusing any mesh axis across dims."""
    sizes = _axis_sizes(mesh)
    used: set[str] = set()
    parts = []
    for dim, prefs in zip(shape, dim_prefs, strict=False):
        chosen = None
        for cand in prefs or ():
            names = _names(cand)
            if any(n not in sizes or n in used for n in names):
                continue
            if dim % math.prod(sizes[n] for n in names) == 0:
                chosen = cand
                used.update(names)
                break
        parts.append(chosen)
    return tuple(parts)


def to_placements(spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    entry names that mesh dim, ``Replicate()`` elsewhere."""
    axes = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in axes]
    for d, part in enumerate(spec):
        if part is None:
            continue
        idx = [axes.index(n) for n in _names(part)]
        assert idx == sorted(idx), \
            f"axis tuple {part} is not in mesh order {axes}"
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """The shard of ``shape`` one rank holds under ``spec`` (every sharded
    dim divides, as :func:`greedy_spec` gates it)."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for d, part in enumerate(spec):
        if part is not None:
            out[d] //= math.prod(sizes[n] for n in _names(part))
    return tuple(out)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def spec_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (whose leaves are tuples)
    and trees of the same structure, in the first tree's key order."""
    if isinstance(specs, dict):
        return {k: spec_map(fn, specs[k], *(t[k] for t in trees))
                for k in (trees[0] if trees else specs)}
    if isinstance(specs, list) or (isinstance(specs, tuple) and specs
                                   and isinstance(specs[0], (dict, list))):
        return type(specs)(spec_map(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(specs))
    return fn(specs, *trees)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

_COL_SUFFIXES = (  # (in, out) weights split column-wise: out -> model
    "attn.w_q", "attn.w_k", "attn.w_v", "attn.w_dq", "attn.w_uq",
    "attn.w_dkv", "attn.w_ukv", "xattn.w_q", "xattn.w_k", "xattn.w_v",
    "ffn.w_up", "ffn.w_gate", "ssm.w_in_x", "ssm.w_in_z", "ssm.w_dt_in",
    "ssm.w_b", "ssm.w_c", "ssm.w_dt",
    "mlstm.w_q", "mlstm.w_k", "mlstm.w_v", "mlstm.w_gates", "slstm.w_x",
    "moe.w_router", "moe.shared_up", "moe.shared_gate", "mtp_proj",
)
_ROW_SUFFIXES = (  # (in, out) weights split row-wise: in -> model
    "attn.w_o", "xattn.w_o", "ffn.w_down", "ssm.w_out", "mlstm.w_o",
    "slstm.w_o", "moe.shared_down",
)


def _param_dim_prefs(key: str, ndim: int, stacked: bool):
    """Dim preferences for one parameter leaf (before group-stack prefix).

    Each dim gets an ordered candidate list of axis names / axis tuples.
    """
    if key == "embed":
        prefs = [["model"], ["data"]]          # (vocab, d)
    elif key == "head":
        prefs = [["data"], ["model"]]          # (d, vocab)
    elif key in ("moe.w_up", "moe.w_gate"):
        prefs = [["model"], ["data"], []]      # (E, d, F): expert parallel
    elif key == "moe.w_down":
        prefs = [["model"], [], ["data"]]      # (E, F, d)
    elif key == "ssm.conv_w":
        prefs = [[], ["model"]]                # (K, di)
    elif key == "ssm.a_log":
        prefs = [["model"], []]                # (di, ds)
    elif key == "slstm.r":
        prefs = [["model"], [], []]            # (H, hd, 4hd)
    elif key in _COL_SUFFIXES:
        prefs = [["data"], ["model"]]
    elif key in _ROW_SUFFIXES:
        prefs = [["model"], ["data"]]
    elif ndim == 1:
        prefs = [[]]                           # norms, biases: replicated
    elif ndim == 2:
        prefs = [["data"], ["model"]]          # default column split
    else:
        prefs = [[] for _ in range(ndim)]
    if stacked:
        prefs = [[]] + prefs                   # leading group axis: replicated
    return prefs


def _leaf_key(path) -> str:
    """Last string key on a tree path ('attn.w_q', 'embed', ...)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _is_stacked(path) -> bool:
    """A leaf under ``groups`` (period-stacked layers) or whisper's
    ``enc_layers`` / ``dec_layers`` (layer-stacked) has a leading stack
    axis."""
    return any(e in ("groups", "enc_layers", "dec_layers") for e in path
               if isinstance(e, str))


def param_specs(cfg: ModelConfig, params_shape, mesh, *,
                mode: str = "zero3"):
    """Spec tree for a params tree (tensors, meta tensors or TensorSpecs).

    mode="zero3" (training default): weights sharded over BOTH data (ZeRO-3
    stage-3 partitioning) and model (tensor parallel) — DTensor all-gathers
    per use, ZeRO-Infinity's schedule.

    mode="tp" (serving): weights sharded over the model axis only and
    REPLICATED across data.  Decode runs the same weight matmul every
    step; gathering a ZeRO-3 shard per token makes every decode step
    collective-bound.  TP-only costs (data_parallel-1)x more HBM for
    weights but removes the per-token parameter all-gather.
    """
    if mode not in ("zero3", "tp"):
        raise ValueError(f"unknown param mode {mode!r}")

    def spec_for(path, leaf):
        key = _leaf_key(path)
        stacked = _is_stacked(path)
        ndim = len(leaf.shape) - (1 if stacked else 0)
        prefs = _param_dim_prefs(key, ndim, stacked)
        if mode == "tp":
            prefs = [[c for c in dim_prefs
                      if "data" not in _names(c) and "pod" not in _names(c)]
                     for dim_prefs in prefs]
        return greedy_spec(mesh, leaf.shape, prefs)

    return tree_map_with_path(spec_for, params_shape)


# ---------------------------------------------------------------------------
# batches (train / prefill)
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, batch_shape, mesh):
    """Shard the global batch over ("pod","data"); seq stays unsharded for
    training (attention needs full-sequence locality per shard)."""
    dp = batch_axes(mesh)

    def spec_for(path, leaf):
        prefs = [[dp]] + [[] for _ in leaf.shape[1:]]
        return greedy_spec(mesh, leaf.shape, prefs)

    return tree_map_with_path(spec_for, batch_shape)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, cache_shape, mesh):
    """Decode-state sharding.

    KV-ish caches (ndim>=3 with a seq dim): batch -> ("pod","data"), seq ->
    "model".  Recurrent states: batch -> dp, then the largest inner dim ->
    "model".  When batch=1 (long_500k) the batch dim is unshardable and
    inner dims pick up ("data","model") combos instead.
    """
    dp = batch_axes(mesh)

    def spec_for(path, leaf):
        shape = leaf.shape
        stacked = _is_stacked_cache(path, shape)
        dims = shape[1:] if stacked else shape
        key = _leaf_key(path)
        if key in ("k", "v", "xk", "xv", "ckv"):
            prefs = [[dp, ("data",)], [("model",), ("data", "model")]] + \
                [[] for _ in dims[2:]]
        elif key == "conv":
            prefs = [[dp, ("data",)], [], [("model",), ("data", "model")]]
        elif key == "ssm":
            prefs = [[dp, ("data",)], [("model",), ("data", "model")], []]
        elif key in ("c",):      # mlstm matrix state (B, H, dk, dv)
            prefs = [[dp, ("data",)], [("model",)],
                     [("data", "model"), ("model",)], []]
        elif key in ("n", "h"):
            prefs = [[dp, ("data",)], [("model",)],
                     [("data", "model"), ("model",)]]
        else:
            prefs = [[dp]] + [[] for _ in dims[1:]]
        prefs = prefs[:len(dims)] + [[] for _ in range(len(dims) - len(prefs))]
        if stacked:
            prefs = [[]] + prefs
        return greedy_spec(mesh, shape, prefs)

    return tree_map_with_path(spec_for, cache_shape)


def _is_stacked_cache(path, shape) -> bool:
    """Transformer caches are tuples of group-stacked dicts (a sequence
    index on the path); whisper's are layer-stacked 5-dim K/V."""
    for entry in path:
        if isinstance(entry, int):
            return True
        if entry in ("k", "v", "xk", "xv") and len(shape) == 5:
            return True
    return False


def logits_spec(cfg: ModelConfig, mesh, global_batch: int) -> tuple:
    sizes = _axis_sizes(mesh)
    dp = batch_axes(mesh)
    dp_size = math.prod(sizes[a] for a in dp)
    batch_part = dp if global_batch % dp_size == 0 else None
    vocab_ok = cfg.vocab % sizes["model"] == 0
    return (batch_part, None, "model" if vocab_ok else None)


def tokens_spec(mesh, global_batch: int) -> tuple:
    """Decode tokens (B, T): the batch over ("pod","data") when it
    divides, else replicated."""
    sizes = _axis_sizes(mesh)
    dp = batch_axes(mesh)
    dp_size = math.prod(sizes[a] for a in dp)
    return (dp if global_batch % dp_size == 0 else None, None)


# ---------------------------------------------------------------------------
# spec trees -> placement trees -> DTensors
# ---------------------------------------------------------------------------

def placements_tree(specs, mesh):
    """The placement tree of a spec tree (the ``*_shardings`` wrappers'
    counterpart: one tuple of placements per leaf)."""
    return spec_map(lambda s: to_placements(s, mesh), specs)


def place(tree, placements, mesh):
    """Each plain tensor of ``tree`` placed by its placements (every rank
    holding the same full value, as a jitted step's inputs); DTensors and
    anything else pass as they are."""
    from torch.distributed.tensor import distribute_tensor

    def one(pl, t):
        if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
            return distribute_tensor(t, mesh, pl)
        return t
    return spec_map(one, placements, tree)


def distribute_params(tree, cfg: ModelConfig, mesh, mode: str = "zero3"):
    """A full params tree placed by :func:`param_specs`."""
    return place(tree, placements_tree(param_specs(cfg, tree, mesh,
                                                   mode=mode), mesh), mesh)


def param_placements(cfg: ModelConfig, mesh, mode: str = "zero3"):
    """The placement tree of ``cfg``'s parameters under ``mode``."""
    from repro_torch.models.registry import param_shapes
    return placements_tree(param_specs(cfg, param_shapes(cfg), mesh,
                                       mode=mode), mesh)


def replicated(mesh) -> tuple:
    """The placements of a value every rank holds whole."""
    return (Replicate(),) * mesh.ndim


def as_placed(t, mesh, placements):
    """A step's result ``t`` in ``placements``: a DTensor redistributed,
    a plain tensor (one every rank computed whole) placed as replicated
    first."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, replicated(mesh), run_check=False)
    return t.redistribute(mesh, placements)


def meta_shards(specs_tree, shapes, mesh):
    """DTensors over meta local shards: each leaf of ``shapes`` (a tensor
    or a TensorSpec) becomes a DTensor of its global shape and dtype whose
    local tensor is this rank's shard on the meta device.  No memory, no
    collective: what the dry run lowers against."""
    def one(spec, leaf):
        local = torch.empty(local_shape(leaf.shape, spec, mesh),
                            dtype=leaf.dtype, device="meta")
        shape = torch.Size(leaf.shape)
        return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))
    return spec_map(one, specs_tree, shapes)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def full_tree(tree):
    """Every DTensor of a tree of dicts, lists and tuples gathered to its
    full tensor (anything else passes through)."""
    return tree_map_with_path(
        lambda _p, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
