"""Dry run: what one step of (arch, shape) costs and needs on one card,
or on each card of a production mesh, with nothing allocated.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each step against a 256- or 512-chip mesh of placeholder
devices; this runs the step itself on the meta device
(:func:`repro_torch.models.build` with ``device="meta"``:
every tensor has its shape and dtype and no storage, and no kernel runs)
under one ``TorchDispatchMode`` that sees every aten op the step
dispatches:

* ``flops`` — ``torch.utils.flop_counter``'s formulas for matmul,
  convolution and attention ops, plus one an output element of each
  pointwise op (XLA's convention; a reduction counts one an input
  element, a softmax four and its backward four);
* ``transcendentals`` — one an element of exp, log, tanh, sigmoid, erf,
  sqrt, rsqrt, pow and the like, which count here instead of a flop, as in
  XLA's cost analysis;
* ``bytes accessed`` — input plus output bytes of each op that is not a
  view or an alias.  An eager op is its own kernel, so this is the eager
  program's traffic, op by op: it is not XLA's count over fused kernels,
  and is higher wherever XLA would fuse a chain of elementwise ops;
* the port's hand-written kernels (:mod:`repro_torch.kernels.ops`) charge
  their own formulas through their meta branches, never the plain
  version's ops.

Memory, in the reference's ``memory_analysis`` fields:

* ``argument_size_in_bytes`` — params, batch (and loss scale) or params,
  cache, tokens and length: exact;
* ``output_size_in_bytes`` — the step's outputs;
* ``temp_size_in_bytes`` — the peak of the live bytes of the tensors the
  step creates (each storage from the op that makes it to its release,
  views and aliases counted once), less the outputs: so argument + temp +
  output is the step's predicted peak on the card.

An eager counter sees every op that runs, loops unrolled, so nothing needs
the reference's 1- and 2-group calibration (``"calibrated": false``), and
one card moves no collective bytes.

**The production meshes.**  ``lower_pair(..., mesh="pod")`` (16x16, 256
ranks) or ``"multipod"`` (2x16x16, 512) runs the same step inside a
``"fake"`` process group of that size (:func:`repro_torch.launch.mesh.
fake_process_group`) on DTensors whose local tensors are this rank's meta
shards, placed by :mod:`repro_torch.launch.sharding` (params ZeRO-3 for
train and prefill, ``serve_param_mode`` for decode).  The counter lets
each DTensor op pass to DTensor (its sharding propagation's fake-tensor
shape checks are not counted) and counts the local ops and the
``_c10d_functional`` collectives DTensor issues on rank 0, so every
number is what rank 0 holds and does: the local shards' argument, temp
and output bytes, its flops and bytes, and the collectives by the
reference's kinds, each one's result bytes (what XLA's partitioned HLO
shows per device).  ``wait_tensor`` is not counted.  The collective
schedule is the port's (:mod:`repro_torch.models.dist`: each weight
gathered over the batch axes where a layer uses it, row-parallel sums
all-reduced) and PyTorch's partitioner's elsewhere, not XLA's, so its
counts are not the reference's.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force] \
      [--mesh h100|pod|multipod|both] [--serve-param-mode zero3|tp] \
      [--act-hint]

Records are JSON files under ``build/dryrun_torch/<mesh>/`` (resumable;
``--force`` redoes them); ``python -m repro_torch.launch.roofline
[--mesh ...]`` tabulates them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import build, shape_supported, variant_for_shape
from repro_torch.models.registry import param_shapes
from repro_torch.serve.decode import build_serve_step
from repro_torch.train.step import (build_prefill_step, build_train_step,
                                    make_act_hint, tree_leaves, tree_map)
from . import mesh as mesh_mod
from . import sharding as shd

# records go to OUT_DIR/<mesh>/: h100 (one card), pod, multipod
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_torch")
# production mesh name -> multi_pod (its world size is the mesh's)
MESHES = {"pod": False, "multipod": True}
# a record whose step runs longer than this is written as an error
BUDGET_S = 600.0

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# the functional collectives DTensor issues, by the reference's kinds
# (wait_tensor and the autograd wrapper move nothing)
_C10D_KINDS = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_to_all_single": "all-to-all"}

aten = torch.ops.aten
_TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.log10, aten.tanh, aten.sigmoid, aten.erf, aten.erfc, aten.erfinv,
    aten.sqrt, aten.rsqrt, aten.pow, aten.sin, aten.cos, aten.tan,
    aten.atan, aten.atan2, aten.softplus, aten.logit, aten.silu, aten.gelu,
}
_REDUCTION = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.prod, aten.logsumexp, aten.any, aten.all, aten.norm,
    aten.linalg_vector_norm, aten.var, aten.var_mean, aten.std,
    aten.cumsum, aten.cumprod, aten.argmax, aten.argmin,
}
_SOFTMAX = {aten._softmax, aten._log_softmax, aten._softmax_backward_data,
            aten._log_softmax_backward_data}
# factories that write nothing: no traffic
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.lift_fresh}


class DryRunTimeout(RuntimeError):
    """The step ran past the dry run's time budget."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _numel(tensors) -> int:
    return sum(t.numel() for t in tensors)


class StepCounter(TorchDispatchMode):
    """Counts flops, transcendentals and bytes over the aten ops it sees,
    and tracks the live bytes of the storages they create.

    ``kernel(name, ...)`` is the hook of :mod:`repro_torch.kernels.ops`'s
    meta branches: it charges the kernel's own counts and stops counting
    ops (not memory) while the branch makes its outputs."""

    def __init__(self, budget_s: float | None = None) -> None:
        super().__init__()
        self.cost = Counter()
        # result bytes and counts of the collectives, by kind
        self.coll_bytes = Counter({k: 0 for k in _COLLECTIVES})
        self.coll_counts = Counter({k: 0 for k in _COLLECTIVES})
        # flops by matmul / pointwise / reduction / kernel
        self.flops_by = Counter()
        self.kernels: dict = {}
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._paused = 0
        self._deadline = None if budget_s is None else \
            time.perf_counter() + budget_s

    # -- memory ------------------------------------------------------------

    def _release(self, key: int, n: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def _track(self, outs, ins) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue        # a view, an alias or an in-place result
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key, n)
            seen.add(key)

    def created_bytes(self, tensors) -> int:
        """Bytes of the distinct storages among ``tensors`` that the step
        created (not the arguments')."""
        keys = {t.untyped_storage()._cdata for t in tensors}
        return sum(self._storages.get(k, 0) for k in keys)

    # -- cost --------------------------------------------------------------

    def kernel(self, name: str, *, flops: int, transcendentals: int,
               nbytes: int):
        rec = self.kernels.setdefault(name, Counter())
        rec["launches"] += 1
        rec["flops"] += flops
        rec["transcendentals"] += transcendentals
        rec["bytes accessed"] += nbytes
        self.cost["flops"] += flops
        self.cost["transcendentals"] += transcendentals
        self.cost["bytes accessed"] += nbytes
        self.flops_by["kernel"] += flops
        return self._pause()

    @contextlib.contextmanager
    def _pause(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        packet = func.overloadpacket
        n_out = _numel(outs)
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.cost["flops"] += f
            self.flops_by["matmul"] += f
        elif packet in _SOFTMAX:
            self.cost["flops"] += 4 * n_out
            self.flops_by["reduction"] += 4 * n_out
            if packet in (aten._softmax, aten._log_softmax):
                self.cost["transcendentals"] += n_out
        elif packet in _REDUCTION:
            n_in = _numel(ins)
            self.cost["flops"] += n_in
            self.flops_by["reduction"] += n_in
        elif packet in _TRANSCENDENTAL:
            self.cost["transcendentals"] += n_out
        elif torch.Tag.pointwise in func.tags or (
                packet in (aten._to_copy, aten.copy_) and ins and outs
                and ins[0].dtype != outs[0].dtype):
            self.cost["flops"] += n_out
            self.flops_by["pointwise"] += n_out
        if packet not in _NO_TRAFFIC:
            self.cost["bytes accessed"] += sum(map(_nbytes, ins)) + \
                sum(map(_nbytes, outs))

    def collectives(self) -> dict:
        """The reference's ``collective_bytes`` record: result bytes and
        counts by kind, and their total."""
        return {"bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values())}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the op on the local shards (and its
            # collectives), each of which comes back through this mode
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out      # sharding propagation's shape check
        self._track(outs, ins)
        if func.namespace == "_c10d_functional":
            kind = _C10D_KINDS.get(func.overloadpacket.__name__)
            if kind is not None:
                self.coll_bytes[kind] += sum(map(_nbytes, outs))
                self.coll_counts[kind] += 1
            return out
        if self._paused or func.is_view:
            return out
        self.ops += 1
        self._count(func, args, kwargs, out, ins, outs)
        if self._deadline is not None and self.ops % 256 == 0 and \
                time.perf_counter() > self._deadline:
            raise DryRunTimeout(f"step ran past its budget after "
                                f"{self.ops} ops")
        return out


# ---------------------------------------------------------------------------
# One step on the meta device
# ---------------------------------------------------------------------------

def _meta(spec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _meta_tree(specs):
    if isinstance(specs, dict):
        return {k: _meta_tree(v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_meta_tree(v) for v in specs)
    return _meta(specs)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _bytes(tree) -> int:
    """Bytes this rank holds of a tree (a DTensor's local shard)."""
    return sum(_nbytes(_local(t)) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _step_args(impl, cfg: ModelConfig, shape: InputShape, params, mesh, *,
               check_overflow, serve_param_mode):
    """``(fn, args)`` of one step on the meta device: plain meta tensors
    on one card, or DTensors over this rank's meta shards on a mesh."""
    def place(tree, specs):
        if mesh is None:
            return _meta_tree(tree)
        return shd.meta_shards(specs(), tree, mesh)

    if mesh is not None:
        mode = serve_param_mode if shape.kind == "decode" else "zero3"
        params = shd.meta_shards(shd.param_specs(cfg, params, mesh,
                                                 mode=mode), params, mesh)
    if shape.kind == "decode":
        built = build_serve_step(impl, shape, mesh,
                                 param_mode=serve_param_mode)
        cache, tokens, length = built[-1]
        return built[0], (
            params, place(cache, lambda: shd.cache_specs(cfg, cache, mesh)),
            place(tokens, lambda: shd.tokens_spec(mesh, shape.global_batch)),
            _meta(length))
    batch_specs = impl.input_specs(shape)
    batch = place(batch_specs,
                  lambda: shd.batch_specs(cfg, batch_specs, mesh))
    if shape.kind == "train":
        built = build_train_step(impl, mesh, batch_shape=batch_specs,
                                 check_overflow=check_overflow)
        args = (params, batch,
                torch.empty((), dtype=torch.float32, device="meta"))
    else:
        built = build_prefill_step(impl, mesh, batch_shape=batch_specs)
        args = (params, batch)
    return (built if mesh is None else built[0]), args


def _lower_one(cfg: ModelConfig, shape: InputShape, mesh=None, *,
               check_overflow=True, remat=True, bf16_logits=False,
               device_params_bf16=False, serve_param_mode="zero3",
               act_hint=False, budget_s=None):
    """Run one step of ``cfg`` at ``shape`` on the meta device (over
    ``mesh``'s meta shards when one is given) under a
    :class:`StepCounter`; returns ``(counter, memory record, seconds)``."""
    hint = make_act_hint(mesh) if (act_hint and mesh is not None) else None
    impl = build(cfg, remat=remat, bf16_logits=bf16_logits, hint=hint,
                 device="meta")
    params = param_shapes(cfg)
    if device_params_bf16:
        # ZeRO-Infinity device weights are half precision (the fp32 master
        # lives on the host or the SSD)
        params = tree_map(lambda t: torch.empty_like(t, dtype=torch.bfloat16)
                          if t.dtype == torch.float32 else t, params)
    fn, args = _step_args(impl, cfg, shape, params, mesh,
                          check_overflow=check_overflow,
                          serve_param_mode=serve_param_mode)
    counter = StepCounter(budget_s)
    t0 = time.perf_counter()
    with counter, ops.dry_run_counter(counter):
        out = fn(*args)
        out_leaves = [_local(t) for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)]
        output = counter.created_bytes(out_leaves)
        peak = counter.peak
    seconds = time.perf_counter() - t0
    mem = {"argument_size_in_bytes": _bytes(args),
           "output_size_in_bytes": output,
           "temp_size_in_bytes": peak - output,
           "generated_code_size_in_bytes": 0,
           "alias_size_in_bytes": 0}
    del out, out_leaves
    return counter, mem, seconds


def _resolve(arch, shape):
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    return cfg, shape


def lower_pair(arch: str | ModelConfig, shape: str | InputShape,
               mesh=None, *, check_overflow=True, remat=True,
               bf16_logits=False, device_params_bf16=False,
               serve_param_mode: str = "zero3", act_hint: bool = False,
               budget_s: float | None = None):
    """Run one (arch, shape) step on the meta device; returns the record.

    ``arch`` is an arch name or a :class:`ModelConfig` (a depth-cut config
    counts at its own depth), ``shape`` an ``INPUT_SHAPES`` name or an
    :class:`InputShape`.  The record keeps the reference's keys.

    ``mesh``: None for one card — ``"mesh": "1"``,
    ``n_chips`` 1, all-zero collectives; ``"pod"`` / ``"multipod"`` for the
    production meshes, each run in a fake process group of its size
    opened and closed here; or a ``DeviceMesh`` over the caller's group.
    On a mesh every number is rank 0's.  ``serve_param_mode`` places a
    decode step's params (``"zero3"`` or ``"tp"``); ``act_hint`` applies
    :func:`repro_torch.train.step.make_act_hint`.  The record stays
    ``"calibrated": false``: the eager counter sees every layer.
    ``budget_s`` bounds the step's time (:class:`DryRunTimeout` past
    it)."""
    if isinstance(mesh, str):
        multi_pod = MESHES[mesh]
        world = math.prod(mesh_mod.MULTIPOD_SHAPE if multi_pod
                          else mesh_mod.POD_SHAPE)
        with mesh_mod.fake_process_group(world):
            return lower_pair(
                arch, shape, mesh_mod.make_production_mesh(
                    multi_pod=multi_pod, device_type="cpu"),
                check_overflow=check_overflow, remat=remat,
                bf16_logits=bf16_logits,
                device_params_bf16=device_params_bf16,
                serve_param_mode=serve_param_mode, act_hint=act_hint,
                budget_s=budget_s)
    base_cfg, shape = _resolve(arch, shape)
    ok, reason = shape_supported(base_cfg, shape)
    if not ok:
        return {"arch": base_cfg.name, "shape": shape.name,
                "status": "skipped", "reason": reason}
    cfg = variant_for_shape(base_cfg, shape)
    counter, mem, seconds = _lower_one(
        cfg, shape, mesh, check_overflow=check_overflow, remat=remat,
        bf16_logits=bf16_logits, device_params_bf16=device_params_bf16,
        serve_param_mode=serve_param_mode, act_hint=act_hint,
        budget_s=budget_s)
    cost = {k: float(counter.cost[k])
            for k in ("flops", "bytes accessed", "transcendentals")}
    coll = counter.collectives()
    rec = {
        "arch": base_cfg.name, "shape": shape.name, "status": "ok",
        "kind": shape.kind,
        "mesh": "1" if mesh is None else mesh_mod.mesh_name(mesh),
        "n_chips": 1 if mesh is None else mesh.size(),
        "sliding_window": cfg.sliding_window,
        "params_total": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
        "lower_seconds": round(seconds, 2),
        "compile_seconds": 0.0,
        "memory": mem,
        "cost_raw": cost,
        "collectives_raw": coll,
        "cost": cost,
        "collectives": coll,
        "calibrated": False,
        "flops_by": {k: float(v) for k, v in counter.flops_by.items()},
        "kernels": {k: dict(v) for k, v in counter.kernels.items()},
        "ops": counter.ops,
        "n_layers": cfg.n_layers,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
    }
    if mesh is not None and shape.kind == "decode":
        rec["serve_param_mode"] = serve_param_mode
    if mesh is not None:
        rec["act_hint"] = act_hint
    return rec


def run_all(archs, shapes, out_dir: str, *, mesh: str | None = None,
            force: bool = False, budget_s: float = BUDGET_S,
            serve_param_mode: str = "zero3", act_hint: bool = False) -> None:
    """One record a pair under ``out_dir`` (``mesh`` as :func:`lower_pair`
    takes it by name)."""
    os.makedirs(out_dir, exist_ok=True)
    for arch in archs:
        for shape_name in shapes:
            path = os.path.join(out_dir,
                                f"{arch}__{shape_name}.json".replace("/", "_"))
            if os.path.exists(path) and not force:
                print(f"[cached] {arch} {shape_name}")
                continue
            print(f"[dryrun] {mesh or 'h100'} {arch} {shape_name} ...",
                  flush=True)
            t0 = time.perf_counter()
            try:
                rec = lower_pair(arch, shape_name, mesh, budget_s=budget_s,
                                 serve_param_mode=serve_param_mode,
                                 act_hint=act_hint)
            except Exception as e:  # a failure here is a real bug
                rec = {"arch": arch, "shape": shape_name, "status": "error",
                       "error": repr(e), "seconds": round(
                           time.perf_counter() - t0, 2),
                       "traceback": traceback.format_exc()}
                print(f"  ERROR: {e}")
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            if rec["status"] == "ok":
                print(f"  ok: {rec['lower_seconds']}s "
                      f"flops={rec['cost']['flops']:.3e} "
                      f"bytes={rec['cost']['bytes accessed']:.3e} "
                      f"temp={rec['memory']['temp_size_in_bytes']:.3e}B "
                      f"coll={rec['collectives']['total_bytes']:.3e}B")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mesh", default="h100",
                    choices=["h100", "pod", "multipod", "both"])
    ap.add_argument("--serve-param-mode", default="zero3",
                    choices=["zero3", "tp"])
    ap.add_argument("--act-hint", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args()
    if not args.all and args.arch is None and args.shape is None:
        ap.error("give --arch and/or --shape, or --all")
    archs = list(ARCHS) if args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape is None else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    for name in meshes:
        run_all(archs, shapes, os.path.join(args.out, name),
                mesh=None if name == "h100" else name, force=args.force,
                serve_param_mode=args.serve_param_mode,
                act_hint=args.act_hint)


if __name__ == "__main__":
    main()
