"""One-card dry run: what one step of (arch, shape) costs and needs on the
card, with nothing allocated.

Port of ``src/repro/launch/dryrun.py`` for one card.  The reference
lowers and compiles each step against a 256- or 512-chip mesh of
placeholder devices; one card has no mesh, so this runs the step itself on
the meta device (:func:`repro_torch.models.build` with ``device="meta"``:
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

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]

Records are JSON files under ``build/dryrun_torch/h100/`` (resumable;
``--force`` redoes them); ``python -m repro_torch.launch.roofline``
tabulates them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import build, shape_supported, variant_for_shape
from repro_torch.serve.decode import build_serve_step
from repro_torch.train.step import (build_prefill_step, build_train_step,
                                    tree_leaves, tree_map)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_torch", "h100")
# a record whose step runs longer than this is written as an error
BUDGET_S = 600.0

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self._track(outs, ins)
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


def _bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree))


def _lower_one(cfg: ModelConfig, shape: InputShape, *, check_overflow=True,
               remat=True, bf16_logits=False, device_params_bf16=False,
               budget_s=None):
    """Run one step of ``cfg`` at ``shape`` on the meta device under a
    :class:`StepCounter`; returns ``(counter, memory record, seconds)``."""
    impl = build(cfg, remat=remat, bf16_logits=bf16_logits, device="meta")
    params = impl.init_params(0)
    if device_params_bf16:
        # ZeRO-Infinity device weights are half precision (the fp32 master
        # lives on the host or the SSD)
        params = tree_map(lambda t: torch.empty_like(t, dtype=torch.bfloat16)
                          if t.dtype == torch.float32 else t, params)
    if shape.kind == "decode":
        serve, (cache_specs, tok_spec, len_spec) = build_serve_step(impl,
                                                                    shape)
        args = (params, _meta_tree(cache_specs), _meta(tok_spec),
                _meta(len_spec))
        fn = serve
    else:
        batch = _meta_tree(impl.input_specs(shape))
        if shape.kind == "train":
            fn = build_train_step(impl, check_overflow=check_overflow)
            args = (params, batch,
                    torch.empty((), dtype=torch.float32, device="meta"))
        else:
            fn = build_prefill_step(impl)
            args = (params, batch)
    counter = StepCounter(budget_s)
    t0 = time.perf_counter()
    with counter, ops.dry_run_counter(counter):
        out = fn(*args)
        out_leaves = tree_leaves(out)
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


def lower_pair(arch: str | ModelConfig, shape: str | InputShape, *,
               check_overflow=True, remat=True, bf16_logits=False,
               device_params_bf16=False, budget_s: float | None = None):
    """Run one (arch, shape) step on the meta device; returns the record.

    ``arch`` is an arch name or a :class:`ModelConfig` (a depth-cut config
    counts at its own depth), ``shape`` an ``INPUT_SHAPES`` name or an
    :class:`InputShape`.  The record keeps the reference's keys, for one
    card: ``"mesh": "1"``, ``n_chips`` 1, all-zero collectives and
    ``"calibrated": false``.  ``budget_s`` bounds the step's time
    (:class:`DryRunTimeout` past it)."""
    base_cfg, shape = _resolve(arch, shape)
    ok, reason = shape_supported(base_cfg, shape)
    if not ok:
        return {"arch": base_cfg.name, "shape": shape.name,
                "status": "skipped", "reason": reason}
    cfg = variant_for_shape(base_cfg, shape)
    counter, mem, seconds = _lower_one(
        cfg, shape, check_overflow=check_overflow, remat=remat,
        bf16_logits=bf16_logits, device_params_bf16=device_params_bf16,
        budget_s=budget_s)
    cost = {k: float(counter.cost[k])
            for k in ("flops", "bytes accessed", "transcendentals")}
    coll = {"bytes": {k: 0 for k in _COLLECTIVES},
            "counts": {k: 0 for k in _COLLECTIVES}, "total_bytes": 0}
    return {
        "arch": base_cfg.name, "shape": shape.name, "status": "ok",
        "kind": shape.kind,
        "mesh": "1",
        "n_chips": 1,
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


def run_all(archs, shapes, out_dir: str, *, force: bool = False,
            budget_s: float = BUDGET_S) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for arch in archs:
        for shape_name in shapes:
            path = os.path.join(out_dir,
                                f"{arch}__{shape_name}.json".replace("/", "_"))
            if os.path.exists(path) and not force:
                print(f"[cached] {arch} {shape_name}")
                continue
            print(f"[dryrun] {arch} {shape_name} ...", flush=True)
            t0 = time.perf_counter()
            try:
                rec = lower_pair(arch, shape_name, budget_s=budget_s)
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
                      f"temp={rec['memory']['temp_size_in_bytes']:.3e}B")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args()
    if not args.all and args.arch is None and args.shape is None:
        ap.error("give --arch and/or --shape, or --all")
    archs = list(ARCHS) if args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape is None else [args.shape]
    run_all(archs, shapes, args.out, force=args.force)


if __name__ == "__main__":
    main()
