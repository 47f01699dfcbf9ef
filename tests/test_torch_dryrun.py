"""The one-card dry run (``repro_torch.launch.dryrun``) held to the
reference's compiled step on the CPU.

The reference's dry-run module forces 512 placeholder devices at import,
so it is never imported here: its step is lowered directly with
``jax.jit(...).lower(...).compile()`` over ``build(cfg, unroll=True)``
(the layer scan unrolled, so XLA's cost analysis sees every layer), and
``cost_analysis()`` / ``memory_analysis()`` are read from that.  The
port's counts come from the step run on the meta device, at the same
reduced config, dtypes and batch (2 x 128).

FLOP bands, per family (counted / reference):

* dense, MoE, MLA and whisper: within 10 %.  The matmuls agree; the
  rest is the two conventions for elementwise work (XLA counts each op
  of its decompositions — a ``logsumexp``, a ``softplus``, a convert —
  where the eager counter sees one aten op).  Measured: 0.93-0.97.
* xLSTM: at or above the reference (at most 1.5x).  The reference's
  unrolled build still runs the mLSTM and sLSTM time scans as rolled
  ``lax.scan``s, whose bodies XLA counts once; the eager counter sees
  every step.  Measured: 1.28 train, 1.23 prefill.
* jamba: within 20 %, below the reference.  Both conventions pull here:
  the reference's Mamba chunk scan is a rolled ``lax.scan`` (counted
  once, an under-count), but its ``associative_scan`` lowers to slices,
  pads and interleaving adds that XLA counts as flops, and its softplus
  and converts decompose; the port's log-step scan is plain aten ops.
  The elementwise terms dominate at this width.  Measured: 0.845 train,
  0.900 prefill.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JShape
from repro.models import build as jax_build
from repro.train.step import grads_overflow_flag
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import StepCounter, lower_pair
from repro_torch.models import build
from repro_torch.models.layers import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.train.step import tree_leaves

torch.set_num_threads(2)

BATCH, SEQ = 2, 128
FAMILIES = {"dense": "qwen3-4b", "moe": "qwen3-30b-a3b",
            "mla": "deepseek-v3-671b", "jamba": "jamba-v0.1-52b",
            "xlstm": "xlstm-1.3b", "whisper": "whisper-tiny"}
# (low, high) of counted / reference flops; see the module docstring
BANDS = {"dense": (0.9, 1.1), "moe": (0.9, 1.1), "mla": (0.9, 1.1),
         "whisper": (0.9, 1.1), "xlstm": (1.0, 1.5), "jamba": (0.8, 1.0)}

_REF: dict = {}


def _reference(family: str, kind: str):
    """(flops, argument bytes) of the reference's compiled step."""
    key = (family, kind)
    if key not in _REF:
        cfg = jax_config(FAMILIES[family]).reduced()
        impl = jax_build(cfg, unroll=True)
        params = jax.eval_shape(impl.init_params, jax.random.PRNGKey(0))
        batch = impl.input_specs(JShape("t", SEQ, BATCH, kind))
        if kind == "train":
            def step(p, b, scale):
                def scaled(q):
                    return impl.loss_fn(q, b).astype(jnp.float32) * scale
                loss, grads = jax.value_and_grad(scaled)(p)
                return loss / scale, grads, grads_overflow_flag(grads)
            lowered = jax.jit(step).lower(
                params, batch, jax.ShapeDtypeStruct((), jnp.float32))
        else:
            # keep_unused: the port's record counts every argument, the
            # labels and an MTP head the prefill does not read included
            lowered = jax.jit(impl.prefill_fn, keep_unused=True).lower(
                params, batch)
        compiled = lowered.compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        _REF[key] = (cost["flops"],
                     compiled.memory_analysis().argument_size_in_bytes)
    return _REF[key]


_PORT: dict = {}


def _port(family: str, kind: str, **kw) -> dict:
    key = (family, kind, tuple(sorted(kw.items())))
    if key not in _PORT:
        _PORT[key] = lower_pair(get_config(FAMILIES[family]).reduced(),
                                InputShape("t", SEQ, BATCH, kind), **kw)
    return _PORT[key]


# -- the meta device and the allocation-free tree ------------------------------

def test_resolve_device_takes_meta_and_nothing_new():
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("xpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            resolve_device("cuda")


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [type(tree).__name__] + [_layout(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_tree_matches_the_drawn_tree(arch):
    """The meta tree has the CPU tree's structure, shapes and dtypes, and
    no storage."""
    cfg = get_config(arch).reduced()
    meta = build(cfg, device="meta").init_params(0)
    cpu = build(cfg, device="cpu").init_params(0)
    assert _layout(meta) == _layout(cpu)
    assert all(t.is_meta for t in tree_leaves(meta))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-32b"])
def test_meta_tree_in_bf16_at_full_width_is_instant(arch):
    """A full-width tree on meta (qwen3-4b: 4.0e9 parameters) takes no
    memory and matches the config's parameter count (which leaves out the
    qk-norm vectors: 11,776 of qwen3-4b's)."""
    cfg = get_config(arch)
    tree = init_params(0, cfg, torch.bfloat16, device="meta")
    leaves = tree_leaves(tree)
    assert all(t.is_meta and t.dtype == torch.bfloat16 for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert abs(n - cfg.param_count()) <= 1e-5 * n


# -- the step against the reference's compiled step ----------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_argument_bytes_equal_the_reference(family, kind):
    assert _port(family, kind)["memory"]["argument_size_in_bytes"] == \
        _reference(family, kind)[1]


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_counted_flops_held_to_the_reference(family, kind):
    ref = _reference(family, kind)[0]
    ratio = _port(family, kind)["cost"]["flops"] / ref
    lo, hi = BANDS[family]
    assert lo <= ratio <= hi, f"{family} {kind}: {ratio:.4f} of {ref:.4e}"


def _dense_matmul_flops(cfg, b: int, s: int) -> tuple[int, int]:
    """Forward matmul flops of the dense decoder at (b, s), (layers,
    head): the q/k/v/o projections, QK^T and PV over the full
    (materialized) score matrix, the gated MLP's three products, and the
    (tied) head."""
    t = b * s
    per_layer = 2 * t * cfg.d_model * (2 * cfg.q_dim + 2 * cfg.kv_dim) \
        + 2 * 2 * b * cfg.n_heads * s * s * cfg.head_dim \
        + 3 * 2 * t * cfg.d_model * cfg.d_ff
    return cfg.n_layers * per_layer, 2 * t * cfg.d_model * cfg.vocab


def test_dense_matmul_flops_equal_the_analytic_count():
    """Prefill: layers + head once.  Train: the forward, two products
    (input and weight grads) a forward product in backward, and the remat
    recompute of every layer group but its last product: non-reentrant
    ``torch.utils.checkpoint`` stops recomputing once every tensor the
    backward saved is back, and nothing in the group saves the down
    projection's output."""
    cfg = get_config("qwen3-4b").reduced()
    layers, head = _dense_matmul_flops(cfg, BATCH, SEQ)
    down = 2 * BATCH * SEQ * cfg.d_ff * cfg.d_model
    assert _port("dense", "prefill")["flops_by"]["matmul"] == layers + head
    assert _port("dense", "train")["flops_by"]["matmul"] == \
        4 * layers - cfg.n_layers * down + 3 * head


def test_remat_lowers_temp():
    with_remat = _port("dense", "train", remat=True)["memory"]
    without = _port("dense", "train", remat=False)["memory"]
    assert with_remat["temp_size_in_bytes"] < without["temp_size_in_bytes"]
    assert with_remat["argument_size_in_bytes"] == \
        without["argument_size_in_bytes"]


def test_train_step_charges_one_screen_a_gradient_leaf():
    rec = _port("dense", "train")
    cfg = get_config("qwen3-4b").reduced()
    leaves = tree_leaves(build(cfg, device="meta").init_params(0))
    screen = rec["kernels"]["overflow_check"]
    assert screen["launches"] == len(leaves)
    assert screen["bytes accessed"] == sum(
        4 * t.numel() + 4 for t in leaves)
    assert rec["memory"]["output_size_in_bytes"] == \
        sum(4 * t.numel() for t in leaves) + 4 + 1   # grads, loss, flag


def test_decode_record_keeps_the_reference_keys():
    """The record's keys are the reference's, for one card."""
    rec = lower_pair(get_config("qwen3-4b").reduced(),
                     InputShape("d", SEQ, BATCH, "decode"))
    ref_keys = {"arch", "shape", "status", "kind", "mesh", "n_chips",
                "sliding_window", "params_total", "params_active",
                "lower_seconds", "compile_seconds", "memory", "cost_raw",
                "collectives_raw", "cost", "collectives", "calibrated"}
    assert ref_keys <= set(rec)
    assert rec["mesh"] == "1" and rec["n_chips"] == 1
    assert rec["calibrated"] is False
    assert rec["collectives"]["total_bytes"] == 0
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes"}
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0


def test_skipped_pair_says_why():
    rec = lower_pair("whisper-tiny", "long_500k")
    assert rec["status"] == "skipped" and "whisper" in rec["reason"]


def test_long_context_runs_the_windowed_variant():
    rec = lower_pair(get_config("qwen3-4b").reduced(),
                     InputShape("long_500k", 4096, 1, "decode"))
    assert rec["sliding_window"] == 8192


def test_cli_writes_a_record(tmp_path, capsys):
    """``main`` at full width on a decode shape: a resumable JSON record."""
    import json
    dryrun.run_all(["qwen3-4b"], ["long_500k"], str(tmp_path))
    path = tmp_path / "qwen3-4b__long_500k.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["arch"] == "qwen3-4b"
    assert rec["params_total"] == get_config("qwen3-4b").param_count()
    dryrun.run_all(["qwen3-4b"], ["long_500k"], str(tmp_path))
    assert "[cached]" in capsys.readouterr().out


def test_budget_ends_a_long_step():
    with pytest.raises(dryrun.DryRunTimeout):
        lower_pair(get_config("qwen3-4b").reduced(),
                   InputShape("t", SEQ, BATCH, "train"), budget_s=0.0)


# -- the counter ---------------------------------------------------------------

def test_counter_tracks_peak_over_storage_lifetimes():
    w = torch.empty(100, 100, device="meta", requires_grad=True)
    x = torch.empty(8, 100, device="meta")
    c = StepCounter()
    with c:
        h = torch.tanh(x @ w)              # x @ w dies, tanh's output lives
        y = h.t()                          # a view: no new bytes
        assert c.live == 8 * 100 * 4
        del h, y
    assert c.live == 0
    assert c.peak == 2 * 8 * 100 * 4
    assert c.flops_by["matmul"] == 2 * 8 * 100 * 100
    assert c.cost["transcendentals"] == 8 * 100


# -- the kernels' meta branches ------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _attention_args():
    q = _meta(2, 4, 64, 32, dtype=torch.bfloat16)
    kv = _meta(2, 2, 64, 32, dtype=torch.bfloat16)
    return (q, kv, kv), {"window": 16}


# name -> (dispatcher, its meta arguments)
KERNELS = {
    "swa_attention": (ops.swa_attention, _attention_args),
    "overflow_check": (ops.overflow_flag_, lambda: (
        (_meta(1000), _meta(1, dtype=torch.int32), 10, 910), {})),
    "fused_adam": (ops.fused_adam, lambda: (
        (_meta(300), _meta(300), _meta(300), _meta(300), 3), {})),
}
CHARGES = {
    # q, o, k, v in bf16; 4 D flops and one exp a live pair
    "swa_attention": (4 * 32 * (16 * 17 // 2 + 48 * 16) * 2 * 4,
                      (16 * 17 // 2 + 48 * 16) * 2 * 4,
                      2 * (2 * 2 * 4 * 64 * 32 + 2 * 2 * 2 * 64 * 32)),
    "overflow_check": (900, 0, 900 * 4 + 4),
    "fused_adam": (16 * 300, 300, 30 * 300),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_meta_branch_raises_outside_a_dry_run(name):
    fn, make = KERNELS[name]
    args, kw = make()
    with pytest.raises(RuntimeError, match="outside a dry run"):
        fn(*args, **kw)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_meta_branch_charges_the_kernel_formula(name):
    fn, make = KERNELS[name]
    args, kw = make()
    c = StepCounter()
    with c, ops.dry_run_counter(c):
        out = fn(*args, **kw)
    flops, transcendentals, nbytes = CHARGES[name]
    assert dict(c.kernels[name]) == {
        "launches": 1, "flops": flops, "transcendentals": transcendentals,
        "bytes accessed": nbytes}
    # the kernel's charge only: the ops that made the outputs are not
    # counted
    assert c.cost["flops"] == flops and c.cost["bytes accessed"] == nbytes
    assert c.ops == 0
    assert all(t.is_meta for t in tree_leaves(out))


def test_overflow_check_has_no_meta_value():
    with pytest.raises(ValueError, match="meta"):
        ops.overflow_check(_meta(10))


@pytest.mark.parametrize("s,window,causal", [
    (64, 0, True), (64, 16, True), (64, 0, False), (64, 16, False),
    (10, 64, True), (1, 0, True)])
def test_live_pairs_counts_the_band(s, window, causal):
    q = torch.arange(s)[:, None]
    k = torch.arange(s)[None, :]
    mask = torch.ones(s, s, dtype=torch.bool)
    if causal:
        mask &= k <= q
    if window:
        mask &= k > q - window
    assert ops.live_pairs(s, window, causal) == int(mask.sum())


def test_input_shapes_are_the_reference_s():
    from repro.configs import INPUT_SHAPES as REF
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in INPUT_SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.kind) for k, v in REF.items()}
