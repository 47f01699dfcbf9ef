"""The port's mesh (``repro_torch.launch.{mesh,sharding}``) against the
reference's ``tests/test_sharding.py``.

* The sharding rules, one for one: for every architecture on the 16x16
  and 2x16x16 production meshes, the port's ``param_specs`` (zero3, tp),
  ``batch_specs``, ``cache_specs`` (the decode shapes' caches) and
  ``logits_spec`` equal the reference's ``PartitionSpec``s leaf for leaf
  on the matched tree paths.  The reference computes its specs against its
  tests' own ``FakeMesh``; the port against a ``DeviceMesh`` over a
  ``"fake"`` process group of 256 or 512 ranks, opened and closed by each
  test.
* ``test_big_weights_actually_sharded`` and the ``greedy_spec`` property,
  the port's result equal to the reference's on the same drawn shapes.
* The 1x1 host mesh over a ``gloo`` group of one rank: the meshed train
  and serve steps of reduced qwen3-4b equal the port's unmeshed steps bit
  for bit, and at fp32 the reference's host-mesh steps within rel 1e-5
  (the same fp32 math, products summed in another order); the overflow
  flag of a local shard.

The spawned 2x2 ``gloo`` mesh is in ``tests/test_torch_mesh_gloo.py``, the
other families on the host mesh in ``tests/test_torch_mesh_families.py``.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as JARCHS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs.base import InputShape as JShape
from repro.launch import sharding as jshd
from repro.launch.mesh import make_host_mesh as jhost_mesh
from repro.models import build as jbuild
from repro.serve.decode import build_serve_step as jserve_step
from repro.train.step import build_train_step as jtrain_step
from test_sharding import MESH, MESH3, _check_spec

from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.configs.base import InputShape
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (axis_size, batch_axes,
                                     fake_process_group, make_host_mesh,
                                     make_production_mesh, one_rank_group)
from repro_torch.models import build
from repro_torch.models.registry import TensorSpec, param_shapes
from repro_torch.models.transformer import from_numpy_params
from repro_torch.serve.decode import build_serve_step
from repro_torch.train.step import (build_train_step, grads_overflow_flag,
                                    tree_leaves)

torch.set_num_threads(2)

MESHES = {"pod": (MESH, False, 256), "multipod": (MESH3, True, 512)}
DECODE_SHAPES = ["decode_32k", "long_500k"]


def _port_mesh(name):
    """``(fake group context, mesh maker)`` of a production mesh."""
    _ref, multi, world = MESHES[name]
    return fake_process_group(world), lambda: make_production_mesh(
        multi_pod=multi, device_type="cpu")


def _norm(spec) -> tuple:
    """A spec's entries as tuples of axis names (None -> ())."""
    out = []
    for e in spec:
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def _ref_by_path(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(e, "key", getattr(e, "idx", None)) for e in path):
            _norm(spec) for path, spec in flat}


def _port_by_path(specs, shapes) -> dict:
    """``{path: (spec, shape)}`` over the leaves of ``shapes``."""
    out = {}

    def visit(path, leaf):
        node = specs
        for k in path:
            node = node[k]
        out[path] = (node, tuple(leaf.shape))
    shd.tree_map_with_path(visit, shapes)
    return out


def _assert_same(port: dict, ref: dict, ref_mesh):
    assert set(port) == set(ref)
    bad = {p: (port[p][0], ref[p]) for p in port
           if _norm(port[p][0]) != ref[p]}
    assert not bad, bad
    for spec, shape in port.values():
        _check_spec(spec, shape, ref_mesh)


def _by_path(tree) -> dict:
    out = {}
    shd.tree_map_with_path(lambda p, t: out.__setitem__(p, t), tree)
    return out


def _ref_leaves(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield tuple(getattr(e, "key", getattr(e, "idx", None))
                    for e in path), leaf


def _flat_placements(tree) -> list:
    out = []
    shd.spec_map(lambda pl: out.append(tuple(pl)), tree)
    return out


# -- the rules against the reference's ----------------------------------------

@pytest.mark.parametrize("mode", ["zero3", "tp"])
@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_the_reference(arch, mesh_name, mode):
    ref_mesh = MESHES[mesh_name][0]
    jimpl = jbuild(JARCHS[arch])
    jshapes = jax.eval_shape(jimpl.init_params, jax.random.PRNGKey(0))
    ref = _ref_by_path(jshd.param_specs(JARCHS[arch], jshapes, ref_mesh,
                                        mode=mode))
    shapes = param_shapes(ARCHS[arch])
    group, make = _port_mesh(mesh_name)
    with group:
        mesh = make()
        specs = shd.param_specs(ARCHS[arch], shapes, mesh, mode=mode)
        placements = shd.placements_tree(specs, mesh)
    _assert_same(_port_by_path(specs, shapes), ref, ref_mesh)
    assert len(_flat_placements(placements)) == len(ref)


@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_specs_equal_the_reference(arch, mesh_name, shape_name):
    ref_mesh = MESHES[mesh_name][0]
    shape = JSHAPES[shape_name]
    jimpl = jbuild(JARCHS[arch])
    jcache = jax.eval_shape(
        lambda: jimpl.init_cache(shape.global_batch, shape.seq_len))
    ref = _ref_by_path(jshd.cache_specs(JARCHS[arch], jcache, ref_mesh))
    impl = build(ARCHS[arch], device="meta")
    cache, _tok, _len = impl.decode_args_specs(INPUT_SHAPES[shape_name])
    group, make = _port_mesh(mesh_name)
    with group:
        specs = shd.cache_specs(ARCHS[arch], cache, make())
    _assert_same(_port_by_path(specs, cache), ref, ref_mesh)


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_and_logits_specs_equal_the_reference(arch, mesh_name):
    ref_mesh = MESHES[mesh_name][0]
    jimpl = jbuild(JARCHS[arch])
    impl = build(ARCHS[arch], device="meta")
    group, make = _port_mesh(mesh_name)
    with group:
        mesh = make()
        for name in ("train_4k", "prefill_32k"):
            ref = _ref_by_path(jshd.batch_specs(
                JARCHS[arch], jimpl.input_specs(JSHAPES[name]), ref_mesh))
            specs = impl.input_specs(INPUT_SHAPES[name])
            _assert_same(_port_by_path(shd.batch_specs(ARCHS[arch], specs,
                                                       mesh), specs), ref,
                         ref_mesh)
        for gb in (1, 16, 32, 128, 256, 512):
            assert _norm(shd.logits_spec(ARCHS[arch], mesh, gb)) == \
                _norm(jshd.logits_spec(JARCHS[arch], ref_mesh, gb))
            assert _norm(shd.tokens_spec(mesh, gb)) == _norm(
                (batch_axes(mesh) if gb % axis_size(mesh, *batch_axes(mesh))
                 == 0 else None, None))


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "xlstm-1.3b"])
def test_big_weights_actually_sharded(arch):
    """The embedding must not be replicated (the reference's test)."""
    shapes = param_shapes(ARCHS[arch])
    with fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        specs = shd.param_specs(ARCHS[arch], shapes, mesh)
        placements = shd.to_placements(specs["embed"], mesh)
    assert any(p is not None for p in specs["embed"]), "embedding replicated!"
    assert any(p.is_shard() for p in placements)


@settings(max_examples=50, deadline=None)
@given(shape=st.lists(st.integers(min_value=1, max_value=4096), min_size=1,
                      max_size=4),
       seed=st.integers(min_value=0, max_value=1000))
def test_greedy_spec_equals_the_reference(shape, seed):
    r = random.Random(seed)
    axes = ["data", "model", ("data", "model")]
    prefs = [[r.choice(axes)] if r.random() < 0.7 else [] for _ in shape]
    ref = jshd.greedy_spec(MESH, shape, prefs)
    with fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        got = shd.greedy_spec(mesh, shape, prefs)
        placements = shd.to_placements(got, mesh)
        local = shd.local_shape(shape, got, mesh)
    _check_spec(got, shape, MESH)
    assert _norm(got) == _norm(ref)
    # each sharded dim splits over its mesh dims, the major axis first
    assert len(placements) == 2
    for d, part in enumerate(got):
        n = 1 if part is None else axis_size(mesh, *shd._names(part))
        assert local[d] * n == shape[d]


def test_to_placements_asserts_mesh_order():
    with fake_process_group(4):
        from repro_torch.launch.mesh import _mesh
        mesh = _mesh((2, 2), ("data", "model"), "cpu")
        with pytest.raises(AssertionError):
            shd.to_placements((("model", "data"),), mesh)
        pl = shd.to_placements((("data", "model"), None), mesh)
    assert [p.dim for p in pl] == [0, 0]


def test_mesh_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_production_mesh(device_type="cpu")
    with fake_process_group(8):
        with pytest.raises(RuntimeError, match="world size 256"):
            make_production_mesh(device_type="cpu")
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_process_group(4):
                pass
    assert not torch.distributed.is_initialized()


# -- the host mesh: bit for bit the unmeshed steps; the reference's ----------

B, S, CACHE = 2, 32, 64


def _reference(dtype=jnp.float32):
    cfg = JARCHS["qwen3-4b"].reduced()
    jimpl = jbuild(cfg, compute_dtype=dtype)
    jparams = jimpl.init_params(jax.random.PRNGKey(0))
    return cfg, jimpl, jparams


def _port(dtype=torch.float32):
    cfg, _jimpl, jparams = _reference()
    tcfg = ARCHS["qwen3-4b"].reduced()
    impl = build(tcfg, compute_dtype=dtype, device="cpu")
    params = from_numpy_params(tcfg, jax.tree.map(np.asarray, jparams),
                               torch.float32, device="cpu")
    return impl, params


def _batch(vocab):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (B, S), dtype=np.int32)}


def _batch_shape():
    return {k: TensorSpec((B, S), torch.int32) for k in ("tokens", "labels")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_host_mesh_train_step_is_the_unmeshed_step(dtype):
    impl, params = _port(dtype)
    batch = {k: torch.from_numpy(v) for k, v in _batch(impl.cfg.vocab).items()}
    want_loss, want, want_ov = build_train_step(impl)(params, batch, 4.0)
    with one_rank_group("gloo"):
        mesh = make_host_mesh(device_type="cpu")
        step, (pin, bin_, sin), (sout, pout, oout) = build_train_step(
            impl, mesh, batch_shape=_batch_shape())
        loss, grads, overflow = step(params, batch, 4.0)
        got = _by_path(shd.full_tree(grads))
    assert pin == pout and sin == sout == oout
    assert all(tree_leaves(shd.spec_map(
        lambda pl, g: tuple(g.placements) == tuple(pl), pout, grads)))
    assert torch.equal(loss, want_loss)
    assert bool(overflow) == bool(want_ov) is False
    want = _by_path(want)
    assert set(got) == set(want)
    assert all(torch.equal(got[p], want[p]) for p in want)




def test_host_mesh_train_step_matches_the_reference_fp32():
    cfg, jimpl, jparams = _reference()
    nb = _batch(cfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    jmesh = jhost_mesh()
    sds = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in nb}
    with jmesh:
        fn, in_sh, out_sh = jtrain_step(jimpl, jmesh, batch_shape=sds)
        jloss, jgrads, _ = jax.jit(fn, in_shardings=in_sh,
                                   out_shardings=out_sh)(
            jparams, jbatch, jnp.float32(4.0))
    impl, params = _port()
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    with one_rank_group("gloo"):
        step, _in, _out = build_train_step(
            impl, make_host_mesh(device_type="cpu"),
            batch_shape=_batch_shape())
        loss, grads, overflow = step(params, batch, 4.0)
        got = _by_path(shd.full_tree(grads))
        got = {p: t.numpy() for p, t in got.items()}
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert not bool(overflow)
    want = {path: np.asarray(g) for path, g in _ref_leaves(jgrads)}
    assert set(got) == set(want)
    for path, b in want.items():
        a = got[path]
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-12), \
            path


def test_host_mesh_overflow_flag_reads_local_shards():
    impl, params = _port()
    batch = {k: torch.from_numpy(v) for k, v in _batch(impl.cfg.vocab).items()}
    with one_rank_group("gloo"):
        step, _in, _out = build_train_step(
            impl, make_host_mesh(device_type="cpu"),
            batch_shape=_batch_shape())
        _loss, grads, overflow = step(params, batch, 1.0)
        clean = bool(grads_overflow_flag(grads))
        baseline_clean = bool(grads_overflow_flag(grads, kind="baseline"))
        tree_leaves(grads)[3].to_local().view(-1)[-1] = float("inf")
        dirty = bool(grads_overflow_flag(grads))
        baseline_dirty = bool(grads_overflow_flag(grads, kind="baseline"))
    assert (bool(overflow), clean, baseline_clean) == (False, False, False)
    assert dirty and baseline_dirty


def _serve_inputs(impl, vocab, dtype):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (B, 6), dtype=np.int32)
    cache = impl.init_cache(B, CACHE, dtype, device="cpu")
    return toks, cache


@pytest.mark.parametrize("mode", ["zero3", "tp"])
def test_host_mesh_serve_step_is_the_unmeshed_step(mode):
    impl, params = _port(torch.bfloat16)
    shape = InputShape("tiny_decode", CACHE, B, "decode")
    toks, cache = _serve_inputs(impl, impl.cfg.vocab, torch.bfloat16)
    serve, _specs = build_serve_step(impl, shape)
    c1 = c2 = cache
    with one_rank_group("gloo"):
        mserve, (pin, cin, tin, lin), (lout, cout), _ = build_serve_step(
            impl, shape, make_host_mesh(device_type="cpu"), param_mode=mode)
        for t in range(toks.shape[1]):
            tok = torch.from_numpy(toks[:, t:t + 1])
            want, c1 = serve(params, c1, tok, t)
            got, c2 = mserve(params, c2, tok, t)
            assert tuple(got.placements) == lout
            assert torch.equal(got.full_tensor(), want), t
        assert all(torch.equal(a.full_tensor(), b)
                   for a, b in zip(tree_leaves(c2), tree_leaves(c1)))
    assert cin == cout and len(pin) == len(params)


@pytest.mark.parametrize("mode", ["zero3", "tp"])
def test_host_mesh_serve_step_matches_the_reference_fp32(mode):
    cfg, jimpl, jparams = _reference()
    jmesh = jhost_mesh()
    shape = JShape("tiny_decode", CACHE, B, "decode")
    toks, _c = _serve_inputs(build(ARCHS["qwen3-4b"].reduced(),
                                   device="cpu"), cfg.vocab, torch.float32)
    with jmesh:
        fn, in_sh, out_sh, _specs = jserve_step(
            jimpl, jmesh, shape, cache_dtype=jnp.float32, param_mode=mode)
        jstep = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        jcache = jimpl.init_cache(B, CACHE, jnp.float32)
        want = []
        for t in range(toks.shape[1]):
            logits, jcache = jstep(jparams, jcache,
                                   jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(t))
            want.append(np.asarray(logits))
            # back to host arrays: a cache that keeps its explicit
            # seq-over-model sharding trips jnp.einsum's sharding check on
            # the next step
            jcache = jax.tree.map(np.asarray, jcache)
    impl, params = _port()
    cache = impl.init_cache(B, CACHE, torch.float32, device="cpu")
    with one_rank_group("gloo"):
        mserve, _in, _out, _ = build_serve_step(
            impl, InputShape("tiny_decode", CACHE, B, "decode"),
            make_host_mesh(device_type="cpu"), param_mode=mode,
            cache_dtype=torch.float32)
        for t in range(toks.shape[1]):
            got, cache = mserve(params, cache,
                                torch.from_numpy(toks[:, t:t + 1]), t)
            got = got.full_tensor().numpy()
            scale = np.abs(want[t]).max(axis=-1, keepdims=True)
            assert (np.abs(got - want[t]) <= 1e-5 * scale).all(), t


def test_launcher_trains_over_the_host_mesh(capsys):
    from repro_torch.launch.train import main
    main(["--arch", "qwen3-4b", "--steps", "2", "--seq", "16", "--batch",
          "2", "--device", "cpu", "--host-mesh"])
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1} (cpu)" in out
    assert "train loop done" in out
    assert not torch.distributed.is_initialized()


def test_launcher_production_mesh_needs_its_group():
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="world size 256"):
        main(["--arch", "qwen3-4b", "--steps", "1", "--seq", "16",
              "--batch", "2", "--device", "cpu", "--production-mesh"])
