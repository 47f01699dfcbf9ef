"""The device-resident model path of the port — ``models.registry``,
``transformer.lm_loss`` / ``decode_step``, ``train.step``,
``serve.decode`` and the launcher — against the reference, over the
reduced configs of the decoder families: dense (qwen3-4b), MoE
(phi3.5-moe), MLA + MTP (deepseek-v3), VLM with a bidirectional prefix
(paligemma), sliding-window (starcoder2, window cut to 8 so a short
decode rolls the cache), the Mamba/attention/MoE hybrid (jamba: one
8-layer interleave period) and xLSTM (an sLSTM every second layer, so the
2-layer cut holds one mLSTM and one sLSTM; at the published 1 in 8 it
would hold none).  Whisper's encoder-decoder is in
``tests/test_torch_whisper.py``.

The reference's ``init_params`` tree goes across as numpy
(``from_numpy_params``), so both packages run the same weights on the same
inputs.  Tolerances, each with its reason:

* ``lm_loss`` (MTP and MoE aux included), fp32: rel 1e-5 — the same fp32
  math, products summed in another order;
* gradients against ``jax.grad`` of the reference's loss, fp32: each leaf
  within 1e-5 of its own max abs, for the same reason;
* ``decode_step`` against the parallel forward, fp32: rtol/atol 2e-3, the
  reference's own bound (``tests/test_consistency_extra.py``), with router
  capacity 16 so the prefill drops no token; and against the reference's
  decode logits: rel 1e-5 of each row's max;
* the verify step against a chain of serve steps: bit for bit (it runs the
  same step function).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.models import build as jbuild
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.configs.base import InputShape
from repro_torch.data import make_batch_specs
from repro_torch.launch import train as launch
from repro_torch.models import (TensorSpec, build, shape_supported,
                                variant_for_shape)
from repro_torch.models.transformer import from_numpy_params
from repro_torch.serve import build_serve_step, build_verify_step
from repro_torch.train import build_train_step, grads_overflow_flag

torch.set_num_threads(2)

FAMILIES = {"dense": ("qwen3-4b", {}),
            "moe": ("phi3.5-moe-42b-a6.6b", {}),
            "mla": ("deepseek-v3-671b", {}),
            "vlm": ("paligemma-3b", {}),
            "swa": ("starcoder2-15b", {"sliding_window": 8}),
            "hybrid": ("jamba-v0.1-52b", {}),
            "xlstm": ("xlstm-1.3b", {"ssm": {"slstm_every": 2}})}
B, S = 2, 12


def _replace(cfg, kw):
    """``cfg`` with ``kw`` applied; a dict value replaces fields of that
    nested config."""
    kw = {k: dataclasses.replace(getattr(cfg, k), **v)
          if isinstance(v, dict) else v for k, v in kw.items()}
    return dataclasses.replace(cfg, **kw)


def _cfgs(family, capacity=None):
    arch, kw = FAMILIES[family]
    jcfg = _replace(JARCHS[arch].reduced(), kw)
    tcfg = _replace(ARCHS[arch].reduced(), kw)
    if capacity and jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity))
    return jcfg, tcfg


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.prefix_len:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(family, capacity=None):
    """(jax impl, jax params, port impl, port params) at fp32."""
    jcfg, tcfg = _cfgs(family, capacity)
    jimpl = jbuild(jcfg, compute_dtype=jnp.float32, remat=False)
    jparams = jimpl.init_params(jax.random.PRNGKey(0))
    timpl = build(tcfg, compute_dtype=torch.float32, device="cpu")
    tparams = from_numpy_params(tcfg, jax.tree.map(np.asarray, jparams),
                                torch.float32, device="cpu")
    return jimpl, jparams, timpl, tparams


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(family):
    jimpl, jparams, _t, _p = _reference(family)
    batch = {k: jnp.asarray(v) for k, v in _batch(jimpl.cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(jimpl.loss_fn))(jparams, batch)
    return float(loss), jax.tree.map(np.asarray, grads)


def _pairs(jtree, ttree, path=""):
    """(path, reference array, port tensor) over matching leaves."""
    if isinstance(ttree, dict):
        assert set(jtree) == set(ttree), path
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(ttree, (list, tuple)):
        assert len(jtree) == len(ttree), path
        for i, (j, t) in enumerate(zip(jtree, ttree)):
            yield from _pairs(j, t, f"{path}/{i}")
    else:
        yield path, np.asarray(jtree), ttree


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_from_numpy_params_carries_the_reference_tree(family):
    _j, jparams, timpl, tparams = _reference(family)
    n = 0
    for path, ref, got in _pairs(jparams, tparams):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)
        n += 1
    # the port's own init draws the same tree (keys and shapes)
    own = timpl.init_params(0)
    assert sum(1 for _ in _pairs(jparams, own)) == n
    cfg = timpl.cfg
    assert ("head" in tparams) == (not cfg.tie_embeddings)
    assert ("mtp" in tparams) == cfg.mtp


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lm_loss_matches_reference_fp32(family):
    _j, _jp, timpl, tparams = _reference(family)
    want, _grads = _reference_loss_and_grads(family)
    with torch.no_grad():
        got = float(timpl.loss_fn(tparams,
                                  _torch_batch(_batch(timpl.cfg))))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_grads_match_jax_grad(family):
    _j, _jp, timpl, tparams = _reference(family)
    want_loss, want = _reference_loss_and_grads(family)
    loss, grads, overflow = build_train_step(timpl)(
        tparams, _torch_batch(_batch(timpl.cfg)), 1.0)
    assert not bool(overflow)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    for path, ref, got in _pairs(want, grads):
        scale = max(np.abs(ref).max(), 1e-12)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale, path


@pytest.mark.parametrize("family", ["dense", "mla", "moe", "swa", "hybrid",
                                    "xlstm"])
def test_decode_step_matches_forward_and_reference(family):
    jimpl, jparams, timpl, tparams = _reference(family, capacity=16.0)
    s = 10            # past the sliding window of 8: the cache rolls
    tokens = _batch(timpl.cfg)["tokens"][:, :s]
    with torch.no_grad():
        full = timpl.prefill_fn(tparams, {"tokens": torch.from_numpy(
            tokens)}).numpy()
    serve, (cache_specs, tok_spec, len_spec) = build_serve_step(
        timpl, InputShape("t", s, B, "decode"), cache_dtype=torch.float32)
    assert tok_spec == TensorSpec((B, 1), torch.int32)
    assert len_spec == TensorSpec((), torch.int32)
    cache = timpl.init_cache(B, s, dtype=torch.float32)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in cache] == \
        [{k: v.shape for k, v in c.items()} for c in cache_specs]
    jcache = jimpl.init_cache(B, s, dtype=jnp.float32)
    jstep = jax.jit(jimpl.decode_fn)
    for t in range(s):
        before = [{k: v.clone() for k, v in c.items()} for c in cache]
        logits, new = serve(tparams, cache, torch.from_numpy(
            tokens[:, t:t + 1]), t)
        # the cache passed in is left as it was
        for a, b in zip(cache, before):
            assert all(torch.equal(a[k], b[k]) for k in a)
        cache = new
        jlogits, jcache = jstep(jparams, jcache,
                                jnp.asarray(tokens[:, t:t + 1]),
                                jnp.int32(t))
        got = logits[:, 0].numpy()
        np.testing.assert_allclose(got, full[:, t], rtol=2e-3, atol=2e-3)
        ref = np.asarray(jlogits[:, 0])
        scale = np.abs(ref).max(-1, keepdims=True)
        assert (np.abs(got - ref) / scale).max() <= 1e-5


@pytest.mark.parametrize("family", ["mla", "swa", "hybrid", "xlstm"])
def test_verify_step_is_the_serve_chain_bitwise(family):
    _j, _jp, timpl, tparams = _reference(family)
    shape = InputShape("t", 12, B, "decode")
    serve, _specs = build_serve_step(timpl, shape, cache_dtype=torch.float32)
    verify, (_c, window_spec, _l) = build_verify_step(
        timpl, shape, window=4, cache_dtype=torch.float32)
    assert window_spec == TensorSpec((B, 4), torch.int32)
    tokens = torch.from_numpy(_batch(timpl.cfg)["tokens"][:, :9])
    cache = timpl.init_cache(B, 12, dtype=torch.float32)
    for t in range(5):
        _lg, cache = serve(tparams, cache, tokens[:, t:t + 1], t)
    chain, c = [], cache
    for j in range(4):
        lg, c = serve(tparams, c, tokens[:, 5 + j:6 + j], 5 + j)
        chain.append(lg[:, 0])
    got, vc = verify(tparams, cache, tokens[:, 5:9], 5)
    assert torch.equal(got, torch.stack(chain, dim=1))
    for a, b in zip(vc, c):
        assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="window"):
        build_verify_step(timpl, shape, window=0)


@pytest.mark.parametrize("kind", ["fused", "baseline"])
def test_train_step_flags_an_injected_inf(kind):
    _j, _jp, timpl, tparams = _reference("mla")
    step = build_train_step(timpl, check_overflow=kind)
    batch = _torch_batch(_batch(timpl.cfg))
    _loss, grads, overflow = step(tparams, batch, 1.0)
    assert not bool(overflow)
    # an Inf loss scale overflows every gradient
    _loss, grads, overflow = step(tparams, batch, float("inf"))
    assert bool(overflow)
    # one Inf in one leaf of a clean gradient tree is enough
    _loss, grads, _overflow = step(tparams, batch, 1.0)
    assert not bool(grads_overflow_flag(grads, kind=kind))
    grads["groups"][0]["attn.w_dkv"].view(-1)[5] = float("inf")
    assert bool(grads_overflow_flag(grads, kind=kind))
    # the no-screen step returns a clear flag
    _l, _g, off = build_train_step(timpl, check_overflow=False)(
        tparams, batch, float("inf"))
    assert not bool(off)


def test_variant_for_shape_and_skips():
    long = INPUT_SHAPES["long_500k"]
    assert JSHAPES["long_500k"].seq_len == long.seq_len
    for arch, cfg in ARCHS.items():
        ok, reason = shape_supported(cfg, long)
        if arch == "whisper-tiny":
            assert not ok and "enc-dec" in reason
            continue
        v = variant_for_shape(cfg, long)
        if cfg.family in ("dense", "moe", "vlm", "hybrid"):
            assert v.sliding_window > 0, f"{arch} needs sub-quadratic decode"
        assert variant_for_shape(cfg, INPUT_SHAPES["decode_32k"]) == cfg


def test_build_takes_every_architecture():
    """No family is refused: each arch builds, and its reduced config
    draws a tree and a cache (on the meta device, no memory)."""
    assert set(ARCHS) == set(JARCHS)
    for arch, cfg in ARCHS.items():
        impl = build(cfg, device="cpu")
        shape = InputShape("t", 16, 2, "decode")
        cache_specs, tok, _len = impl.decode_args_specs(shape)
        assert tok == TensorSpec((2, 1), torch.int32), arch
        small = build(cfg.reduced(), compute_dtype=torch.float32,
                      device="cpu")
        assert small.init_params(0)["embed"].shape == (
            cfg.reduced().vocab, cfg.reduced().d_model), arch
        assert cache_specs, arch


def test_input_and_batch_specs():
    timpl = _reference("vlm")[2]
    shape = InputShape("t", 48, 2, "train")
    specs = timpl.input_specs(shape)
    cfg = timpl.cfg
    # the impl computes in fp32 here; the image embeddings come in it
    assert specs["image_embeds"] == TensorSpec((2, cfg.prefix_len,
                                                cfg.d_model), torch.float32)
    assert specs["tokens"] == TensorSpec((2, 48 - cfg.prefix_len),
                                         torch.int32)
    assert make_batch_specs(4, 32) == {
        "tokens": TensorSpec((4, 32), torch.int32),
        "labels": TensorSpec((4, 32), torch.int32)}


@pytest.mark.parametrize("path", ["resident", "offloaded"])
def test_launch_train_smoke(path, capsys):
    argv = ["--arch", "qwen3-4b", "--device", "cpu", "--steps", "2",
            "--seq", "16", "--batch", "2"]
    if path == "offloaded":
        argv += ["--offload", "memascend"]
    launch.main(argv)
    out = capsys.readouterr().out
    assert "step    1 loss" in out
    assert ("offloaded train loop done" if path == "offloaded"
            else "train loop done") in out


def test_resident_loop_applies_sgd_and_skips_overflow():
    """The launcher's loop: SGD moves every leaf on a clean step; an
    overflowing step is skipped and halves the scale."""
    _j, _jp, timpl, tparams = _reference("dense")
    batch = _torch_batch(_batch(timpl.cfg))
    seen = []
    scaler = launch.DynamicLossScaler(scale=1.0)
    out = launch.resident_loop(build_train_step(timpl), tparams, [batch],
                               lr=1e-2, scaler=scaler,
                               on_step=lambda *a: seen.append(a))
    assert seen[0][0] == 1 and seen[0][2] is False
    assert not torch.equal(out["embed"], tparams["embed"])
    inf_scaler = launch.DynamicLossScaler(scale=float("inf"))
    same = launch.resident_loop(build_train_step(timpl), tparams, [batch],
                                lr=1e-2, scaler=inf_scaler)
    assert same is tparams and inf_scaler.n_overflows == 1
