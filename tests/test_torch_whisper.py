"""Whisper's encoder-decoder in the port (``models/whisper.py``,
``attention.cross_attention``, ``layers.sinusoidal_positions``, the audio
branch of ``models/registry.py``) against the reference, at
``whisper-tiny.reduced()`` widths.

The reference's tree crosses as numpy (``whisper.from_numpy_params``), so
both packages run the same weights on the same inputs.  Tolerances, each
with its reason:

* ``sinusoidal_positions``: bit for bit (the same numpy code);
* ``cross_attention``, ``whisper_loss``, fp32: rel 1e-5 — the same fp32
  math, products summed in another order;
* gradients against ``jax.grad``, fp32: each leaf within 1e-5 of its own
  max abs, for the same reason;
* decode against the parallel forward: rtol/atol 2e-3, the reference's own
  bound (``tests/test_consistency_extra.py``), and against the reference's
  decode logits: rel 1e-5 of each row's max;
* the verify step against a chain of serve steps: bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jatt
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.models import whisper as jwhs
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import train as launch
from repro_torch.models import TensorSpec, build
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.models import whisper as twhs
from repro_torch.serve import build_serve_step, build_verify_step
from repro_torch.train import build_train_step

torch.set_num_threads(2)

ARCH = "whisper-tiny"
JCFG, TCFG = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
B, S = 2, 12


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, TCFG.vocab, (B, S)).astype(np.int32)
    return {"frames": rng.standard_normal(
        (B, TCFG.encoder_seq, TCFG.d_model)).astype(np.float32),
        "tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference():
    """(jax impl, jax params, port impl, port params) at fp32."""
    jimpl = jbuild(JCFG, compute_dtype=jnp.float32)
    jparams = jimpl.init_params(jax.random.PRNGKey(0))
    timpl = build(TCFG, compute_dtype=torch.float32, device="cpu")
    tparams = twhs.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                     torch.float32, device="cpu")
    return jimpl, jparams, timpl, tparams


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads():
    jimpl, jparams, _t, _p = _reference()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    loss, grads = jax.jit(jax.value_and_grad(jimpl.loss_fn))(jparams, batch)
    return float(loss), jax.tree.map(np.asarray, grads)


def _pairs(jtree, ttree, path=""):
    if isinstance(ttree, dict):
        assert set(jtree) == set(ttree), path
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(jtree), ttree


@pytest.mark.parametrize("n_pos,dim", [(1, 8), (64, 128), (1500, 384),
                                       (449, 384)])
def test_sinusoidal_positions_bitwise(n_pos, dim):
    want = jlayers.sinusoidal_positions(n_pos, dim)
    got = tlayers.sinusoidal_positions(n_pos, dim)
    assert got.dtype == np.float32 and got.shape == (n_pos, dim)
    np.testing.assert_array_equal(got, want)


def test_cross_attention_matches_reference_fp32():
    rng = np.random.default_rng(1)
    d = TCFG.d_model
    params = {f"xattn.w_{n}": (rng.standard_normal(s) / np.sqrt(s[0]))
              .astype(np.float32)
              for n, s in (("q", (d, TCFG.q_dim)), ("k", (d, TCFG.kv_dim)),
                           ("v", (d, TCFG.kv_dim)), ("o", (TCFG.q_dim, d)))}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    mem = rng.standard_normal((B, 40, d)).astype(np.float32)
    want = np.asarray(jatt.cross_attention(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(mem), JCFG))
    got = tatt.cross_attention({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               torch.from_numpy(x), torch.from_numpy(mem),
                               TCFG).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_from_numpy_params_carries_the_reference_tree():
    _j, jparams, timpl, tparams = _reference()
    n = 0
    for path, ref, got in _pairs(jparams, tparams):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)
        n += 1
    assert n == 3 + len(jparams["enc_layers"]) + len(jparams["dec_layers"])
    # the port's own init draws the same tree (keys and shapes)
    own = timpl.init_params(0)
    assert {p: tuple(t.shape) for p, _r, t in _pairs(jparams, own)} == \
        {p: r.shape for p, r, _t in _pairs(jparams, tparams)}
    assert not own["dec_layers"]["norm_xattn"].any()


def test_whisper_loss_matches_reference_fp32():
    _j, _jp, timpl, tparams = _reference()
    want, _grads = _reference_loss_and_grads()
    with torch.no_grad():
        got = float(timpl.loss_fn(tparams, _torch(_batch())))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_train_step_grads_match_jax_grad():
    _j, _jp, timpl, tparams = _reference()
    want_loss, want = _reference_loss_and_grads()
    loss, grads, overflow = build_train_step(timpl)(tparams,
                                                    _torch(_batch()), 1.0)
    assert not bool(overflow)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    for path, ref, got in _pairs(want, grads):
        scale = max(np.abs(ref).max(), 1e-12)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale, path


def _prefilled(impl, params, frames, s, cache_dtype=torch.float32):
    memory = twhs.encode(impl.cfg, params, frames)
    cache = impl.init_cache(frames.shape[0], s, dtype=cache_dtype)
    return twhs.prefill_cross_cache(impl.cfg, params, memory, cache)


def test_decode_matches_parallel_and_reference():
    """The reference's test_whisper_decode_matches_parallel, ported (2e-3
    against the port's own forward), and each step's logits against the
    reference's decode step; then a cache_len past the position table
    clamps, as ``dynamic_slice_in_dim`` and ``dynamic_update_slice`` do."""
    jimpl, jparams, timpl, tparams = _reference()
    batch = _batch(3)
    tb = _torch(batch)
    serve, (cache_specs, tok_spec, _l) = build_serve_step(
        timpl, InputShape("t", S, B, "decode"), cache_dtype=torch.float32)
    assert tok_spec == TensorSpec((B, 1), torch.int32)
    with torch.no_grad():
        full = timpl.prefill_fn(tparams, tb).numpy()
        cache = _prefilled(timpl, tparams, tb["frames"], S)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in cache_specs.items()}
    jmem = jwhs.encode(JCFG, jparams, jnp.asarray(batch["frames"]))
    jcache = jwhs.prefill_cross_cache(
        JCFG, jparams, jmem, jimpl.init_cache(B, S, dtype=jnp.float32))
    jstep = jax.jit(jimpl.decode_fn)
    for t in range(S + 2):
        tok = batch["tokens"][:, min(t, S - 1):min(t, S - 1) + 1]
        before = {k: v.clone() for k, v in cache.items()}
        logits, cache_new = serve(tparams, cache, torch.from_numpy(tok), t)
        assert all(torch.equal(cache[k], before[k]) for k in cache)
        cache = cache_new
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok),
                                jnp.int32(t))
        got = logits[:, 0].numpy()
        if t < S:
            np.testing.assert_allclose(got, full[:, t], rtol=2e-3,
                                       atol=2e-3)
        ref = np.asarray(jlogits[:, 0])
        scale = np.abs(ref).max(-1, keepdims=True)
        assert (np.abs(got - ref) / scale).max() <= 1e-5, t


def test_verify_step_is_the_serve_chain_bitwise():
    _j, _jp, timpl, tparams = _reference()
    shape = InputShape("t", S, B, "decode")
    serve, _specs = build_serve_step(timpl, shape, cache_dtype=torch.float32)
    verify, (_c, window_spec, _l) = build_verify_step(
        timpl, shape, window=4, cache_dtype=torch.float32)
    assert window_spec == TensorSpec((B, 4), torch.int32)
    tb = _torch(_batch(4))
    tokens = tb["tokens"]
    with torch.no_grad():
        cache = _prefilled(timpl, tparams, tb["frames"], S)
    for t in range(5):
        _lg, cache = serve(tparams, cache, tokens[:, t:t + 1], t)
    chain, c = [], cache
    for j in range(4):
        lg, c = serve(tparams, c, tokens[:, 5 + j:6 + j], 5 + j)
        chain.append(lg[:, 0])
    got, vc = verify(tparams, cache, tokens[:, 5:9], 5)
    assert torch.equal(got, torch.stack(chain, dim=1))
    assert all(torch.equal(vc[k], c[k]) for k in c)


def test_registry_specs_for_the_audio_family():
    timpl = _reference()[2]
    shape = InputShape("t", 24, 3, "train")
    specs = timpl.input_specs(shape)
    assert specs == {
        "frames": TensorSpec((3, TCFG.encoder_seq, TCFG.d_model),
                             torch.float32),
        "tokens": TensorSpec((3, 24), torch.int32),
        "labels": TensorSpec((3, 24), torch.int32)}
    cache, tok, cache_len = build(TCFG, device="cpu").decode_args_specs(
        InputShape("t", 24, 3, "decode"))
    kv = (TCFG.n_layers, 3, 24, TCFG.n_kv_heads, TCFG.head_dim)
    xkv = (TCFG.n_layers, 3, TCFG.encoder_seq, TCFG.n_kv_heads,
           TCFG.head_dim)
    assert cache == {"k": TensorSpec(kv, torch.bfloat16),
                     "v": TensorSpec(kv, torch.bfloat16),
                     "xk": TensorSpec(xkv, torch.bfloat16),
                     "xv": TensorSpec(xkv, torch.bfloat16)}
    assert tok == TensorSpec((3, 1), torch.int32)
    assert cache_len == TensorSpec((), torch.int32)


@pytest.mark.parametrize("arch", ["whisper-tiny", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_launch_resident_runs_the_new_families(arch, capsys):
    launch.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                 "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert "step    1 loss" in out and "train loop done" in out
