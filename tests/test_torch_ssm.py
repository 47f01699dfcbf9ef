"""The recurrent mixers of the port — Mamba (``models/mamba.py``) and
xLSTM's mLSTM / sLSTM (``models/xlstm.py``) — against the reference, and
the offloaded paths over period-1 recurrent configs.

The same numpy inputs and weights go through both packages.  Tolerances,
each with its reason:

* the mixers, their states and one decode step, fp32: within rel 1e-5 of
  the output's max abs — the same fp32 math in another order (the scan's
  log-step tree is not ``jax.lax.associative_scan``'s);
* the reference's own decode-against-parallel tests
  (``tests/test_models.py``), ported: rtol/atol 2e-4, its bounds;
* two offloaded ``memascend`` train steps, fp32: step 1 within rel 1e-6 of
  the reference's session, step 2 within rel 1e-4 (Adam's first update is
  g / (|g| + eps): entries within fp32 noise of eps move by up to half of
  lr differently, as in ``tests/test_torch_mla.py``);
* uncached greedy tokens: equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import OffloadSession as JSession
from repro.core import memascend_policy as jax_policy
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.models import mamba as jmamba
from repro.models import xlstm as jxlstm
from repro.serve import OffloadedDecoder as JDecoder
from repro_torch.configs import get_config
from repro_torch.core import DecodeSpec, OffloadSession, memascend_policy
from repro_torch.core.model_adapter import (from_numpy_units,
                                            make_offloadable_lm)
from repro_torch.models import mamba as tmamba
from repro_torch.models import xlstm as txlstm
from repro_torch.models.layers import fan_in_std
from repro_torch.serve import OffloadedDecoder

torch.set_num_threads(2)

RTOL = 1e-5
B, L = 2, 64          # two chunks of the reduced configs' 32


def _cfgs(arch, **ssm_kw):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if ssm_kw:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
            jcfg.ssm, **ssm_kw))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(
            tcfg.ssm, **ssm_kw))
    return jcfg, tcfg


JAMBA = _cfgs("jamba-v0.1-52b")
XLSTM = _cfgs("xlstm-1.3b")


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _params(init, cfg, seed):
    """A mixer's reference weights (norm weights moved off zero so they
    count), as numpy."""
    p = init(jax.random.PRNGKey(seed), cfg)
    return {k: np.asarray(v) + (0.1 if k.endswith("norm") else 0.0)
            for k, v in p.items()}


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in params.items()})


def _x(cfg, seed, length=L):
    return np.random.default_rng(seed).standard_normal(
        (B, length, cfg.d_model)).astype(np.float32)


def _mamba_case(name):
    (jcfg, tcfg), rng = JAMBA, np.random.default_rng(0)
    jp, tp = _both(_params(jmamba.init_mamba_params, jcfg, 0))
    di, ds = tcfg.ssm.d_inner(tcfg.d_model), tcfg.ssm.d_state
    if name == "mamba_mixer":
        x = _x(tcfg, 1)
        return [(tmamba.mamba_mixer(tp, torch.from_numpy(x), tcfg),
                 jmamba.mamba_mixer(jp, jnp.asarray(x), jcfg))]
    if name.startswith("causal_conv1d"):
        x = rng.standard_normal((B, L, di)).astype(np.float32)
        st = rng.standard_normal((B, tcfg.ssm.conv_kernel - 1, di)).astype(
            np.float32) if name.endswith("state") else None
        jy, js = jmamba.causal_conv1d(jnp.asarray(x), jp["ssm.conv_w"],
                                      state=None if st is None
                                      else jnp.asarray(st))
        ty, ts = tmamba.causal_conv1d(torch.from_numpy(x), tp["ssm.conv_w"],
                                      state=None if st is None
                                      else torch.from_numpy(st))
        return [(ty, jy), (ts, js)]
    if name == "selective_scan":
        x = rng.standard_normal((B, L, di)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((B, L, di)))).astype(
            np.float32)
        b_in, c_in = (rng.standard_normal((B, L, ds)).astype(np.float32)
                      for _ in range(2))
        h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
        jy, jh = jmamba.selective_scan(
            *map(jnp.asarray, (x, dt, b_in, c_in)), jp["ssm.a_log"],
            jp["ssm.d_skip"], chunk=tcfg.ssm.chunk, h0=jnp.asarray(h0))
        ty, th = tmamba.selective_scan(
            *map(torch.from_numpy, (x, dt, b_in, c_in)), tp["ssm.a_log"],
            tp["ssm.d_skip"], chunk=tcfg.ssm.chunk, h0=torch.from_numpy(h0))
        return [(ty, jy), (th, jh)]
    # mamba_decode: one token against a random state
    x = _x(tcfg, 2, 1)
    cache = {"conv": rng.standard_normal(
        (B, tcfg.ssm.conv_kernel - 1, di)).astype(np.float32),
        "ssm": rng.standard_normal((B, di, ds)).astype(np.float32)}
    jo, jc = jmamba.mamba_decode(jp, jnp.asarray(x), jcfg,
                                 {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    to, tc = tmamba.mamba_decode(tp, torch.from_numpy(x), tcfg, tcache)
    for k, v in cache.items():                  # the cache passed in stays
        assert np.array_equal(tcache[k].numpy(), v)
    return [(to, jo), (tc["conv"], jc["conv"]), (tc["ssm"], jc["ssm"])]


def _xlstm_case(name):
    jcfg, tcfg = XLSTM
    kind = name.split("_")[0]
    jinit = getattr(jxlstm, f"init_{kind}_params")
    jp, tp = _both(_params(jinit, jcfg, 3))
    x = _x(tcfg, 4, 1 if name.endswith("decode") else L)
    if name.endswith("mixer"):
        jo, jst = getattr(jxlstm, name)(jp, jnp.asarray(x), jcfg,
                                        return_state=True)
        to, tst = getattr(txlstm, name)(tp, torch.from_numpy(x), tcfg,
                                        return_state=True)
        return [(to, jo)] + list(zip(tst, jst, strict=True))
    rng = np.random.default_rng(5)
    nh, d = tcfg.n_heads, tcfg.d_model
    dk = tcfg.ssm.d_inner(d) // nh
    shapes = ({"c": (B, nh, dk, dk), "n": (B, nh, dk)} if kind == "mlstm"
              else {k: (B, nh, d // nh) for k in "hcn"})
    cache = {k: np.abs(rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    jo, jc = getattr(jxlstm, name)(jp, jnp.asarray(x), jcfg,
                                   {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    to, tc = getattr(txlstm, name)(tp, torch.from_numpy(x), tcfg,
                                   {k: torch.from_numpy(v)
                                    for k, v in cache.items()})
    return [(to, jo)] + [(tc[k], jc[k]) for k in shapes]


@pytest.mark.parametrize("name", [
    "mamba_mixer", "selective_scan", "causal_conv1d",
    "causal_conv1d_state", "mamba_decode", "mlstm_mixer", "slstm_mixer",
    "mlstm_decode", "slstm_decode"])
def test_mixers_match_reference_fp32(name):
    case = _mamba_case if name.startswith(("mamba", "selective", "causal")) \
        else _xlstm_case
    with torch.no_grad():
        pairs = case(name)
    for got, want in pairs:
        _close(got, want)


@pytest.mark.parametrize("fn", ["selective_scan", "mlstm_mixer"])
def test_a_length_no_chunk_divides_raises(fn):
    """The reference refuses L % chunk != 0 (after chunk = min(chunk, L));
    so does the port."""
    if fn == "selective_scan":
        di = 8
        x = torch.zeros((1, 40, di))
        b_in = torch.zeros((1, 40, 4))
        with pytest.raises(ValueError, match="chunk"):
            tmamba.selective_scan(x, x, b_in, b_in, torch.zeros((di, 4)),
                                  torch.ones(di), chunk=32)
        y, _h = tmamba.selective_scan(x[:, :20], x[:, :20], b_in[:, :20],
                                      b_in[:, :20], torch.zeros((di, 4)),
                                      torch.ones(di), chunk=32)
        assert y.shape == (1, 20, di)
        return
    tcfg = XLSTM[1]
    tp = txlstm.init_mlstm_params(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="chunk"):
        txlstm.mlstm_mixer(tp, torch.zeros((1, 40, tcfg.d_model)), tcfg)


def test_checkpointed_chunks_give_the_plain_gradients():
    """Under autograd each scan chunk is checkpointed; nested in a
    checkpointed block it still gives the gradients of the unchecked
    computation, bit for bit."""
    from torch.utils.checkpoint import checkpoint
    tcfg = JAMBA[1]
    tp = tmamba.init_mamba_params(torch.Generator().manual_seed(1), tcfg)
    x = torch.from_numpy(_x(tcfg, 6))
    grads = []
    for nested in (False, True):
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        if nested:
            out = checkpoint(lambda xx: tmamba.mamba_mixer(p, xx, tcfg), x,
                             use_reentrant=False)
        else:
            out = tmamba.mamba_mixer(p, x, tcfg)
        out.square().sum().backward()
        grads.append({k: v.grad for k, v in p.items()})
    for k in tp:
        assert torch.equal(grads[0][k], grads[1][k]), k


# -- the reference's decode-against-parallel tests (tests/test_models.py) ---

def _chunk8(cfg):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=8))


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_decode_matches_parallel(kind):
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    if kind == "mamba":
        cfg = _chunk8(JAMBA[1])
        params = tmamba.init_mamba_params(gen, cfg)
        mixer, decode, length = tmamba.mamba_mixer, tmamba.mamba_decode, 32
        di = cfg.ssm.d_inner(cfg.d_model)
        cache = {"conv": torch.zeros((B, cfg.ssm.conv_kernel - 1, di)),
                 "ssm": torch.zeros((B, di, cfg.ssm.d_state))}
    elif kind == "mlstm":
        cfg = _chunk8(XLSTM[1])
        params = txlstm.init_mlstm_params(gen, cfg)
        mixer, decode, length = txlstm.mlstm_mixer, txlstm.mlstm_decode, 32
        dk = cfg.ssm.d_inner(cfg.d_model) // cfg.n_heads
        cache = {"c": torch.zeros((B, cfg.n_heads, dk, dk)),
                 "n": torch.zeros((B, cfg.n_heads, dk))}
    else:
        cfg = XLSTM[1]
        params = txlstm.init_slstm_params(gen, cfg)
        mixer, decode, length = txlstm.slstm_mixer, txlstm.slstm_decode, 16
        z = torch.zeros((B, cfg.n_heads, cfg.d_model // cfg.n_heads))
        cache = {"h": z, "c": z, "n": torch.ones_like(z)}
    x = torch.from_numpy(rng.standard_normal(
        (B, length, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_par = mixer(params, x, cfg)
        outs = []
        for t in range(length):
            o, cache = decode(params, x[:, t:t + 1], cfg, cache)
            outs.append(o)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_drawn_mixers_have_the_reference_constants():
    """The port's drawn tree holds the reference's constants exactly
    (Mamba's dt_bias, a_log, d_skip; zero norm weights) and its drawn
    tensors have fan-in std (sLSTM's ``r`` a tenth of it)."""
    tcfg = JAMBA[1]
    ref = jmamba.init_mamba_params(jax.random.PRNGKey(0), JAMBA[0])
    own = tmamba.init_mamba_params(torch.Generator().manual_seed(0), tcfg)
    assert list(own) == list(ref)
    for k in ("ssm.dt_bias", "ssm.a_log", "ssm.d_skip"):
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    xcfg = XLSTM[1]
    gen = torch.Generator().manual_seed(1)
    drawn = {**own, **txlstm.init_mlstm_params(gen, xcfg),
             **txlstm.init_slstm_params(gen, xcfg)}
    ref_keys = list(jxlstm.init_mlstm_params(jax.random.PRNGKey(0), XLSTM[0]))
    assert [k for k in drawn if k.startswith("mlstm")] == ref_keys
    assert not drawn["mlstm.out_norm"].any()
    for k, v in drawn.items():
        if v.dim() < 2 or k == "ssm.a_log":
            continue
        want = fan_in_std(v.shape) * (0.1 if k == "slstm.r" else 1.0)
        # a [-2, 2]-truncated normal has std 0.8796 of its scale
        assert abs(float(v.std()) / (0.8796 * want) - 1) < 0.1, k
        assert float(v.abs().max()) <= 2 * want * (1 + 1e-6), k


# -- offloaded paths over period-1 recurrent configs -------------------------

def _period1(kind):
    """A layer-homogeneous recurrent config in both packages: Mamba in
    every layer (jamba cut to its SSM family, no MoE), or sLSTM in every
    layer (xlstm with an sLSTM every layer)."""
    if kind == "mamba":
        kw = dict(family="ssm", moe=None, attn_period=1, moe_period=1,
                  n_layers=2)
        return tuple(dataclasses.replace(c, **kw) for c in JAMBA)
    return _cfgs("xlstm-1.3b", slstm_every=1)


@pytest.fixture(scope="module", params=["mamba", "slstm"])
def period1(request):
    jcfg, tcfg = _period1(request.param)
    jmodel = jax_lm(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return request.param, jcfg, tcfg, jmodel


def _pol(fn, root):
    return fn(root, lr=1e-2, compute_dtype="float32")


def test_offloaded_period1_training_matches_reference(period1,
                                                      tmp_store_root):
    kind, jcfg, tcfg, jmodel = period1
    from repro_torch.models.transformer import mixer_kind
    assert {mixer_kind(tcfg, i) for i in range(tcfg.n_layers)} == {kind}
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    losses = {}
    for pkg, session, model, fn in (
            ("jax", JSession, jmodel, jax_policy),
            ("torch", OffloadSession,
             from_numpy_units(tcfg, jmodel.units, torch.float32,
                              device="cpu"), memascend_policy)):
        with session(model, _pol(fn, f"{tmp_store_root}/{pkg}")) as s:
            losses[pkg] = [float(s.train_step(tokens, labels)["loss"])
                           for _ in range(2)]
    got, want = losses["torch"], losses["jax"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    assert got[1] < got[0]


def test_offloaded_period1_uncached_tokens_match_reference(period1,
                                                           tmp_store_root):
    _kind, _jcfg, tcfg, jmodel = period1
    prompts = np.random.default_rng(6).integers(
        0, tcfg.vocab, (2, 6)).astype(np.int32)
    with JDecoder(jmodel, _pol(jax_policy, tmp_store_root + "/j")) as dec:
        want = dec.generate(prompts, 4, use_cache=False)
    model = from_numpy_units(tcfg, jmodel.units, torch.float32, device="cpu")
    with OffloadedDecoder(model, _pol(memascend_policy,
                                      tmp_store_root + "/t")) as dec:
        got = dec.generate(prompts, 4, use_cache=False)
    np.testing.assert_array_equal(got, want)


def test_offloaded_period1_cached_session_raises(period1, tmp_store_root):
    """Cached decode takes attention mixers only, as in the reference: a
    DecodeSpec session over a recurrent state raises, in both packages."""
    _kind, jcfg, tcfg, jmodel = period1
    with pytest.raises(ValueError, match="cached-decode"):
        JSession(jmodel, jax_policy(tmp_store_root + "/j"), mode="serve",
                 decode=_jax_spec())
    model = make_offloadable_lm(tcfg, 0, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="cached-decode"):
        OffloadSession(model, memascend_policy(tmp_store_root + "/t"),
                       mode="serve",
                       decode=DecodeSpec(batch=1, max_seq=16, bucket=8))


def _jax_spec():
    from repro.core import DecodeSpec as JSpec
    return JSpec(batch=1, max_seq=16, bucket=8)
