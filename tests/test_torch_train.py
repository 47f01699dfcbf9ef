"""The SSD-offloaded training step: the port's ``OffloadSession`` (train
mode) against the reference package's, on the same numpy units and batch,
plus the port's own identities and failure paths.

Tolerances, each with its reason:

* fp32 compute: losses within rtol 1e-5 — the same fp32 math in another
  summation order (matmuls, softmax, the embedding scatter); the step-1
  gradients agree to ~1e-6 of each tensor's max.  Masters: 99.9 % of the
  elements within rtol 1e-5 / atol 1e-7, and every element within 5 % of
  the learning rate.  Adam normalises each element's update by its own
  gradient history, so an element whose gradient is near zero carries the
  gradients' absolute difference into its update as a relative one (seen:
  2 of 8192 elements of one tensor 9e-7 apart after three steps at
  lr 1e-4);
* bf16 compute: losses within 8 bf16 ULPs of the loss (rel 8 * 2**-8) —
  bf16 activations round at other places in the two frameworks, the
  repo's decode-audit bound (``benchmarks/bench_decode.py``);
* overflow verdicts, ``applied`` and the loss scale: equal;
* ``memascend-bf16`` state: bit-identical given the same gradients;
* within the port, sync == h2d == full: bit for bit.

Every case runs the preset's activation checkpoints as shipped (the
``host`` tier); ``tests/test_torch_act_stream.py`` covers the other tiers.
"""

import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import OffloadPolicy as JPolicy, OffloadSession as JSession
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.core.nvme import DirectNVMeEngine as JEngine
from repro.core.optimizer import AdamConfig as JAdam, OffloadedAdam as JOpt
from repro.core.optimizer import adam_update as j_adam_update
from repro_torch.configs.base import ModelConfig
from repro_torch.core import OffloadPolicy, OffloadSession
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.core.nvme import DirectNVMeEngine
from repro_torch.core.optimizer import (ADAM_CHUNK, AdamConfig,
                                        OffloadedAdam, adam_update)
from repro_torch.core import overflow as toverflow

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256, qk_norm=True)
JCFG, TCFG = JConfig(**KW), ModelConfig(**KW)
STEPS = 3


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _units(compute):
    return jax_lm(JCFG, jax.random.PRNGKey(0), getattr(jnp, compute))


def _with_inf(units):
    """The same units with one Inf in block_000's FFN down projection."""
    out = []
    for u in units:
        params = dict(u.params)
        if u.name == "block_000":
            w = params["ffn.w_down"].copy()
            w[0, 0] = np.inf
            params["ffn.w_down"] = w
        out.append(type(u)(u.name, u.kind, params))
    return out


def _policy(pkg_policy, preset, root, compute, overlap="full"):
    return (pkg_policy.preset(preset).with_store(root)
            .with_adam(compute_dtype=compute)
            .with_overlap(overlap).build())


def _run(session, batch, steps=STEPS, scale=None):
    """Metrics of ``steps`` train steps, every master, and the eval loss."""
    if scale is not None:
        session.scaler.scale = scale
    metrics = [dict(session.train_step(*batch)) for _ in range(steps)]
    masters = {(u.name, k): np.asarray(session.master_param(u.name, k),
                                       np.float32)
               for u in session.model.units for k in u.params}
    return metrics, masters, session.eval_loss(*batch)


def _jax(jmodel, batch, root, compute, preset="memascend", **kw):
    with JSession(jmodel, _policy(JPolicy, preset, root, compute)) as s:
        return _run(s, batch, **kw)


def _port(units, batch, root, compute, preset="memascend", overlap="full",
          **kw):
    model = from_numpy_units(TCFG, units, getattr(torch, compute),
                             device="cpu")
    with OffloadSession(model, _policy(OffloadPolicy, preset, root, compute,
                                       overlap)) as s:
        return _run(s, batch, **kw)


def test_default_mode_is_train_as_in_the_reference():
    default = inspect.signature(OffloadSession).parameters["mode"].default
    assert default == "train"
    assert default == inspect.signature(
        JSession).parameters["mode"].default


@pytest.mark.parametrize("preset", ["memascend", "zero-infinity"])
def test_fp32_losses_and_masters_match_reference(batch, tmp_store_root,
                                                 preset):
    """Three steps on one batch: losses, verdicts, scale, every master and
    the eval loss.  ``zero-infinity`` screens with the chained host check
    at the barrier, ``memascend`` per unit as the grads land."""
    jm = _units("float32")
    jmet, jmas, jeval = _jax(jm, batch, tmp_store_root + "/j", "float32",
                             preset)
    tmet, tmas, teval = _port(jm.units, batch, tmp_store_root + "/t",
                              "float32", preset)
    for j, t in zip(jmet, tmet, strict=True):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        for key in ("overflowed", "applied", "loss_scale"):
            assert t[key] == j[key]
    assert sorted(tmet[0]) == sorted(jmet[0])
    lr = JPolicy.preset("memascend").with_store("x").build().adam.lr
    tight = total = 0
    for key, ref in jmas.items():
        diff = np.abs(tmas[key] - ref)
        tight += int((diff <= 1e-7 + 1e-5 * np.abs(ref)).sum())
        total += ref.size
        assert diff.max() <= 0.05 * lr, key
    assert tight >= 0.999 * total
    np.testing.assert_allclose(teval, jeval, rtol=1e-5)


def test_bf16_losses_within_eight_ulps(batch, tmp_store_root):
    jm = _units("bfloat16")
    jmet, _jmas, jeval = _jax(jm, batch, tmp_store_root + "/j", "bfloat16")
    tmet, _tmas, teval = _port(jm.units, batch, tmp_store_root + "/t",
                               "bfloat16")
    tol = 8 * 2.0 ** -8
    for j, t in zip(jmet, tmet, strict=True):
        assert abs(t["loss"] - j["loss"]) <= tol * abs(j["loss"])
        assert t["applied"] and j["applied"]
    assert abs(teval - jeval) <= tol * abs(jeval)


@pytest.mark.parametrize("preset", ["memascend", "zero-infinity"])
def test_injected_inf_skips_the_step_in_both(batch, tmp_store_root, preset):
    """An Inf in a block weight (fp16 compute, loss scale 2**16): both
    packages flag the step, apply nothing, leave every master as it was
    and back the scale off by the same factor."""
    units = _with_inf(_units("float16").units)
    jm = _units("float16")
    jm.units = units
    jmet, jmas, _ = _jax(jm, batch, tmp_store_root + "/j", "float16",
                         preset, steps=1)
    tmet, tmas, _ = _port(units, batch, tmp_store_root + "/t", "float16",
                          preset, steps=1)
    for met in (jmet[0], tmet[0]):
        assert met["overflowed"] and not met["applied"]
        assert met["loss_scale"] == 2.0 ** 15
    for u in units:
        for k, v in u.params.items():
            np.testing.assert_array_equal(tmas[(u.name, k)], v)
            np.testing.assert_array_equal(jmas[(u.name, k)], v)


def test_overlap_modes_are_bit_identical(batch, tmp_store_root):
    """sync == h2d == full within the port: losses and every master."""
    units = _units("float32").units
    runs = {mode: _port(units, batch, f"{tmp_store_root}/{mode}", "float32",
                        overlap=mode)
            for mode in ("sync", "h2d", "full")}
    for mode in ("h2d", "full"):
        assert [m["loss"] for m in runs[mode][0]] == \
            [m["loss"] for m in runs["sync"][0]]
        for key, ref in runs["sync"][1].items():
            np.testing.assert_array_equal(runs[mode][1][key], ref)


@pytest.mark.parametrize("n", [1, 1000, ADAM_CHUNK, 2 * ADAM_CHUNK + 77])
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adam_update_is_the_reference_s_bit_for_bit(n, weight_decay):
    """The port's chunked ``adam_update`` against the reference's
    whole-array one: master, m and v the same bits after three steps,
    on lengths below, at and across the chunk, in 2-D as well."""
    rng = np.random.default_rng(n)
    shape = (n,) if n % 2 else (2, n // 2)
    states = [rng.standard_normal(shape).astype(np.float32),
              np.abs(rng.standard_normal(shape)).astype(np.float32) * 0.1,
              np.abs(rng.standard_normal(shape)).astype(np.float32) * 0.01]
    kw = dict(lr=3e-3, weight_decay=weight_decay)
    port = [a.copy() for a in states]
    ref = [a.copy() for a in states]
    for step in (1, 2, 3):
        grad = rng.standard_normal(shape).astype(np.float32)
        adam_update(port[0], grad, port[1], port[2], step, AdamConfig(**kw))
        j_adam_update(ref[0], grad, ref[1], ref[2], step, JAdam(**kw))
    for got, want in zip(port, ref, strict=True):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_adam_update_refuses_a_strided_state():
    m = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="C-contiguous"):
        adam_update(np.zeros((4, 4), np.float32).T, np.ones((4, 4),
                    np.float32), m, m.copy(), 1, AdamConfig())


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_offloaded_adam_state_bytes_identical(tmp_store_root, state,
                                              compute):
    """Given the same gradients, the port's OffloadedAdam writes the same
    master/m/v/compute bytes as the reference's — bit for bit, including
    the ``memascend-bf16`` state mode (bf16 bits rounded to nearest
    even).  The 262,145-element leaf spans five of the host kernel's
    chunks, and with fp32 state the store stripes it over two regions."""
    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal((33, 17)).astype(np.float32),
            "b": rng.standard_normal(129).astype(np.float32),
            "e": rng.standard_normal(262_145).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]
    stores = {}
    for name, engine, adam_cls, opt_cls in (
            ("j", JEngine, JAdam, JOpt),
            ("t", DirectNVMeEngine, AdamConfig, OffloadedAdam)):
        store = engine(f"{tmp_store_root}/{name}")
        opt = opt_cls(store, adam_cls(lr=1e-2, weight_decay=0.01,
                                      state_dtype=state,
                                      compute_dtype=compute))
        for k, v in init.items():
            opt.register(k, v)
        for g in grads:
            opt.begin_step()
            for k in init:
                opt.step_subgroup(k, g[k])
        stores[name] = (store, opt)
    try:
        for k, v in init.items():
            for suffix, dtype in ((".master", state), (".m", state),
                                  (".v", state), (".compute", compute)):
                nbytes = np.dtype(dtype if dtype != "bfloat16"
                                  else ml_dtypes.bfloat16).itemsize
                got = [s.read_new(k + suffix, np.uint8, (v.size * nbytes,))
                       for s, _ in stores.values()]
                np.testing.assert_array_equal(got[0], got[1],
                                              err_msg=k + suffix)
    finally:
        for store, opt in stores.values():
            opt.close()
            store.close()


def test_fused_screen_runs_on_the_writer_with_no_host_scan(batch,
                                                           tmp_store_root):
    """memascend under full overlap screens every unit's grads on the
    gradient-writer thread as they land; the barrier's host check_region
    never runs."""
    import threading
    model = from_numpy_units(TCFG, _units("float32").units, torch.float32,
                             device="cpu")
    policy = _policy(OffloadPolicy, "memascend", tmp_store_root, "float32")
    with OffloadSession(model, policy) as s:
        threads = set()
        real = s._screen_unit_region

        def screen(unit, grads):
            threads.add(threading.current_thread().name)
            return real(unit, grads)

        s._screen_unit_region = screen
        calls = toverflow.check_region.calls
        m = s.train_step(*batch)
        assert threads == {"offload-gradwrite"}
        assert toverflow.check_region.calls == calls
        assert not m["overflowed"] and m["overflow_screen_s"] > 0.0
        assert s.flat.dtype == np.float32 and s.flat.size == s.total_params


def test_commit_write_failure_surfaces_once_and_frees_staging(
        batch, tmp_store_root):
    """A write-back that fails at commit fails the unit's readiness
    future, surfaces at the unit's next fetch, releases its staging
    buffer, and leaves no worker thread (the suite's leak guard)."""
    model = from_numpy_units(TCFG, _units("float32").units, torch.float32,
                             device="cpu")
    s = OffloadSession(model, _policy(OffloadPolicy, "memascend",
                                      tmp_store_root, "float32"))
    real_write = s.store.write

    def flaky_write(key, data):
        if key == "block_000/attn.w_o.v":
            raise IOError("injected write-back failure")
        return real_write(key, data)

    s.store.write = flaky_write
    s.train_step(*batch)
    with pytest.raises(IOError, match="injected write-back"):
        s.train_step(*batch)
    assert s.optimizer.staging_idle()
    assert s.pool.in_use_payload == 0
    s.close()
    s.tracker.assert_quiescent()


@pytest.mark.parametrize("tier", ["host", "ssd", "recompute",
                                  ["ssd", "host"]])
def test_offloaded_act_tiers_raise_naming_their_slice(batch, tmp_store_root,
                                                      tier):
    """Every offloaded tier, chosen through the reference builder's
    ``with_activations``, trains a step with the loss and landed gradients
    of device-resident checkpoints, bit for bit (the name dates from when
    these tiers raised at construction); an unknown tier is refused at
    build, as in the reference."""
    units = _units("float32").units
    runs = {}
    for key, act in (("device", "device"), ("tier", tier)):
        model = from_numpy_units(TCFG, units, torch.float32, device="cpu")
        builder = (OffloadPolicy.preset("memascend")
                   .with_store(f"{tmp_store_root}/{key}")
                   .with_adam(compute_dtype="float32"))
        policy = (builder.with_overrides(offload_checkpoints=False).build()
                  if act == "device" else
                  builder.with_activations(act).build())
        with OffloadSession(model, policy) as s:
            m = s.train_step(*batch)
            runs[key] = (m["loss"], np.array(s.flat, copy=True),
                         m["act_write_failures"])
        s.tracker.assert_quiescent()
    tier_loss, tier_grads, failures = runs["tier"]
    assert tier_loss == runs["device"][0] and failures == 0
    np.testing.assert_array_equal(tier_grads, runs["device"][1])
    with pytest.raises(ValueError, match="act_policy"):
        OffloadPolicy.preset("memascend").with_store(
            tmp_store_root).with_activations("device").build()
