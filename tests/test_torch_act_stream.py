"""Activation-checkpoint streaming in the port: the host/ssd/recompute
tiers of ``act_policy`` against the reference package's session, and the
port's activation stream under fault injection.

The same numpy units (the reference's ``make_offloadable_lm`` at fp32)
and the same two seeded ``repro.data`` batches go through both packages'
``OffloadSession`` under the ``memascend`` preset.  Tolerances, each with
its reason:

* port vs reference: the two step losses within rtol 1e-5 — the same fp32
  math in another summation order (the training-step precedent of
  ``tests/test_torch_train.py``);
* within the port: losses and step-1 landed gradients bit for bit equal
  across every tier, every overlap mode and ``offload_checkpoints=False``
  — a tier only moves a checkpoint's bytes, and a recompute re-runs the
  forward's own op on the same inputs;
* the tracker's ``activation_checkpoints`` peak equal to the reference's
  under ``overlap="sync"``, where every save, read and free runs on the
  executor in plan order (under ``full`` the staging worker's timing
  decides how many fetch buffers overlap).
"""

import functools
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import OffloadPolicy as JPolicy, OffloadSession as JSession
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.data import DataLoader, SyntheticTextDataset
from repro_torch.configs.base import ModelConfig
from repro_torch.core import OffloadPolicy, OffloadSession
from repro_torch.core.model_adapter import from_numpy_units

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab=256)
# tier spec -> (layers, act_policy)
SPECS = {"host": (2, "host"), "ssd": (2, "ssd"),
         "recompute": (2, "recompute"), "ssd-host": (2, ["ssd", "host"]),
         "mixed3": (3, ["ssd", "host", "recompute"])}
OVERLAPS = ("full", "h2d", "sync")


def _batches():
    out = []
    for seed in (1, 2):
        b = DataLoader(SyntheticTextDataset(vocab=256, seed=seed), batch=2,
                       seq_len=32).next_batch()
        out.append((b["tokens"], b["labels"]))
    return out


BATCHES = _batches()


@functools.cache
def _jmodel(layers: int):
    return jax_lm(JConfig(**KW, n_layers=layers), jax.random.PRNGKey(0),
                  jnp.float32)


def _tmodel(layers: int, compute=torch.float32):
    return from_numpy_units(ModelConfig(**KW, n_layers=layers),
                            _jmodel(layers).units, compute, device="cpu")


def _policy(pkg, root, act, overlap="full", compute="float32"):
    b = (pkg.preset("memascend").with_store(root)
         .with_adam(lr=1e-3, compute_dtype=compute).with_overlap(overlap))
    if act == "device":
        return b.with_overrides(offload_checkpoints=False).build()
    return b.with_activations(act).build()


def _run(session):
    """Two train steps: losses, the step-1 flat gradient buffer, the
    activation-checkpoint peak and the last step's metrics."""
    losses, grads = [], None
    with session as s:
        for tokens, labels in BATCHES:
            m = s.train_step(tokens, labels)
            losses.append(m["loss"])
            if grads is None:
                grads = np.array(s.flat, copy=True)
        peak = s.tracker.component("activation_checkpoints").peak_allocated
    s.tracker.assert_quiescent()
    return losses, grads, peak, m


class _Baselines:
    """The reference's run of each tier spec (under ``sync``) and the
    port's device-tier run at each depth, each made once per module."""

    def __init__(self, root: str):
        self.root = root
        self._runs: dict[str | int, tuple] = {}   # spec or depth -> run

    def reference(self, spec: str) -> tuple:
        if spec not in self._runs:
            layers, act = SPECS[spec]
            self._runs[spec] = _run(JSession(_jmodel(layers), _policy(
                JPolicy, f"{self.root}/ref-{spec}", act, "sync")))
        return self._runs[spec]

    def device_tier(self, layers: int) -> tuple:
        if layers not in self._runs:
            self._runs[layers] = _run(OffloadSession(
                _tmodel(layers), _policy(OffloadPolicy,
                                         f"{self.root}/dev-{layers}",
                                         "device")))
        return self._runs[layers]


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    return _Baselines(str(tmp_path_factory.mktemp("act_baselines")))


@pytest.mark.parametrize("overlap", OVERLAPS)
@pytest.mark.parametrize("spec", list(SPECS))
def test_tier_matches_reference_and_device_tier(baselines, tmp_store_root,
                                                spec, overlap):
    layers, act = SPECS[spec]
    losses, grads, peak, m = _run(OffloadSession(_tmodel(layers), _policy(
        OffloadPolicy, tmp_store_root, act, overlap)))
    ref_losses, _ref_grads, ref_peak, _ = baselines.reference(spec)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    dev_losses, dev_grads, dev_peak, _ = baselines.device_tier(layers)
    assert losses == dev_losses
    np.testing.assert_array_equal(grads, dev_grads)
    assert dev_peak == 0 and peak > 0
    if overlap == "sync":
        assert peak == ref_peak
    assert m["act_write_failures"] == 0
    assert m["act_save_wait_s"] >= 0.0 and m["act_fetch_wait_s"] >= 0.0


def test_preset_as_shipped_trains(tmp_store_root):
    """``memascend`` with no override (the host tier, overlap full)."""
    policy = OffloadPolicy.preset("memascend").with_store(
        tmp_store_root).build()
    assert policy.offload_checkpoints and policy.act_policy == "host"
    with OffloadSession(_tmodel(2), policy) as s:
        assert s._act_tiers == ("host", "host")
        m = s.train_step(*BATCHES[0])
        snap = s.overlap_snapshot()
    assert np.isfinite(m["loss"]) and m["applied"]
    assert snap["act_stage_gets"] == 2
    s.tracker.assert_quiescent()


def test_recompute_rederives_the_forward_checkpoint_bitwise(tmp_store_root):
    """The checkpoint ``block_recompute`` binds for block 1 is bitwise
    the input the forward saved for it under the device tier."""
    bound = {}
    for act in ("device", "recompute"):
        with OffloadSession(_tmodel(2), _policy(
                OffloadPolicy, f"{tmp_store_root}/{act}", act)) as s:
            real = s._bind_checkpoint
            seen = bound[act] = []

            def bind(unit, h, real=real, seen=seen):
                seen.append((unit, h.clone()))
                return real(unit, h)

            s._bind_checkpoint = bind
            s.train_step(*BATCHES[0])
    assert [u for u, _ in bound["device"]] == ["block_000", "block_001"]
    # recompute: block 0 saved in the forward, block 1 re-derived
    assert [u for u, _ in bound["recompute"]] == ["block_000", "block_001"]
    for (_u, a), (_v, b) in zip(bound["device"], bound["recompute"],
                                strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("act", ["host", "ssd"])
def test_bf16_checkpoints_come_back_bit_for_bit(tmp_store_root, act):
    """bf16 checkpoints travel as uint16 bits and come back in their own
    dtype: two bf16 steps equal the device tier's bit for bit."""
    runs = {}
    for tier in ("device", act):
        runs[tier] = _run(OffloadSession(
            _tmodel(2, torch.bfloat16),
            _policy(OffloadPolicy, f"{tmp_store_root}/{tier}", tier,
                    compute="bfloat16")))
    assert runs[act][0] == runs["device"][0]
    np.testing.assert_array_equal(runs[act][1], runs["device"][1])


# -- fault injection (the reference's tests/test_act_stream.py) --------------

def _session(root, tier, overlap="full"):
    return OffloadSession(_tmodel(2), _policy(OffloadPolicy, root, tier,
                                              overlap))


def _assert_act_drained(s):
    """Abort/close invariant: the activation stream released every
    tracker handle and counted device slot."""
    assert s.tracker.component("activation_checkpoints").live_allocated == 0
    if s._device_slots is not None:
        assert s._device_slots.idle()


def test_failed_ssd_write_degrades_to_host_tier(tmp_store_root):
    """An act-store write failure must not fail the step: the host copy
    is re-marked live and the checkpoint serves from the host tier, with
    the same loss as an unbroken run."""
    with _session(f"{tmp_store_root}/clean", "ssd") as s:
        clean_loss = s.train_step(*BATCHES[0])["loss"]
    s.tracker.assert_quiescent()

    with _session(f"{tmp_store_root}/broken", "ssd") as s:
        real_write = s.store.write

        def flaky_write(key, data):
            if key.startswith("__act__/"):
                raise IOError("injected act write failure")
            return real_write(key, data)

        s.store.write = flaky_write
        m = s.train_step(*BATCHES[0])
        assert m["act_write_failures"] == 2
        assert m["loss"] == clean_loss
        _assert_act_drained(s)
    s.tracker.assert_quiescent()


def test_failed_act_prefetch_surfaces_once_at_gate(tmp_store_root):
    """A failed act read is delivered exactly once, at that checkpoint's
    ActFetchOp; the abort drains every slot and handle, and the session
    trains again once the store recovers."""
    with _session(f"{tmp_store_root}/s", "ssd") as s:
        real_read_async = s.store.read_async

        def failing_read_async(key, out):
            if key.startswith("__act__/"):
                f = Future()
                f.set_exception(IOError("injected act read failure"))
                return f
            return real_read_async(key, out)

        s.store.read_async = failing_read_async
        with pytest.raises(IOError, match="injected act read"):
            s.train_step(*BATCHES[0])
        assert len(s.swapper._inflight) == 0
        _assert_act_drained(s)

        s.store.read_async = real_read_async
        m = s.train_step(*BATCHES[0])   # recovered
        assert np.isfinite(m["loss"])
        _assert_act_drained(s)
    s.tracker.assert_quiescent()


def test_act_read_submit_failure_does_not_leak(tmp_store_root):
    """read_async raising *synchronously* fails at the issue site — the
    staging buffer's tracker handle must still be freed."""
    with _session(f"{tmp_store_root}/s", "ssd") as s:
        def exploding_read_async(key, out):
            raise RuntimeError("injected submit failure")

        s.store.read_async = exploding_read_async
        with pytest.raises(RuntimeError, match="injected submit"):
            s.train_step(*BATCHES[0])
        _assert_act_drained(s)
    s.tracker.assert_quiescent()


def test_abort_mid_backward_drains_act_stream(tmp_store_root):
    """block_bwd failing mid-backward aborts with saves resolved, staged
    fetches waited out, and activation live bytes back to zero."""
    with _session(f"{tmp_store_root}/s", "ssd") as s:
        calls = {"n": 0}
        real_bwd = s._block_bwd

        def flaky_bwd(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:    # first block_bwd: acts still in flight
                raise RuntimeError("injected backward failure")
            return real_bwd(*a, **kw)

        s._block_bwd = flaky_bwd
        with pytest.raises(RuntimeError, match="injected backward"):
            s.train_step(*BATCHES[0])
        assert len(s.swapper._inflight) == 0
        _assert_act_drained(s)
    s.tracker.assert_quiescent()
