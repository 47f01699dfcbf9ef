"""The paper's three presets through both packages' offloaded trainer, on
the same numpy units and batch: ``zero-infinity`` (pow2 pinned
allocations, the fixed buffer pool, the chained host overflow screen,
per-tensor files), ``memascend`` and ``memascend-bf16`` (bf16 master, m
and v), plus the overlap ablation within the port.  These are the arms
of ``chip_smoke.py``'s comparison phase, at a size the CPU runs.

Tolerances, each with its reason:

* losses at fp32 compute: rtol 1e-5 (the same fp32 math in another
  summation order, as in ``tests/test_torch_train.py``);
* the memory tracker's peak and every component's requested and reserved
  peaks: equal byte for byte (the port keeps the reference's census,
  allocators and pools).  One stated exception: under the fused presets
  the port screens gradients on the device and charges ``overflow_tmp``
  nothing, while the reference's host screen charges chunks of at most 4
  MiB (``ROADMAP.md`` Queue 3), so their total peak differs by that
  component's peak and by nothing else (the port's total is lower by at
  most the chunk the reference had live at its peak);
* within the port, zero-infinity == memascend == sync == h2d losses bit
  for bit over three steps, and memascend-bf16 equal at step 1 (its bf16
  state rounds from the first update on);
* ``optimizer_io_bytes`` a step: exactly what ``AdamConfig``'s state and
  compute widths predict (``OffloadedAdam.io_bytes_per_param`` without a
  gradient spill), in both packages; the bf16 arm's ratio to the fp32
  arm's is the one the chip phase holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import OffloadPolicy as JPolicy, OffloadSession as JSession
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import OffloadedAdam, OffloadPolicy, OffloadSession
from repro_torch.core.model_adapter import from_numpy_units

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256, qk_norm=True)
JCFG, TCFG = JConfig(**KW), ModelConfig(**KW)
STEPS = 3
PRESETS = ("zero-infinity", "memascend", "memascend-bf16")
COMPONENTS_PEAKS = ("peak_requested", "peak_allocated")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jmodel():
    return jax_lm(JCFG, jax.random.PRNGKey(0), jnp.float32)


def _policy(pkg_policy, preset, root, overlap="full", compute="float32"):
    return (pkg_policy.preset(preset).with_store(root)
            .with_adam(lr=1e-3, compute_dtype=compute)
            .with_overlap(overlap).build())


def _run(session, batch):
    """Losses, the io bytes of each step's Adam (complete after
    ``synchronize``) and the tracker's peaks."""
    losses, io = [], []
    for _ in range(STEPS):
        losses.append(session.train_step(*batch)["loss"])
        session.synchronize()
        io.append(session.optimizer.last_io_bytes)
    t = session.tracker
    return {"losses": losses, "io": io,
            "peak_allocated": t.peak_allocated,
            "peak_requested": t.peak_requested,
            "components": t.breakdown(),
            "params": session.total_params}


def _port(jm, batch, root, preset, overlap="full", compute="float32"):
    model = from_numpy_units(TCFG, jm.units, getattr(torch, compute),
                             device="cpu")
    with OffloadSession(model, _policy(OffloadPolicy, preset, root,
                                       overlap, compute)) as s:
        return _run(s, batch)


def _jax(jm, batch, root, preset):
    with JSession(jm, _policy(JPolicy, preset, root)) as s:
        return _run(s, batch)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_matches_the_reference(jmodel, batch, tmp_store_root,
                                      preset):
    """Losses at rtol 1e-5; the tracker's peaks and every component's
    peaks equal byte for byte but the fused presets' overflow_tmp."""
    j = _jax(jmodel, batch, tmp_store_root + "/j", preset)
    t = _port(jmodel, batch, tmp_store_root + "/t", preset)
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    assert t["io"] == j["io"]
    assert sorted(t["components"]) == sorted(j["components"]) or \
        sorted(set(j["components"]) - set(t["components"])) == \
        ["overflow_tmp"]
    fused = preset != "zero-infinity"
    for name, ref in j["components"].items():
        got = t["components"].get(name, {k: 0 for k in ref})
        for key in COMPONENTS_PEAKS:
            if fused and name == "overflow_tmp":
                assert got[key] == 0 and 0 < ref[key] <= 4 << 20
            else:
                assert got[key] == ref[key], (name, key)
    # the total: equal, or (fused) lower by at most the reference's
    # screen chunk live at its peak
    tmp = j["components"].get("overflow_tmp", {}) if fused else {}
    for key in COMPONENTS_PEAKS:
        assert 0 <= j[key] - t[key] <= tmp.get(key, 0), key
        assert (j[key] > t[key]) == fused, key


def test_zero_infinity_charges_the_chained_screen(jmodel, batch,
                                                  tmp_store_root):
    """The baseline's pinned bytes are pow2-rounded and its screen's
    temporaries peak at 1.25x the gradient flat buffer, in both."""
    for run in (_jax(jmodel, batch, tmp_store_root + "/j", "zero-infinity"),
                _port(jmodel, batch, tmp_store_root + "/t",
                      "zero-infinity")):
        comps = run["components"]
        assert comps["overflow_tmp"]["peak_allocated"] == \
            int(1.25 * 4 * run["params"])
        pinned = comps["pinned"]
        assert pinned["peak_allocated"] > pinned["peak_requested"]


def test_port_presets_and_overlap_levels_are_bit_equal(jmodel, batch,
                                                       tmp_store_root):
    """zero-infinity, memascend and memascend at sync / h2d overlap: the
    same losses bit for bit over three steps; memascend-bf16 equal at
    step 1 and apart after its first bf16 state update."""
    runs = {name: _port(jmodel, batch, f"{tmp_store_root}/{name}", preset,
                        overlap)
            for name, preset, overlap in (
                ("memascend", "memascend", "full"),
                ("zero-infinity", "zero-infinity", "full"),
                ("sync", "memascend", "sync"),
                ("h2d", "memascend", "h2d"),
                ("memascend-bf16", "memascend-bf16", "full"))}
    ref = [float(x).hex() for x in runs["memascend"]["losses"]]
    for name in ("zero-infinity", "sync", "h2d"):
        assert [float(x).hex() for x in runs[name]["losses"]] == ref, name
    bf16 = runs["memascend-bf16"]["losses"]
    assert float(bf16[0]).hex() == ref[0]
    assert np.isfinite(bf16).all()


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_optimizer_io_bytes_follow_the_state_width(jmodel, batch,
                                                   tmp_store_root, compute):
    """Every step's ``optimizer_io_bytes`` is the parameter count times
    (master, m, v read and written at state width + compute weights
    written), so the bf16 arm's bytes over the fp32 arm's are
    ``io_bytes_per_param`` of the one over the other's (14 / 26 at the
    presets' bf16 compute, as the chip phase holds)."""
    io = {}
    for preset in ("memascend", "memascend-bf16"):
        run = _port(jmodel, batch, f"{tmp_store_root}/{preset}", preset,
                    compute=compute)
        adam = (OffloadPolicy.preset(preset).with_store("unused")
                .with_adam(compute_dtype=compute).build().adam)
        per = OffloadedAdam.io_bytes_per_param(adam,
                                               include_grad_offload=False)
        assert run["io"] == [per * run["params"]] * STEPS
        io[preset] = (run["io"][-1], per)
    (fp32, per32), (bf16, per16) = io["memascend"], io["memascend-bf16"]
    assert bf16 * per32 == fp32 * per16
    if compute == "bfloat16":
        assert (per16, per32) == (14, 26)
