"""The MoE FFN in the port (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``), the reference's routing property suite
(``tests/test_moe_routing.py``) translated, and the offloaded training
losses of two MoE configs against the reference's session.

The same numpy inputs go through both packages.  Tolerances, each with its
reason:

* fp32: outputs within 1e-6 of the output's max (and the aux loss within
  1e-6 relative) — the same fp32 math, the expert products and softmax
  summed in another order;
* bf16: outputs within 8 bf16 ULPs of each row's max (the repo's
  decode-audit bound, ``benchmarks/bench_decode.py``) — the two
  frameworks round bf16 elementwise math (``silu`` above all) at other
  places;
* routing indices: equal — the port's top-k orders ties as
  ``jax.lax.top_k`` does (the lower expert index first);
* the pinned-``idx`` path: bit for bit the free top-k path;
* offloaded two-step losses at fp32: within rtol 1e-5, the training-step
  precedent of ``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.configs import get_config as jax_config
from repro.configs.base import ModelConfig as JConfig, MoEConfig as JMoE
from repro.core import memascend_policy as jax_policy
from repro.core import OffloadSession as JSession
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import OffloadSession, memascend_policy
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.models.moe import _positions_in_expert, moe_ffn, router_topk

torch.set_num_threads(2)

SET = settings(max_examples=25, deadline=None,
               suppress_health_check=[HealthCheck.too_slow])
ULP_TOL = 8.0 * 2.0 ** -8
BF16 = ml_dtypes.bfloat16


def _cfgs(n_experts=8, top_k=2, capacity_factor=1.25, shared=0):
    kw = dict(name="prop-moe", family="moe", n_layers=1, d_model=16,
              n_heads=2, n_kv_heads=1, d_ff=32, vocab=64)
    moe = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=16,
               capacity_factor=capacity_factor, n_shared=shared)
    return JConfig(**kw, moe=JMoE(**moe)), ModelConfig(**kw,
                                                       moe=MoEConfig(**moe))


def _params(rng, cfg):
    e, d = cfg.moe, cfg.d_model
    shapes = {"moe.w_router": (d, e.n_experts),
              "moe.w_gate": (e.n_experts, d, e.d_ff_expert),
              "moe.w_up": (e.n_experts, d, e.d_ff_expert),
              "moe.w_down": (e.n_experts, e.d_ff_expert, d)}
    if e.n_shared:
        f = e.n_shared * e.d_ff_expert
        shapes.update({"moe.shared_gate": (d, f), "moe.shared_up": (d, f),
                       "moe.shared_down": (f, d)})
    return {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
            for k, s in shapes.items()}


def _both(params, x, dtype):
    """(jax params, x), (torch params, x) in ``dtype`` from fp32 numpy."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    return (({k: jnp.asarray(v, jd) for k, v in params.items()},
             jnp.asarray(x, jd)),
            ({k: torch.from_numpy(v).to(td) for k, v in params.items()},
             torch.from_numpy(x).to(td)))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# -- the port against the reference -------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_matches_reference_fp32(capacity_factor, shared):
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor, shared=shared)
    rng = np.random.default_rng(0)
    params = _params(rng, tcfg)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    (jp, jx), (tp, tx) = _both(params, x, "float32")
    jout, jaux = jmoe.moe_ffn(jp, jx, jcfg)
    tout, taux = moe_ffn(tp, tx, tcfg)
    jout, tout = _f32(jout), _f32(tout)
    assert np.abs(tout - jout).max() <= 1e-6 * np.abs(jout).max()
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference_bf16(capacity_factor):
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    rng = np.random.default_rng(1)
    params = _params(rng, tcfg)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    (jp, jx), (tp, tx) = _both(params, x, "bfloat16")
    # the routing must agree for the outputs to be comparable at all
    jlogits = jx.reshape(-1, tcfg.d_model) @ jp["moe.w_router"]
    tlogits = tx.reshape(-1, tcfg.d_model) @ tp["moe.w_router"]
    np.testing.assert_array_equal(
        np.asarray(jmoe.router_topk(jlogits, 2)[1]),
        router_topk(tlogits, 2)[1].numpy())
    jout = _f32(jmoe.moe_ffn(jp, jx, jcfg)[0]).reshape(-1, tcfg.d_model)
    tout = _f32(moe_ffn(tp, tx, tcfg)[0]).reshape(-1, tcfg.d_model)
    scale = np.maximum(np.abs(jout).max(-1, keepdims=True), 1e-3)
    assert (np.abs(tout - jout) / scale).max() <= ULP_TOL


def test_topk_ties_resolve_to_the_lower_index():
    """Rows of equal logits (four-way ties, a tie at the k-th place): the
    port picks the experts ``jax.lax.top_k`` picks, in its order."""
    logits = np.array([[1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0],
                       [0.0, 2.0, 0.0, 2.0, 0.0, 1.0, 1.0, 1.0],
                       [3.0, 0.5, 0.5, 3.0, 0.5, 3.0, 0.5, 0.5],
                       [0.0] * 8], np.float32)
    for k in (1, 2, 3):
        _jw, jidx, _ = jmoe.router_topk(jnp.asarray(logits), k)
        tw, tidx, _ = router_topk(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(_jw), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pinned_idx_equals_free_topk_bitwise(dtype):
    _jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    params = _params(rng, tcfg)
    x = rng.standard_normal((1, 20, tcfg.d_model)).astype(np.float32)
    _j, (tp, tx) = _both(params, x, dtype)
    free, aux_free = moe_ffn(tp, tx, tcfg)
    logits = tx.reshape(-1, tcfg.d_model) @ tp["moe.w_router"]
    _w, idx, _aux = router_topk(logits, tcfg.moe.top_k)
    pinned, aux_pin = moe_ffn(tp, tx, tcfg, idx=idx)
    assert torch.equal(free, pinned) and torch.equal(aux_free, aux_pin)


def test_positions_in_expert_matches_reference():
    rng = np.random.default_rng(3)
    for n, n_experts in ((1, 1), (17, 3), (96, 8), (64, 1)):
        flat = rng.integers(0, n_experts, n).astype(np.int64)
        np.testing.assert_array_equal(
            _positions_in_expert(torch.from_numpy(flat), n).numpy(),
            np.asarray(jmoe._positions_in_expert(
                jnp.asarray(flat, jnp.int32), n)))


# -- tests/test_moe_routing.py, translated ------------------------------------

@SET
@given(seed=st.integers(0, 2**31 - 1), t=st.integers(1, 48),
       n_experts=st.integers(2, 16), top_k=st.integers(1, 4))
def test_router_topk_invariants(seed, t, n_experts, top_k):
    top_k = min(top_k, n_experts)
    logits = (np.random.default_rng(seed).standard_normal((t, n_experts))
              * 3.0).astype(np.float32)
    w, idx, aux = router_topk(torch.from_numpy(logits), top_k)
    w, idx = w.numpy(), idx.numpy()
    # normalized over the chosen k
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-5)
    assert (w >= 0).all()
    # every chosen index is a true top-k member of its softmax row
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    kth = np.sort(probs, axis=-1)[:, -top_k]
    assert (np.take_along_axis(probs, idx, axis=-1)
            >= kth[:, None] - 1e-12).all()
    # indices are distinct per token (top_k never repeats a column)
    for row in idx:
        assert len(set(row.tolist())) == top_k
    assert np.isfinite(float(aux)) and float(aux) >= 0


@SET
@given(seed=st.integers(0, 2**31 - 1), t=st.integers(1, 24))
def test_pinned_idx_path_matches_topk_bitwise(seed, t):
    """moe_ffn(idx=...) — the expert-paging path — regathers weights
    bitwise equal to the top-k values and produces the identical output."""
    _jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy(v) for k, v in _params(rng, cfg).items()}
    x = torch.from_numpy(rng.standard_normal(
        (1, t, cfg.d_model)).astype(np.float32))
    out_free, aux_free = moe_ffn(params, x, cfg)
    logits = x.reshape(t, cfg.d_model) @ params["moe.w_router"]
    _w, idx, _aux = router_topk(logits, cfg.moe.top_k)
    out_pin, aux_pin = moe_ffn(params, x, cfg, idx=idx)
    assert torch.equal(out_free, out_pin) and torch.equal(aux_free, aux_pin)


def _positions_oracle(flat_e: np.ndarray) -> np.ndarray:
    """First-come rank of each entry within its expert id (numpy)."""
    seen: dict[int, int] = {}
    pos = np.zeros_like(flat_e)
    for i, e in enumerate(flat_e.tolist()):
        pos[i] = seen.get(e, 0)
        seen[e] = pos[i] + 1
    return pos


@SET
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 96),
       n_experts=st.integers(1, 8))
def test_positions_in_expert_matches_oracle(seed, n, n_experts):
    flat = np.random.default_rng(seed).choice(n_experts, size=n)
    got = _positions_in_expert(torch.from_numpy(flat.astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy(), _positions_oracle(flat))


def test_positions_in_expert_all_same_expert():
    """Worst-case duplicates: every assignment lands on one expert."""
    got = _positions_in_expert(torch.zeros(64, dtype=torch.int64), 64)
    np.testing.assert_array_equal(got.numpy(), np.arange(64))


@SET
@given(seed=st.integers(0, 2**31 - 1), t=st.integers(4, 32))
def test_capacity_drop_determinism_at_chunk_boundaries(seed, t):
    """The kept set is a pure function of the assignment: two identical
    calls at a capacity that forces drops agree bitwise."""
    _jcfg, cfg = _cfgs(capacity_factor=0.5)
    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy(v) for k, v in _params(rng, cfg).items()}
    x = torch.from_numpy(rng.standard_normal(
        (1, t, cfg.d_model)).astype(np.float32))
    out1, aux1 = moe_ffn(params, x, cfg)
    out2, aux2 = moe_ffn(params, x, cfg)
    assert torch.equal(out1, out2) and torch.equal(aux1, aux2)


@SET
@given(seed=st.integers(0, 2**31 - 1))
def test_dropped_tokens_contribute_zero(seed):
    """A (token, choice) pair past capacity adds exactly nothing: zeroing
    the dropped pairs' weights by hand reproduces the module's output."""
    _jcfg, cfg = _cfgs(n_experts=4, top_k=2, capacity_factor=0.25)
    t = 16
    rng = np.random.default_rng(seed)
    params = _params(rng, cfg)
    x = rng.standard_normal((1, t, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tx = torch.from_numpy(x)
    out, _aux = moe_ffn(tp, tx, cfg)
    logits = tx.reshape(t, cfg.d_model) @ tp["moe.w_router"]
    w, idx, _ = router_topk(logits, cfg.moe.top_k)
    w, idx = w.numpy(), idx.numpy()
    capacity = int(max(cfg.moe.top_k * t // cfg.moe.n_experts
                       * cfg.moe.capacity_factor, 4))
    flat_e = idx.reshape(-1)
    kept = _positions_oracle(flat_e) < capacity
    xf = x.reshape(t, cfg.d_model)
    y = np.zeros_like(xf)
    gate, up = params["moe.w_gate"], params["moe.w_up"]
    down = params["moe.w_down"]
    token_of = np.repeat(np.arange(t), cfg.moe.top_k)
    for p, (tok, e) in enumerate(zip(token_of, flat_e)):
        if not kept[p]:
            continue   # dropped: contributes exactly zero
        h = xf[tok]
        hid = h @ gate[e]
        hid = hid / (1 + np.exp(-hid)) * (h @ up[e])   # silu(g) * u
        y[tok] += w.reshape(-1)[p] * (hid @ down[e])
    np.testing.assert_allclose(out.numpy()[0], y, atol=2e-4)


# -- offloaded MoE training against the reference ------------------------------

def _qwen3_moe_tiny(pkg_config):
    """qwen3-30b-a3b's shape (qk-norm, 8:1 query:kv heads, 16:1
    experts:top-k, expert FFN at 3/8 of d_model) cut to a few layers and
    narrow widths."""
    cfg = pkg_config("qwen3-30b-a3b")
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, head_dim=8,
        d_ff=24, vocab=256,
        moe=dataclasses.replace(cfg.moe, n_experts=16, top_k=1,
                                d_ff_expert=24))


CASES = {
    "phi3.5-moe-reduced": (
        lambda: get_config("phi3.5-moe-42b-a6.6b").reduced(),
        lambda: jax_config("phi3.5-moe-42b-a6.6b").reduced(), "off"),
    "qwen3-30b-a3b-tiny": (lambda: _qwen3_moe_tiny(get_config),
                           lambda: _qwen3_moe_tiny(jax_config), "routed"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_offloaded_moe_losses_match_reference_fp32(case, tmp_store_root):
    tcfg_fn, jcfg_fn, paging = CASES[case]
    tcfg, jcfg = tcfg_fn(), jcfg_fn()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    jmodel = jax_lm(jcfg, jax.random.PRNGKey(0), jnp.float32,
                    expert_paging=paging)
    losses = {}
    for pkg, session, policy_fn, model in (
            ("jax", JSession, jax_policy, jmodel),
            ("torch", OffloadSession, memascend_policy,
             from_numpy_units(tcfg, jmodel.units, torch.float32,
                              device="cpu"))):
        policy = policy_fn(f"{tmp_store_root}/{pkg}", lr=1e-2,
                           compute_dtype="float32")
        if paging != "off":
            policy = policy.replace(expert_paging=paging,
                                    expert_page_slots=8)
        with session(model, policy) as s:
            losses[pkg] = [float(s.train_step(tokens, labels)["loss"])
                           for _ in range(2)]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][1] < losses["torch"][0]
