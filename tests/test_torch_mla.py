"""MLA (DeepSeek-V3 multi-head latent attention) in the port against the
reference, at ``deepseek-v3-671b.reduced()`` widths.

The same numpy inputs and weights go through both packages.  Tolerances,
each with its reason:

* the four MLA functions and ``mla_decode``, fp32: within rel 1e-5 of the
  output's max — the same fp32 math, products summed in another order;
* ``mla_decode`` against the parallel forward (the reference's
  ``test_mla_decode_matches_parallel_forward``, ported): rtol/atol 2e-3,
  the reference's own bound, with router capacity 16 so the prefill drops
  no token (decode never does);
* two offloaded train steps, fp32: step 1 within rel 1e-6 of the
  reference's session (the same units, the same fp32 ops); step 2 within
  rel 1e-4, because Adam's first update is g / (|g| + eps) — gradient
  entries within fp32 noise of eps = 1e-8 (36 of 772,032 here, measured
  against ``jax.grad``; every gradient agrees within 7e-7 of its tensor's
  max) move by up to half of lr differently, which moves the step-2 loss
  by ~1e-5; routed expert paging equal to all-resident bit for bit
  (unrouted rows are never read);
* uncached greedy tokens, fp32: equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import memascend_policy as jax_policy
from repro.core import OffloadSession as JSession
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.models import attention as jatt
from repro.serve import OffloadedDecoder as JDecoder
from repro_torch.configs import get_config
from repro_torch.core import DecodeSpec, OffloadSession, memascend_policy
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.models import attention as tatt
from repro_torch.models import build
from repro_torch.serve import OffloadedDecoder

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
JCFG, TCFG = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
RTOL = 1e-5


def _mla_params(rng, cfg):
    """One MLA mixer's weights (norm weights nonzero, so they count)."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    shapes = {"attn.w_dq": (d, m.q_lora_rank),
              "attn.q_lat_norm": (m.q_lora_rank,),
              "attn.w_uq": (m.q_lora_rank,
                            h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
              "attn.w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
              "attn.kv_lat_norm": (m.kv_lora_rank,),
              "attn.w_ukv": (m.kv_lora_rank,
                             h * (m.qk_nope_head_dim + m.v_head_dim)),
              "attn.w_o": (h * m.v_head_dim, d)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0] if len(s) > 1
                                                   else 10.0))
            .astype(np.float32) for k, s in shapes.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _mla_case(name):
    rng = np.random.default_rng(0)
    params = _mla_params(rng, TCFG)
    b, s = 2, 12
    x = rng.standard_normal((b, s, TCFG.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    if name == "mla_project_q":
        return (jatt.mla_project_q(jp, jx, JCFG, jpos),
                tatt.mla_project_q(tp, tx, TCFG, tpos))
    if name == "mla_compress_kv":
        jc, jr = jatt.mla_compress_kv(jp, jx, JCFG, jpos)
        tc, tr = tatt.mla_compress_kv(tp, tx, TCFG, tpos)
        return (jnp.concatenate([jc, jr], -1), torch.cat([tc, tr], -1))
    if name == "mla_expand_kv":
        latent = rng.standard_normal(
            (b, s, TCFG.mla.kv_lora_rank + TCFG.mla.qk_rope_head_dim)
        ).astype(np.float32)
        r = TCFG.mla.kv_lora_rank
        jk, jv = jatt.mla_expand_kv(jp, jnp.asarray(latent[..., :r]),
                                    jnp.asarray(latent[..., r:]), JCFG)
        lat = torch.from_numpy(latent)
        tk, tv = tatt.mla_expand_kv(tp, lat[..., :r], lat[..., r:], TCFG)
        return (jnp.concatenate([jk.reshape(b, s, -1), jv.reshape(b, s, -1)],
                                -1),
                torch.cat([tk.reshape(b, s, -1), tv.reshape(b, s, -1)], -1))
    if name == "mla_attention":
        return (jatt.mla_attention(jp, jx, JCFG),
                tatt.mla_attention(tp, tx, TCFG))
    # mla_decode: one token against a cache holding 7 earlier latents
    s_max, n = 10, 7
    cache = (rng.standard_normal(
        (b, s_max, TCFG.mla.kv_lora_rank + TCFG.mla.qk_rope_head_dim))
        .astype(np.float32))
    jout, jc = jatt.mla_decode(jp, jx[:, :1], JCFG,
                               {"ckv": jnp.asarray(cache)}, jnp.int32(n))
    tcache = torch.from_numpy(cache)
    tout, tc = tatt.mla_decode(tp, tx[:, :1], TCFG, {"ckv": tcache}, n)
    assert torch.equal(tcache, torch.from_numpy(cache))   # not mutated
    return (jnp.concatenate([jout.reshape(b, -1), jc["ckv"].reshape(b, -1)],
                            -1),
            torch.cat([tout.reshape(b, -1), tc["ckv"].reshape(b, -1)], -1))


@pytest.mark.parametrize("name", ["mla_project_q", "mla_compress_kv",
                                  "mla_expand_kv", "mla_attention",
                                  "mla_decode"])
def test_mla_functions_match_reference_fp32(name):
    want, got = _mla_case(name)
    _close(got, want)


def test_expanded_k_rope_is_shared_by_every_head():
    rng = np.random.default_rng(1)
    tp = {k: torch.from_numpy(v) for k, v in _mla_params(rng, TCFG).items()}
    r, rope = TCFG.mla.kv_lora_rank, TCFG.mla.qk_rope_head_dim
    lat = torch.from_numpy(rng.standard_normal((1, 5, r + rope))
                           .astype(np.float32))
    k, _v = tatt.mla_expand_kv(tp, lat[..., :r], lat[..., r:], TCFG)
    for head in range(TCFG.n_heads):
        assert torch.equal(k[:, :, head, -rope:], lat[..., r:])


def test_mla_decode_matches_parallel_forward():
    # ample router capacity: the prefill drops over-capacity tokens (a
    # batched approximation decode does not share), a semantic difference,
    # not an MLA-cache fault
    cfg = dataclasses.replace(
        TCFG, mtp=False, n_layers=2,
        moe=dataclasses.replace(TCFG.moe, capacity_factor=16.0))
    impl = build(cfg, compute_dtype=torch.float32, device="cpu")
    params = impl.init_params(0)
    s = 10
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, s)))
    with torch.no_grad():
        full = impl.prefill_fn(params, {"tokens": tokens})
        cache = impl.init_cache(1, s, dtype=torch.float32)
        for t in range(s):
            logits, cache = impl.decode_fn(params, cache, tokens[:, t:t + 1],
                                           t)
            np.testing.assert_allclose(logits[0, 0].numpy(),
                                       full[0, t].numpy(), rtol=2e-3,
                                       atol=2e-3)


def _policies(root, paging):
    pol = {}
    for pkg, fn in (("jax", jax_policy), ("torch", memascend_policy)):
        pol[pkg] = fn(f"{root}/{pkg}_{paging}", lr=1e-2,
                      compute_dtype="float32").replace(
            expert_paging=paging, expert_page_slots=8)
    return pol


def test_offloaded_mla_training_matches_reference(tmp_store_root):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, TCFG.vocab, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    jmodel = jax_lm(JCFG, jax.random.PRNGKey(0), jnp.float32,
                    expert_paging="routed")
    losses = {}
    for paging in ("routed", "all"):
        pol = _policies(tmp_store_root, paging)
        for pkg, session, model in (
                ("jax", JSession, jmodel),
                ("torch", OffloadSession,
                 from_numpy_units(TCFG, jmodel.units, torch.float32,
                                  device="cpu"))):
            if pkg == "jax" and paging == "all":
                continue
            with session(model, pol[pkg]) as s:
                losses[pkg, paging] = [
                    float(s.train_step(tokens, labels)["loss"])
                    for _ in range(2)]
    got, want = losses["torch", "routed"], losses["jax", "routed"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    assert losses["torch", "routed"] == losses["torch", "all"]
    assert losses["torch", "routed"][1] < losses["torch", "routed"][0]


def test_uncached_mla_tokens_match_reference(tmp_store_root):
    prompts = np.random.default_rng(6).integers(
        0, TCFG.vocab, (2, 6)).astype(np.int32)
    jmodel = jax_lm(JCFG, jax.random.PRNGKey(0), jnp.float32,
                    expert_paging="routed")
    pol = _policies(tmp_store_root, "routed")
    with JDecoder(jmodel, pol["jax"]) as dec:
        want = dec.generate(prompts, 4, use_cache=False)
    model = from_numpy_units(TCFG, jmodel.units, torch.float32, device="cpu")
    with OffloadedDecoder(model, pol["torch"]) as dec:
        got = dec.generate(prompts, 4, use_cache=False)
    np.testing.assert_array_equal(got, want)


def test_mla_decode_spec_session_raises(tmp_store_root):
    jmodel = jax_lm(JCFG, jax.random.PRNGKey(0), jnp.float32)
    model = from_numpy_units(TCFG, jmodel.units, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="cached-decode"):
        OffloadSession(model, memascend_policy(tmp_store_root),
                       mode="serve",
                       decode=DecodeSpec(batch=1, max_seq=16, bucket=8))
