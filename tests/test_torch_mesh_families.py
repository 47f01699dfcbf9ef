"""The model families beyond dense and MoE — VLM prefix, the Mamba
hybrid, xLSTM (MLA + MoE + MTP and whisper in
``tests/test_torch_mesh_families_mla_audio.py``) — through the meshed
steps on the 1x1 host mesh (a ``gloo`` group of one rank), against the
port's unmeshed steps bit for bit at bf16 compute: the train step's loss,
every gathered gradient and the overflow flag, and two decode steps'
logits and caches under "zero3" and "tp" (whisper's cache prefilled with
the encoder's cross K/V first); then the meshed verify step against the
meshed serve chain.

On one rank every shard is the whole tensor and every collective moves
nothing, so a difference here is a difference in the local computation:
an op the mesh path runs in another order or layout (the model's DTensor
regions in ``repro_torch.models.dist`` keep the one-card ops).
"""

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, one_rank_group
from repro_torch.models import build
from repro_torch.models import whisper as whs
from repro_torch.serve.decode import build_serve_step, build_verify_step
from repro_torch.train.step import build_train_step, tree_leaves

torch.set_num_threads(2)

B, CACHE = 2, 16


def _batch(impl, cfg):
    gen = torch.Generator().manual_seed(1)
    specs = impl.input_specs(InputShape("t", 16 + (cfg.prefix_len or 0), B,
                                        "train"))
    out = {}
    for k, v in specs.items():
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   dtype=torch.int32)
        else:
            out[k] = torch.randn(v.shape, generator=gen).to(v.dtype)
    return specs, out


def _cache(impl, cfg, params, batch):
    cache = impl.init_cache(B, CACHE, torch.bfloat16, device="cpu")
    if cfg.family == "audio":
        with torch.no_grad():
            memory = whs.encode(cfg, params, batch["frames"])
        cache = whs.prefill_cross_cache(cfg, params, memory, cache)
    return cache


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(shd.full_tree(a)), tree_leaves(b)))


# the families beyond dense and MoE, which tests/test_torch_sharding.py
# (qwen3-4b) and tests/test_torch_mesh_gloo.py (+ phi3.5-moe) hold; MLA
# and whisper, the slowest to plan, are in
# tests/test_torch_mesh_families_mla_audio.py, so two workers share them
FAMILIES = ["paligemma-3b", "jamba-v0.1-52b", "xlstm-1.3b"]


def check_meshed_steps(arch):
    cfg = ARCHS[arch].reduced()
    impl = build(cfg, compute_dtype=torch.bfloat16, device="cpu")
    params = impl.init_params(0)
    specs, batch = _batch(impl, cfg)
    want_loss, want, want_ov = build_train_step(impl)(params, batch, 1.0)
    shape = InputShape("d", CACHE, B, "decode")
    serve, _s = build_serve_step(impl, shape)
    cache = _cache(impl, cfg, params, batch)
    toks = batch["tokens"][:, :2]
    with one_rank_group("gloo"):
        mesh = make_host_mesh(device_type="cpu")
        step, _in, _out = build_train_step(impl, mesh, batch_shape=specs)
        loss, grads, overflow = step(params, batch, 1.0)
        assert torch.equal(loss, want_loss)
        assert bool(overflow) == bool(want_ov)
        assert _equal(grads, want)
        for mode in ("zero3", "tp"):
            mserve, _i, _o, _a = build_serve_step(impl, shape, mesh,
                                                  param_mode=mode)
            c1 = c2 = cache
            for t in range(toks.shape[1]):
                a, c1 = serve(params, c1, toks[:, t:t + 1], t)
                b, c2 = mserve(params, c2, toks[:, t:t + 1], t)
                assert _equal(b, a), (mode, t)
            assert _equal(c2, c1), mode


@pytest.mark.parametrize("arch", FAMILIES)
def test_meshed_steps_are_the_unmeshed_steps(arch):
    check_meshed_steps(arch)


def test_meshed_verify_is_the_meshed_serve_chain():
    cfg = ARCHS["qwen3-4b"].reduced()
    impl = build(cfg, compute_dtype=torch.bfloat16, device="cpu")
    params = impl.init_params(0)
    _specs, batch = _batch(impl, cfg)
    tokens = batch["tokens"][:, :4]
    shape = InputShape("d", CACHE, B, "decode")
    cache = _cache(impl, cfg, params, batch)
    with one_rank_group("gloo"):
        mesh = make_host_mesh(device_type="cpu")
        serve, *_ = build_serve_step(impl, shape, mesh, param_mode="tp")
        verify, _i, (lout, _c), (_cs, window, _l) = build_verify_step(
            impl, shape, mesh, window=4, param_mode="tp")
        chain, c = [], cache
        for j in range(4):
            lg, c = serve(params, c, tokens[:, j:j + 1], j)
            chain.append(lg.full_tensor()[:, 0])
        got, vc = verify(params, cache, tokens, 0)
        assert tuple(got.placements) == lout
        assert torch.equal(got.full_tensor(), torch.stack(chain, dim=1))
        assert _equal(vc, shd.full_tree(c))
    assert window.shape == (B, 4)
