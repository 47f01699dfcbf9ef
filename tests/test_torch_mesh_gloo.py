"""The meshed steps on a real 2x2 ("data", "model") mesh: four spawned
processes, one ``gloo`` rank each, on the CPU.

Each rank builds the same reduced model from one seed at fp32 compute and
runs, for each family (dense qwen3-4b, MoE phi3.5-moe, MLA + MoE + MTP
deepseek-v3, hybrid jamba, encoder-decoder whisper, xLSTM): the unsharded
port step and the meshed train step (ZeRO-3 params, the batch over
"data"), then four decode steps unsharded and meshed under "zero3" and
"tp".  Bounds: the loss and every gathered gradient within rel 1e-5 (each
leaf of its own max abs), the logits within rel 1e-5 of each row's max —
the same fp32 math with the products split over shards and summed in
another order — an Inf written into one rank's local shard sets the
overflow flag on every rank, so does a loss scale at which only the
reduced gradients overflow (autograd's partial sums stay finite), and
``sharding.distribute_params`` places the full tree so that it gathers
back to itself.  The processes are spawned once for the module (~20 s)
and import only the port; each test reads its part of the results.
"""

import multiprocessing
import os

import pytest
import torch

torch.set_num_threads(2)

WORLD = 4
ARCHS = ["qwen3-4b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
         "jamba-v0.1-52b", "whisper-tiny", "xlstm-1.3b"]
B, S, CACHE, STEPS = 4, 16, 32, 4
RTOL = 1e-5


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _worker(rank: int, init: str, queue) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    try:
        queue.put((rank, _run(rank)))
    except Exception as e:      # the parent reports it
        queue.put((rank, repr(e)))
    finally:
        dist.destroy_process_group()


def _run(rank: int) -> dict:
    from repro_torch.configs import ARCHS as CONFIGS
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import build
    from repro_torch.serve.decode import build_serve_step
    from repro_torch.train.step import (build_train_step,
                                        grads_overflow_flag, tree_leaves)
    mesh = _mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch in ARCHS:
        cfg = CONFIGS[arch].reduced()
        impl = build(cfg, compute_dtype=torch.float32, device="cpu")
        params = impl.init_params(0)
        gen = torch.Generator().manual_seed(1)
        specs = impl.input_specs(InputShape("t", S, B, "train"))
        batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                  dtype=v.dtype) for k, v in specs.items()}
        placed = shd.distribute_params(params, cfg, mesh)
        whole = tree_leaves(shd.full_tree(placed))
        distributed = all(torch.equal(a, b) for a, b in
                          zip(whole, tree_leaves(params))) and all(
            a.to_local().numel() <= b.numel() for a, b in
            zip(tree_leaves(placed), tree_leaves(params)))
        want_loss, want, _ov = build_train_step(impl)(params, batch, 4.0)
        step, _in, _out = build_train_step(impl, mesh, batch_shape=specs)
        loss, grads, overflow = step(params, batch, 4.0)
        full = shd.full_tree(grads)
        res = {"loss": _rel(loss, want_loss),
               "grads": max(_rel(a, b) for a, b in
                            zip(tree_leaves(full), tree_leaves(want))),
               "placed": all(tree_leaves(shd.spec_map(
                   lambda pl, g: tuple(g.placements) == tuple(pl),
                   _out[1], grads))),
               "overflow": bool(overflow), "distributed": distributed}
        if arch == ARCHS[0]:
            res.update(_summed_overflow(impl, params, batch, mesh, step,
                                        _in))
        if rank == 1:
            tree_leaves(grads)[2].to_local().view(-1)[0] = float("inf")
        res["inf_flag"] = bool(grads_overflow_flag(grads))

        shape = InputShape("d", CACHE, B, "decode")
        toks = torch.randint(0, cfg.vocab, (B, STEPS), generator=gen,
                             dtype=torch.int32)
        serve, _specs = build_serve_step(impl, shape,
                                         cache_dtype=torch.float32)
        for mode in ("zero3", "tp"):
            mserve, _i, _o, _s = build_serve_step(
                impl, shape, mesh, param_mode=mode,
                cache_dtype=torch.float32)
            c1 = c2 = impl.init_cache(B, CACHE, torch.float32, device="cpu")
            worst = 0.0
            for t in range(STEPS):
                tok = toks[:, t:t + 1]
                a, c1 = serve(params, c1, tok, t)
                b, c2 = mserve(params, c2, tok, t)
                row = a.abs().amax(-1, keepdim=True)
                worst = max(worst, float(((b.full_tensor() - a).abs()
                                          / row).max()))
            res[mode] = worst
        out[arch] = res
    return out


def _mesh_max(x: float) -> float:
    import torch.distributed as dist
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, dist.ReduceOp.MAX)
    return float(t[0])


def _summed_overflow(impl, params, batch, mesh, step, placements) -> dict:
    """The meshed step at a loss scale where the gradients overflow only
    once their partial sums are reduced: autograd's own (un-reduced)
    gradients stay finite and the screen must still see the Inf in the
    gradients the step returns.  The final norm's scale (``1 + weight``) is
    cut to 1e-3 and the (tied) embedding grown 1e3-fold, so that the final
    norm's gradient, which autograd returns partial over "data", is the
    largest and large enough for an fp32 loss scale to overflow it.  The
    loss scale sits between the two maxima (the step at 4.0 gives both;
    gradients scale with it)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import sharding as shd
    from repro_torch.train.step import (build_train_step,
                                        grads_overflow_flag, tree_leaves)
    pplace, bplace, _scalar = placements
    inner = build_train_step(impl, check_overflow=False)
    params = dict(params, final_norm=params["final_norm"] - 0.999,
                  embed=params["embed"] * 1e3)
    _loss, grads, _ov = step(params, batch, 4.0)

    def raw(scale):
        with implicit_replication():
            return inner(shd.place(params, pplace, mesh),
                         shd.place(batch, bplace, mesh), scale)[1]

    def peak(tree):
        return _mesh_max(max(float(g.to_local().abs().max())
                             for g in tree_leaves(tree)))

    placed, unreduced = peak(grads), peak(raw(4.0))
    scale = 4.0 * torch.finfo(torch.float32).max \
        / (placed * unreduced) ** 0.5
    _loss, big, overflow = step(params, batch, scale)
    return {"sum_ratio": placed / unreduced,
            "sum_overflow": bool(overflow),
            "sum_inf_returned": _mesh_max(float(any(
                not torch.isfinite(g.to_local()).all()
                for g in tree_leaves(big)))) == 1.0,
            "sum_unreduced_flag": bool(grads_overflow_flag(raw(scale)))}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    init = "file://" + os.path.join(tmp_path_factory.mktemp("gloo"), "init")
    procs = [ctx.Process(target=_worker, args=(r, init, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    for rank, res in got.items():
        assert isinstance(res, dict), f"rank {rank}: {res}"
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gathered_gradients_match_the_unsharded_step(results, arch):
    for rank in range(WORLD):
        res = results[rank][arch]
        assert res["loss"] <= RTOL and res["grads"] <= RTOL, (rank, res)
        assert res["placed"] and not res["overflow"]


@pytest.mark.parametrize("mode", ["zero3", "tp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_logits_match_the_unsharded_step(results, arch, mode):
    for rank in range(WORLD):
        assert results[rank][arch][mode] <= RTOL, (rank, results[rank][arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_distributed_params_gather_to_the_full_tree(results, arch):
    assert all(results[rank][arch]["distributed"] for rank in range(WORLD))


@pytest.mark.parametrize("arch", ARCHS)
def test_an_inf_in_one_shard_sets_every_rank_s_flag(results, arch):
    assert all(results[rank][arch]["inf_flag"] for rank in range(WORLD))


def test_an_overflow_only_the_reduced_gradients_hold_sets_the_flag(results):
    """The screen reads the gradients in their parameters' placements,
    after the partial sums meet, not autograd's un-reduced partials."""
    for rank in range(WORLD):
        res = results[rank][ARCHS[0]]
        assert res["sum_ratio"] > 1.0, res
        assert not res["sum_unreduced_flag"], res
        assert res["sum_inf_returned"] and res["sum_overflow"], res
