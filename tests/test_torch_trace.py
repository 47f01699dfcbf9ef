"""Spans and timed counters of the port (``repro_torch.core.trace``) on
the CPU: which thread records which span under a profiler that records
every thread, that a run with no profiler computes the same bits, the
Adam stage's counters, pool-slot backpressure, the decode path, and the
fallback to ``torch.profiler.record_function``."""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (AdaptiveBufferPool, AlignmentFreeAllocator,
                              DecodeSpec, DirectNVMeEngine, MemoryTracker,
                              OffloadPolicy, OffloadSession,
                              ParameterSwapper, PoolCensus, ShapeClass,
                              trace)
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.data import DataLoader, SyntheticTextDataset
from repro_torch.kernels import host_adam
from repro_torch.serve import OffloadedDecoder

torch.set_num_threads(2)

CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)

# the spans each pipeline thread records in a full-overlap train step
TRAIN_THREADS = {
    "executor": {"train_step", "synchronize", "plan.fetch", "plan.compute",
                 "plan.grad_write", "plan.overflow_check",
                 "plan.optim_step", "plan.release", "fetch", "optim_gate",
                 "pool_acquire"},
    "optimizer": {"adam.unit", "adam.read_wait", "adam.update",
                  "adam.commit_prep", "adam.write_wait"},
    "state prefetch": {"adam.read", "adam.staging_acquire"},
    "read pool": {"adam.store_read"},
    "write-back": {"adam.write"},
    "h2d": {"h2d.stage", "swap.wait", "h2d.copy"},
    "writer": {"grad_write", "overflow_screen"},
}
# roles served by a pool rather than one thread
POOLED = {"read pool", "write-back"}


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def _spans(prof) -> list[tuple[str, int, int, int]]:
    """(name, thread, start ns, end ns) of every repro_torch span."""
    return [(e.name()[len(trace.PREFIX):], e.start_thread_id(),
             e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(trace.PREFIX)]


def _names_by_thread(spans) -> dict[int, set]:
    out: dict[int, set] = {}
    for name, tid, _a, _b in spans:
        out.setdefault(tid, set()).add(name)
    return out


def _overlap(spans, a: str, b: str, tid: int) -> list:
    """Pairs of an ``a`` and a ``b`` span on thread ``tid`` that overlap."""
    xs = [(s, e) for n, t, s, e in spans if n == a and t == tid]
    ys = [(s, e) for n, t, s, e in spans if n == b and t == tid]
    return [(x, y) for x in xs for y in ys
            if min(x[1], y[1]) > max(x[0], y[0])]


def _policy(root, overlap="full"):
    return (OffloadPolicy.preset("memascend").with_store(root)
            .with_adam(lr=3e-3).with_overlap(overlap).build())


def _batches(n):
    dl = DataLoader(SyntheticTextDataset(vocab=256, seed=1), batch=2,
                    seq_len=16)
    return [dl.next_batch() for _ in range(n)]


def _train(root, steps: int, prof=None, overlap="full"):
    """``steps`` train steps and a synchronize; the step metrics with the
    embedding's master after them, the overlap counters, and the spans if
    ``prof`` records."""
    model = make_offloadable_lm(CFG, 0, device="cpu")
    with OffloadSession(model, _policy(root, overlap)) as s:
        if prof is not None:
            prof.start()
        metrics = [dict(s.train_step(b["tokens"], b["labels"]))
                   for b in _batches(steps)]
        s.synchronize()
        if prof is not None:
            prof.stop()
        counters = s.overlap_snapshot()
        metrics.append({"embed_master": s.master_param("embed", "embed")})
    return metrics, counters, (_spans(prof) if prof is not None else None)


@pytest.fixture(scope="module")
def traced_train(tmp_path_factory):
    return _train(str(tmp_path_factory.mktemp("traced")), 2, _profiler())


@pytest.fixture(scope="module")
def traced_sync_train(tmp_path_factory):
    return _train(str(tmp_path_factory.mktemp("traced_sync")), 2,
                  _profiler(), overlap="sync")


def test_train_step_records_each_span_on_its_own_thread(traced_train):
    _metrics, _counters, spans = traced_train
    by_thread = _names_by_thread(spans)
    assert {n for n, *_ in spans} <= set(trace.SPANS)
    executor = next(t for n, t, *_ in spans if n == "train_step")
    threads = {}
    for role, names in TRAIN_THREADS.items():
        tids = {t for n, t, *_ in spans if n in names}
        assert len(tids) == 1 or (role in POOLED and tids), (role, tids)
        threads[role] = tids
        recorded = set().union(*(by_thread[t] for t in tids))
        assert names <= recorded, (role, names - recorded)
    assert threads["executor"] == {executor}
    every = [t for tids in threads.values() for t in tids]
    assert len(set(every)) == len(every)      # no thread in two roles
    # no span's name carries the device kernel fragment the screen's
    # roofline reads
    assert not [n for n in trace.SPANS if "overflow_kernel" in n]


def test_summed_spans_never_nest_on_the_executor(traced_train):
    """The waits a device-idle share would sum on the executor thread
    are disjoint intervals: a fetch never holds a pool acquire, and the
    Adam gate never runs inside a synchronize."""
    _metrics, _counters, spans = traced_train
    executor = next(t for n, t, *_ in spans if n == "train_step")
    assert _overlap(spans, "fetch", "pool_acquire", executor) == []
    assert _overlap(spans, "optim_gate", "synchronize", executor) == []
    assert any(n == "optim_gate" and t == executor for n, t, *_ in spans)


def test_untraced_run_records_nothing_and_computes_the_same_bits(
        traced_train, tmp_path):
    traced, _counters, _spans_ = traced_train
    plain, _c, _s = _train(str(tmp_path), 2)
    late = _profiler()
    late.start()
    late.stop()
    assert _spans(late) == []     # nothing buffered from the plain run
    *steps, master = traced
    *plain_steps, plain_master = plain
    np.testing.assert_array_equal(master["embed_master"].view(np.uint8),
                                  plain_master["embed_master"].view(np.uint8))
    for a, b in zip(steps, plain_steps, strict=True):
        assert a.keys() == b.keys()
        # the metrics that thread timing does not move (the others are
        # seconds, hit counts, the tracker's peak and the last completed
        # Adam's bytes, which follow when each worker ran)
        for key in ("loss", "overflowed", "applied", "loss_scale"):
            assert a[key] == b[key], key


@pytest.mark.parametrize("run", ["traced_train", "traced_sync_train"])
def test_adam_counters_split_the_stage(run, request):
    """Every overlap mode splits its Adam stage the same way: update,
    read and write-back waits inside the stage's seconds, and the
    updated elements counted as ``test_torch_host_adam`` expects (a tiny
    model's leaves are far under the split's minimum)."""
    _metrics, c, spans = request.getfixturevalue(run)
    parts = (c["adam_update_seconds"] + c["optim_prefetch_wait_seconds"]
             + c["adam_write_wait_seconds"])
    assert c["adam_update_seconds"] > 0
    assert c["adam_write_wait_seconds"] > 0
    for part in ("adam_update_seconds", "optim_prefetch_wait_seconds",
                 "adam_write_wait_seconds"):
        assert c[part] <= c["adam_stage_seconds"], part
    assert 0 < parts <= c["adam_stage_seconds"]
    assert c["optim_gate_seconds"] > 0 and c["fetch_seconds"] > 0
    sizes = [a.size for u in make_offloadable_lm(CFG, 0, device="cpu").units
             for a in u.params.values()]
    assert c["adam_update_elems"] == 2 * sum(sizes)       # two steps
    assert c["adam_update_split_elems"] == 2 * sum(
        n for n in sizes if host_adam.threads_for(n) > 1) == 0
    names = {n for n, *_ in spans}
    assert {"adam.unit", "adam.read_wait", "adam.update",
            "adam.write_wait", "adam.read", "adam.store_read",
            "adam.write"} <= names


def test_pool_of_depth_one_counts_acquire_wait(tmp_store_root, rng):
    """With one pool slot a second issue waits for the first slot's
    release: the wait lands in ``acquire_wait_seconds`` and its span."""
    store = DirectNVMeEngine(tmp_store_root, n_devices=1,
                             device_capacity=1 << 22)
    pool = AdaptiveBufferPool(
        PoolCensus((ShapeClass("w", 1024 * 4, 1),), inflight_blocks=1),
        AlignmentFreeAllocator(tracker=MemoryTracker(), component="pool",
                               backing="numpy"))
    for k in ("a", "b"):
        store.write(k, rng.standard_normal(1024).astype(np.float32))
    swapper = ParameterSwapper(store, pool, class_of={"a": "w", "b": "w"})
    try:
        first = swapper.get("a", np.float32, (1024,))
        assert swapper.stats.acquire_wait_seconds < 0.05
        releaser = threading.Timer(0.1, first.release)
        prof = _profiler()
        prof.start()
        releaser.start()
        second = swapper.get("b", np.float32, (1024,))
        prof.stop()
        releaser.join()
        second.release()
        assert swapper.stats.acquire_wait_seconds >= 0.05
        assert swapper.stats.snapshot()["acquire_wait_seconds"] == \
            swapper.stats.acquire_wait_seconds
        acquires = [(e - s) / 1e9 for n, _t, s, e in _spans(prof)
                    if n == "pool_acquire"]
        assert len(acquires) == 1 and acquires[0] >= 0.05
    finally:
        swapper.drain()
        pool.close()
        store.close()


def test_decode_records_fetch_and_h2d_copy(tmp_store_root):
    model = make_offloadable_lm(CFG, 0, device="cpu")
    prompts = np.random.default_rng(0).integers(3, 256, size=(2, 6),
                                                dtype=np.int32)
    with OffloadedDecoder(model, _policy(tmp_store_root),
                          decode=DecodeSpec(batch=2, max_seq=32,
                                            bucket=8)) as dec:
        dec.generate(prompts, 2)             # warm
        wait0 = dec.session.swapper.stats.acquire_wait_seconds
        prof = _profiler()
        prof.start()
        out = dec.generate(prompts, 3)
        prof.stop()
        assert dec.session.swapper.stats.acquire_wait_seconds >= wait0
    assert out.shape == (2, 3)
    spans = _spans(prof)
    assert {n for n, *_ in spans} <= set(trace.SPANS)
    executor = next(t for n, t, *_ in spans if n == "decode_step")
    names = _names_by_thread(spans)
    assert {"open_kv_cache", "prefill", "decode_step", "fetch",
            "plan.kv_read", "plan.kv_write"} <= names[executor]
    assert sum(n == "decode_step" for n, *_ in spans) == 2
    h2d = {t for n, t, *_ in spans if n == "h2d.stage"}
    assert len(h2d) == 1 and h2d != {executor}
    assert "h2d.copy" in names[h2d.pop()]
    assert _overlap(spans, "fetch", "pool_acquire", executor) == []


def test_fallback_to_record_function(monkeypatch):
    monkeypatch.setattr(trace, "_RecordFunctionFast", None)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with trace.span("fetch", unit="block_0", step=1):
        time.sleep(0.001)
    prof.stop()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == trace.PREFIX + "fetch"]
    assert len(events) == 1 and events[0].is_user_annotation()
    assert events[0].duration_ns() >= 1_000_000


def test_span_names_are_a_fixed_set():
    with pytest.raises(ValueError, match="not a span"):
        trace.span("block_0.fetch")
    assert len(set(trace.SPANS)) == len(trace.SPANS)

    class Stats:
        seconds = 0.0

        def add_worker_seconds(self, name, dt):
            setattr(self, name, getattr(self, name) + dt)

    stats = Stats()
    with trace.timed(stats, "seconds", "fetch"):
        time.sleep(0.002)
    assert stats.seconds >= 0.002
    with pytest.raises(RuntimeError), \
            trace.timed(stats, "seconds", "fetch"):
        raise RuntimeError("a block that raises counts nothing")
    assert stats.seconds < 0.5
