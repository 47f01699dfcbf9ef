"""The host Adam's side-by-side store transfers (``OffloadedAdam``'s
fan-out): every subgroup reads its master, m and v on the optimizer's
read pool at once and writes them back, with its compute weights, on
four write-back workers at once.

Held here: the stored bytes equal those of one transfer at a time (fp32
and bf16 state, an in-memory store and the direct-NVMe engine), the
transfers really are in flight together (stores that wait on barriers),
the I/O ledger, the failure paths, and ``close()``.  The reference
package's bytes are held against the fanned path in
``tests/test_torch_train.py``.  Every test runs under its own time limit,
and every barrier and future wait has a timeout, so a regression fails
rather than hangs."""

import functools
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import OffloadPolicy, OffloadSession, trace
from repro_torch.core import optimizer as optim
from repro_torch.core.memory_tracker import MemoryTracker
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.core.nvme import DirectNVMeEngine
from repro_torch.core.optimizer import AdamConfig, OffloadedAdam
from repro_torch.data import DataLoader, SyntheticTextDataset

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "portbench")]

from stores.host_arena import HostArenaStore  # noqa: E402

BIG = 528_387               # 2 MiB of fp32 state a tensor, and a few pages
MID = 266_243
SMALL = 1000                # a norm vector's size
SIZES = {"big": BIG, "mid": MID, "small": SMALL}
WAIT = 20.0                 # seconds any barrier or future may wait


def time_limit(seconds: float):
    """Fail the test with ``TimeoutError`` after ``seconds`` (SIGALRM on
    the main thread; lock waits are interrupted by it)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(_sig, _frame):
                raise TimeoutError(f"{fn.__name__} ran over {seconds} s")
            old = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return run
    return wrap


def _one_at_a_time(monkeypatch):
    """Both of the optimizer's pools with one worker: one read and one
    write at a time, the reference of the byte comparisons."""
    def one_worker(max_workers, thread_name_prefix):
        return ThreadPoolExecutor(1, thread_name_prefix)
    monkeypatch.setattr(optim, "ThreadPoolExecutor", one_worker)


def _store(kind: str, root: Path):
    if kind == "arena":
        return HostArenaStore(32 << 20)
    return DirectNVMeEngine(str(root), n_devices=2,
                            device_capacity=32 << 20)


def _stored_bytes(store, key: str) -> bytes:
    if isinstance(store, HostArenaStore):
        _off, nbytes = store._span(key)
        return store.view(key, np.uint8, (nbytes,)).tobytes()
    _dtype, _shape, extents = store._locations[key]
    out = np.empty(sum(e.length for e in extents), np.uint8)
    return store.read(key, out).tobytes()


def _steps(opt: OffloadedAdam, grads: list[dict]) -> None:
    """The session's pipelined order: each subgroup's write-backs drain
    while the next one is read and updated; a step waits for its
    commits."""
    for step in grads:
        opt.begin_step()
        commits = []
        for key, grad in step.items():
            staged = opt.issue_subgroup(key)
            opt.compute_subgroup(staged, grad)
            commits.append(opt.commit_subgroup_async(staged))
        for commit in commits:
            commit.result(timeout=WAIT)


def _grads(rng, steps: int) -> list[dict]:
    return [{k: (rng.standard_normal(n) * 0.1).astype(np.float32)
             for k, n in SIZES.items()} for _ in range(steps)]


def _run(kind: str, root: Path, state_dtype: str):
    rng = np.random.default_rng(11)
    store = _store(kind, root)
    opt = OffloadedAdam(store, AdamConfig(lr=1e-2, weight_decay=0.01,
                                          state_dtype=state_dtype),
                        tracker=MemoryTracker())
    try:
        for key, n in SIZES.items():
            opt.register(key, rng.standard_normal(n).astype(np.float32))
        _steps(opt, _grads(rng, 3))
        assert opt.staging_idle()
        stored = {k + s: _stored_bytes(store, k + s) for k in SIZES
                  for s in (*OffloadedAdam.STATE, OffloadedAdam.COMPUTE)}
        return stored, opt.last_io_bytes
    finally:
        opt.close()
        store.close()


def _io_bytes(cfg: AdamConfig, sizes) -> int:
    """Bytes one step reads and writes back."""
    s, c = cfg.state_np_dtype.itemsize, cfg.compute_np_dtype.itemsize
    return sum(6 * n * s + n * c for n in sizes)


@pytest.mark.parametrize("kind", ["arena", "nvme"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@time_limit(120)
def test_fanout_keeps_the_stored_bytes(kind, state_dtype, tmp_path,
                                       monkeypatch):
    fanned, moved = _run(kind, tmp_path / "fan", state_dtype)
    _one_at_a_time(monkeypatch)
    serial, serial_moved = _run(kind, tmp_path / "serial", state_dtype)
    assert fanned.keys() == serial.keys()
    for key in serial:
        assert fanned[key] == serial[key], key
    cfg = AdamConfig(state_dtype=state_dtype)
    assert moved == serial_moved == _io_bytes(cfg, SIZES.values())


class BarrierStore(HostArenaStore):
    """An in-memory store whose transfers of ``gated`` subgroups, once
    armed, wait on a 3-party barrier (reads) or a 4-party one (writes):
    they finish only if an issue's three reads, or a commit's four
    writes, are in flight together.  Every armed transfer records its key
    and thread."""

    def __init__(self, gated=("big",)) -> None:
        super().__init__(32 << 20)
        self.gated = gated
        self.armed = False
        self.reads = threading.Barrier(3)
        self.writes = threading.Barrier(4)
        self.log: list[tuple[str, str, str]] = []
        self._log_lock = threading.Lock()

    def _pass(self, kind: str, key: str, barrier) -> None:
        if not self.armed:
            return
        with self._log_lock:
            self.log.append((kind, key, threading.current_thread().name))
        if key.split(".")[0] in self.gated:
            barrier.wait(timeout=WAIT)

    def read(self, key, out):
        self._pass("r", key, self.reads)
        return super().read(key, out)

    def write(self, key, data):
        self._pass("w", key, self.writes)
        return super().write(key, data)


def _barrier_opt(store, state_dtype="float32"):
    opt = OffloadedAdam(store, AdamConfig(state_dtype=state_dtype),
                        tracker=MemoryTracker())
    rng = np.random.default_rng(3)
    for key, n in SIZES.items():
        opt.register(key, rng.standard_normal(n).astype(np.float32))
    store.armed = True
    return opt


def _side_by_side(store, name: str) -> None:
    """``name``'s three reads ran on three read-pool threads and its four
    writes on four write-back threads."""
    mine = [(k, t) for k, key, t in store.log if key.startswith(name + ".")]
    reads = {t for k, t in mine if k == "r"}
    writes = {t for k, t in mine if k == "w"}
    assert len(reads) == 3
    assert all(t.startswith("offload-optim-read") for t in reads)
    assert len(writes) == 4
    assert all(t.startswith("offload-optim-io") for t in writes)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@time_limit(60)
def test_a_large_subgroup_moves_its_state_side_by_side(state_dtype):
    store = BarrierStore()
    opt = _barrier_opt(store, state_dtype)
    try:
        _steps(opt, [{"big": np.ones(BIG, np.float32)}])
        _side_by_side(store, "big")
        cfg = AdamConfig(state_dtype=state_dtype)
        assert opt.last_io_bytes == _io_bytes(cfg, [BIG])
        assert opt.staging_idle()
    finally:
        opt.close()
        store.close()


@time_limit(60)
def test_a_small_subgroup_fans_out_too():
    """A norm vector's subgroup takes the same path: its reads meet the
    3-party barrier and its writes the 4-party one."""
    store = BarrierStore(gated=("small",))
    opt = _barrier_opt(store, "bfloat16")
    try:
        _steps(opt, [{"small": np.ones(SMALL, np.float32)}])
        _side_by_side(store, "small")
        cfg = AdamConfig(state_dtype="bfloat16")
        assert opt.last_io_bytes == _io_bytes(cfg, [SMALL])
        assert opt.staging_idle()
    finally:
        opt.close()
        store.close()


@pytest.mark.parametrize("failing", OffloadedAdam.STATE[::2])
@time_limit(60)
def test_one_failed_read_waits_for_the_others_before_the_release(failing):
    store = BarrierStore(gated=())
    opt = _barrier_opt(store)
    done: list[tuple[str, bool]] = []
    real = HostArenaStore.read

    def read(key, out):
        if key == "big" + failing:     # the others still run
            raise IOError("injected state-read failure")
        time.sleep(0.2)
        real(store, key, out)
        done.append((key, opt.staging_idle()))
        return out

    store.read = read
    try:
        with pytest.raises(IOError, match="injected state-read"):
            opt.issue_subgroup("big")
        # both other reads had landed, into a buffer still held
        assert sorted(done) == sorted(("big" + s, False)
                                      for s in OffloadedAdam.STATE
                                      if s != failing)
        assert opt.staging_idle()
    finally:
        opt.close()
        store.close()


@time_limit(60)
def test_one_failed_write_fails_the_commit_and_releases_once(monkeypatch):
    store = BarrierStore(gated=())
    opt = _barrier_opt(store)
    real = HostArenaStore.write
    releases: list[int] = []
    arena = opt._ensure_arena()
    real_release = arena.release

    def release(index):
        releases.append(index)
        real_release(index)

    def write(key, data):
        if key == "big.m":
            raise IOError("injected write-back failure")
        time.sleep(0.1)
        return real(store, key, data)

    monkeypatch.setattr(arena, "release", release)
    store.write = write
    try:
        opt.begin_step()
        staged = opt.issue_subgroup("big")
        opt.compute_subgroup(staged, np.ones(BIG, np.float32))
        commit = opt.commit_subgroup_async(staged)
        assert isinstance(commit.exception(timeout=WAIT), IOError)
        assert releases == [staged.buf]
        assert opt.staging_idle()
        assert opt.last_io_bytes == 0
    finally:
        opt.close()
        store.close()


@time_limit(60)
def test_close_joins_both_pools_and_later_calls_raise():
    store = BarrierStore(gated=())
    opt = _barrier_opt(store)
    try:
        _steps(opt, [{"big": np.ones(BIG, np.float32),
                      "small": np.ones(SMALL, np.float32)}])
        names = {t.name for t in threading.enumerate()}
        assert any(n.startswith("offload-optim-read") for n in names)
        assert any(n.startswith("offload-optim-io") for n in names)
        opt.close()
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("offload-optim-")]
        for call in (lambda: opt.issue_subgroup("big"), opt._pool,
                     opt._read_pool):
            with pytest.raises(RuntimeError, match="closed"):
                call()
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("offload-optim-")]
        opt.close()                          # idempotent
    finally:
        opt.close()
        store.close()


@time_limit(60)
def test_a_trace_shows_the_transfers_side_by_side():
    store = BarrierStore()
    opt = _barrier_opt(store)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    try:
        prof.start()
        _steps(opt, [{"big": np.ones(BIG, np.float32)}])
        prof.stop()
    finally:
        opt.close()
        store.close()
    spans = [(e.name()[len(trace.PREFIX):], e.start_thread_id(),
              e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(trace.PREFIX)]
    for name, parties in (("adam.store_read", 3), ("adam.write", 4)):
        mine = [(t, a, b) for n, t, a, b in spans if n == name]
        assert len(mine) == parties and len({t for t, *_ in mine}) == parties
        # every one of them is open at once: the latest start comes
        # before the earliest end
        assert max(a for _t, a, _b in mine) < min(b for _t, _a, b in mine)
    # the issue's span, on the calling thread, holds its three reads
    issue = [(t, a, b) for n, t, a, b in spans if n == "adam.read"]
    assert len(issue) == 1
    t, a, b = issue[0]
    reads = [(ra, rb) for n, rt, ra, rb in spans if n == "adam.store_read"]
    assert t not in {rt for n, rt, *_ in spans if n == "adam.store_read"}
    assert all(a <= ra and rb <= b for ra, rb in reads)


@time_limit(120)
def test_counters_hold_with_more_threads_than_cores(monkeypatch):
    """Three optimizers stream at once (21 pool threads and their callers
    on the host's CPUs), the interpreter switching threads every
    microsecond: no update of the I/O ledger or a staging buffer is lost,
    and each optimizer stores the bytes that one transfer at a time
    stores."""
    sizes = [1024 + 97 * i for i in range(6)]
    errors: list[BaseException] = []

    def grads(k):
        rng = np.random.default_rng(k)
        return [{f"w{i}": rng.standard_normal(n).astype(np.float32)
                 for i, n in enumerate(sizes)} for _ in range(5)]

    def make():
        opt = OffloadedAdam(HostArenaStore(4 << 20), AdamConfig(),
                            tracker=MemoryTracker())
        for i, n in enumerate(sizes):
            opt.register(f"w{i}", np.zeros(n, np.float32))
        return opt

    def stream(opt, steps):
        try:
            for step in steps:
                _steps(opt, [step])
                assert opt.last_io_bytes == _io_bytes(opt.cfg, sizes)
        except BaseException as e:   # re-raised on the test's thread
            errors.append(e)

    def stored(opt):
        return {k + s: _stored_bytes(opt.store, k + s)
                for k in opt.subgroups
                for s in (*OffloadedAdam.STATE, OffloadedAdam.COMPUTE)}

    opts = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        opts = [make() for _ in range(3)]
        threads = [threading.Thread(target=stream, args=(o, grads(k)))
                   for k, o in enumerate(opts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT * 3)
        assert not [t for t in threads if t.is_alive()]
    finally:
        sys.setswitchinterval(old)
    try:
        if errors:
            raise errors[0]
        assert all(opt.staging_idle() for opt in opts)
        got = [stored(opt) for opt in opts]
    finally:
        for opt in opts:
            opt.close()
            opt.store.close()
    _one_at_a_time(monkeypatch)
    for k, want in enumerate(got):
        ref = make()
        try:
            stream(ref, grads(k))
            assert stored(ref) == want
        finally:
            ref.close()
            ref.store.close()
    assert not errors


CFG = ModelConfig(name="tiny-wide-vocab", family="dense", n_layers=1,
                  d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab=4160)


def _train(root: str, steps: int = 2):
    model = make_offloadable_lm(CFG, 0, device="cpu")
    policy = (OffloadPolicy.preset("memascend").with_store(root)
              .with_adam(lr=3e-3).build())
    dl = DataLoader(SyntheticTextDataset(vocab=CFG.vocab, seed=1), batch=2,
                    seq_len=16)
    with OffloadSession(model, policy) as s:
        metrics = [dict(s.train_step(b["tokens"], b["labels"]))
                   for b in (dl.next_batch() for _ in range(steps))]
        s.synchronize()
        masters = {(u.name, k): np.asarray(s.master_param(u.name, k))
                   for u in s.model.units for k in u.params}
        return metrics, masters


@time_limit(120)
def test_a_session_fans_out_its_table_and_keeps_the_bits(tmp_path,
                                                         monkeypatch):
    """The session's pipelined stage reads every subgroup, the embedding
    table too, on the read pool, and trains to the same losses and master
    bits as with one transfer at a time."""
    readers: dict[str, set] = {}
    real = OffloadedAdam._read_one

    def read_one(self, skey, out, half):
        readers.setdefault(skey, set()).add(threading.current_thread().name)
        return real(self, skey, out, half)

    monkeypatch.setattr(OffloadedAdam, "_read_one", read_one)
    metrics, masters = _train(str(tmp_path / "fan"))
    assert sum(bool(m["applied"]) for m in metrics) >= 1
    assert any(k.endswith(".m") and "embed" in k for k in readers), readers
    assert all(t.startswith("offload-optim-read")
               for names in readers.values() for t in names)
    _one_at_a_time(monkeypatch)
    s_metrics, s_masters = _train(str(tmp_path / "serial"))
    assert [m["loss"] for m in s_metrics] == [m["loss"] for m in metrics]
    for key, want in s_masters.items():
        np.testing.assert_array_equal(masters[key].view(np.uint32),
                                      want.view(np.uint32), err_msg=str(key))
