"""The host Adam's C++ update (``csrc/host_adam.cpp`` through
``repro_torch.kernels.host_adam``) against its plain numpy version and the
reference's ``adam_update``: the same bits at every size, thread count,
vector ISA, step and weight decay; the thread rule; the split counters a
training session keeps; and the build on first use."""

import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core.nvme import DirectNVMeEngine as JEngine
from repro.core.optimizer import AdamConfig as JAdam, OffloadedAdam as JOpt
from repro.core.optimizer import adam_update as j_adam_update
from repro_torch.configs.base import ModelConfig
from repro_torch.core import OffloadPolicy, OffloadSession
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.core.nvme import DirectNVMeEngine
from repro_torch.core.optimizer import (ADAM_CHUNK, AdamConfig,
                                        OffloadedAdam, adam_update,
                                        adam_update_plain)
from repro_torch.data import DataLoader, SyntheticTextDataset
from repro_torch.kernels import _build, host_adam

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MIN = host_adam.MIN_ELEMS_PER_THREAD


def _states(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32),
            np.abs(rng.standard_normal(n)).astype(np.float32) * 0.1,
            np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01]


def _grads(n, seed, steps=4):
    rng = np.random.default_rng(seed + 1)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(steps)]


def _bits(arrays):
    return [a.view(np.uint32) for a in arrays]


def _assert_same(got, want):
    for a, b in zip(_bits(got), _bits(want), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 15, 17, 1000, ADAM_CHUNK + 3,
                               2 * MIN + 77])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_kernel_plain_and_reference_agree_bit_for_bit(n, weight_decay):
    """Steps 1-4 at sizes under one SIMD vector, across one, at a tail
    that is no multiple of 16, across a numpy chunk, and at a size the
    rule splits over two threads (or more where the CPUs allow)."""
    kw = dict(lr=3e-3, weight_decay=weight_decay)
    start = _states(n, n)
    kernel = [a.copy() for a in start]
    plain = [a.copy() for a in start]
    ref = [a.copy() for a in start]
    for step, grad in enumerate(_grads(n, n), start=1):
        adam_update(kernel[0], grad, kernel[1], kernel[2], step,
                    AdamConfig(**kw))
        adam_update_plain(plain[0], grad, plain[1], plain[2], step,
                          AdamConfig(**kw))
        j_adam_update(ref[0], grad, ref[1], ref[2], step, JAdam(**kw))
    _assert_same(kernel, plain)
    _assert_same(kernel, ref)
    assert not np.array_equal(kernel[0], start[0])


@pytest.mark.parametrize("threads", [1, 2, 3, 7, "all", "4x"])
def test_every_thread_count_gives_the_plain_bits(threads):
    """One thread, a few, every CPU of the process and more threads than
    CPUs: contiguous 16-element-aligned ranges, the caller taking the
    last, the tail in it."""
    threads = {"all": host_adam.cpus(),
               "4x": 4 * host_adam.cpus()}.get(threads, threads)
    n = 100_003
    cfg = AdamConfig(lr=1e-3, weight_decay=0.01)
    kernel, plain = _states(n, 5), _states(n, 5)
    for step, grad in enumerate(_grads(n, 5), start=1):
        ran = host_adam.host_adam_f32(
            kernel[0], grad, kernel[1], kernel[2], step=step,
            beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, lr=cfg.lr, threads=threads)
        assert ran == threads
        adam_update_plain(plain[0], grad, plain[1], plain[2], step, cfg)
    _assert_same(kernel, plain)


def test_no_more_threads_than_16_element_blocks():
    n = 40                    # three blocks: 16, 16 and a tail of 8
    kernel, plain = _states(n, 9), _states(n, 9)
    grad = _grads(n, 9, 1)[0]
    cfg = AdamConfig()
    ran = host_adam.host_adam_f32(
        kernel[0], grad, kernel[1], kernel[2], step=1, beta1=cfg.beta1,
        beta2=cfg.beta2, eps=cfg.eps, weight_decay=0.0, lr=cfg.lr,
        threads=8)
    assert ran == 3
    adam_update_plain(plain[0], grad, plain[1], plain[2], 1, cfg)
    _assert_same(kernel, plain)


def test_the_bits_do_not_depend_on_the_vector_isa():
    """The baseline, AVX2 and AVX-512F loops (each the CPU has) give the
    plain bits: no contraction, no reassociation at any width."""
    n = 4099
    cfg = AdamConfig(lr=2e-3, weight_decay=0.01)
    plain = _states(n, 11)
    for step, grad in enumerate(_grads(n, 11), start=1):
        adam_update_plain(plain[0], grad, plain[1], plain[2], step, cfg)
    isas = range(host_adam.best_isa() + 1)
    for isa in isas:
        kernel = _states(n, 11)
        for step, grad in enumerate(_grads(n, 11), start=1):
            host_adam.host_adam_f32(
                kernel[0], grad, kernel[1], kernel[2], step=step,
                beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                weight_decay=cfg.weight_decay, lr=cfg.lr, threads=3,
                isa=isa)
        _assert_same(kernel, plain)
    with pytest.raises(RuntimeError, match="lacks the vector ISA"):
        host_adam.host_adam_f32(*plain[:1], _grads(n, 11, 1)[0], *plain[1:],
                                step=1, beta1=0.9, beta2=0.999, eps=1e-8,
                                weight_decay=0.0, lr=1e-3, isa=7)


def test_two_python_threads_at_once_get_the_same_bits():
    """ctypes lets go of the GIL for the call: two callers run together,
    each on its own arrays, each with the plain bits."""
    n = 3 * MIN + 5
    cfg = AdamConfig(lr=1e-3)
    start = _states(n, 21)
    grads = _grads(n, 21, 2)
    plain = [a.copy() for a in start]
    for step, grad in enumerate(grads, start=1):
        adam_update_plain(plain[0], grad, plain[1], plain[2], step, cfg)
    results = [[a.copy() for a in start] for _ in range(2)]
    barrier = threading.Barrier(2)
    errors = []

    def run(state):
        try:
            barrier.wait()
            for step, grad in enumerate(grads, start=1):
                adam_update(state[0], grad, state[1], state[2], step, cfg)
        except BaseException as e:     # re-raised on the test's thread
            errors.append(e)

    workers = [threading.Thread(target=run, args=(s,)) for s in results]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
        assert not w.is_alive()
    assert not errors
    for state in results:
        _assert_same(state, plain)


@pytest.mark.parametrize("update", [adam_update, adam_update_plain])
def test_a_strided_state_is_refused(update):
    m = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="C-contiguous"):
        update(np.zeros((4, 4), np.float32).T, np.ones((4, 4), np.float32),
               m, m.copy(), 1, AdamConfig())


def test_a_gradient_of_another_dtype_is_refused():
    p, m, v = _states(64, 0)
    with pytest.raises(ValueError, match="float32"):
        adam_update(p, np.ones(64, np.float64), m, v, 1, AdamConfig())


def test_bf16_state_step_subgroup_matches_the_reference(tmp_store_root):
    """The paper's bf16 optimizer state: widened into the fp32 staging,
    updated by the kernel on a size the rule splits, narrowed back; the
    stored master, m, v and compute bytes are the reference's."""
    rng = np.random.default_rng(7)
    n = 2 * MIN + 77
    init = rng.standard_normal(n).astype(np.float32)
    grads = [(rng.standard_normal(n) * 0.1).astype(np.float32)
             for _ in range(2)]
    stores = {}
    for name, engine, cfg_cls, opt_cls in (
            ("j", JEngine, JAdam, JOpt),
            ("t", DirectNVMeEngine, AdamConfig, OffloadedAdam)):
        store = engine(f"{tmp_store_root}/{name}")
        opt = opt_cls(store, cfg_cls(lr=1e-2, weight_decay=0.01,
                                     state_dtype="bfloat16",
                                     compute_dtype="bfloat16"))
        opt.register("w", init)
        for g in grads:
            opt.begin_step()
            opt.step_subgroup("w", g)
        stores[name] = (store, opt)
    try:
        for suffix in (".master", ".m", ".v", ".compute"):
            got = [s.read_new("w" + suffix, np.uint8, (2 * n,))
                   for s, _ in stores.values()]
            np.testing.assert_array_equal(got[0], got[1], err_msg=suffix)
    finally:
        for store, opt in stores.values():
            opt.close()
            store.close()


def test_the_thread_rule():
    """The process's CPUs less the pipeline's own threads, and never a
    thread with fewer than ``MIN_ELEMS_PER_THREAD`` elements."""
    res = host_adam.RESERVED_THREADS
    cpus = res + 4
    assert host_adam.threads_for(0, cpus) == 1
    assert host_adam.threads_for(2 * MIN - 1, cpus) == 1
    assert host_adam.threads_for(2 * MIN, cpus) == 2
    assert host_adam.threads_for(3 * MIN + 1, cpus) == 3
    assert host_adam.threads_for(1 << 40, cpus) == 4
    assert host_adam.threads_for(1 << 40, res) == 1
    assert host_adam.threads_for(1 << 40, 1) == 1
    assert host_adam.threads_for(1 << 40) == max(1, host_adam.cpus() - res)


def _leaf_sizes(cfg: dict) -> list[int]:
    """Every trained leaf of a Qwen3 dense model from its config's widths:
    embedding and head, and a block's attention, qk-norms, norms and
    SwiGLU, and the final norm."""
    d, ff, vocab = (cfg["hidden_size"], cfg["intermediate_size"],
                    cfg["vocab_size"])
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    block = [d * q, d * kv, d * kv, q * d, cfg["head_dim"], cfg["head_dim"],
             d, d, d * ff, d * ff, ff * d]
    return [vocab * d, d * vocab, d] + block * cfg["num_hidden_layers"]


def test_the_split_engages_over_qwen3_4b_s_leaves():
    """Over the trained cell's leaves (computed, not allocated), at the
    card host's 8 CPUs and at this process's, all but the norm weights
    split: at least 99 % of the elements."""
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "qwen3-4b.json").read_text())
    sizes = _leaf_sizes(cfg)
    assert sum(sizes) == 878_845_696     # PERF.md §4
    for cpus in (8, host_adam.cpus()):
        if cpus - host_adam.RESERVED_THREADS < 2:
            continue
        split = sum(n for n in sizes if host_adam.threads_for(n, cpus) > 1)
        assert split / sum(sizes) >= 0.99, cpus


def _train(root, steps=2):
    model = make_offloadable_lm(
        ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256),
        0, device="cpu")
    policy = (OffloadPolicy.preset("memascend").with_store(root)
              .with_adam(lr=3e-3).build())
    dl = DataLoader(SyntheticTextDataset(vocab=256, seed=1), batch=2,
                    seq_len=16)
    with OffloadSession(model, policy) as s:
        losses = [s.train_step(b["tokens"], b["labels"])["loss"]
                  for b in (dl.next_batch() for _ in range(steps))]
        s.synchronize()
        masters = {(u.name, k): np.asarray(s.master_param(u.name, k))
                   for u in s.model.units for k in u.params}
        return losses, masters, s.overlap_snapshot()


def test_session_counts_split_elements_and_the_split_keeps_the_bits(
        tmp_path, monkeypatch):
    """A tiny model's leaves are far under the rule's minimum, so none
    splits; with the minimum at 64 elements on four CPUs and no reserve
    every leaf of 128 elements or more splits, and the losses and
    masters stay the same bits."""
    losses, masters, counters = _train(str(tmp_path / "one"))
    n_params = sum(a.size for a in masters.values())
    assert counters["adam_update_elems"] == 2 * n_params
    assert counters["adam_update_split_elems"] == 0

    monkeypatch.setattr(host_adam, "MIN_ELEMS_PER_THREAD", 64)
    monkeypatch.setattr(host_adam, "RESERVED_THREADS", 0)
    monkeypatch.setattr(host_adam, "cpus", lambda: 4)
    split_losses, split_masters, split = _train(str(tmp_path / "split"))
    assert split_losses == losses
    for key, want in masters.items():
        np.testing.assert_array_equal(split_masters[key].view(np.uint32),
                                      want.view(np.uint32), err_msg=key)
    wide = sum(a.size for a in masters.values() if a.size >= 128)
    assert split["adam_update_elems"] == 2 * n_params
    assert split["adam_update_split_elems"] == 2 * wide > 0


def test_the_library_builds_on_first_use_not_at_import():
    """Importing the port, its session and optimizer builds and loads
    nothing: a decode-only process never pays the compile."""
    code = ("import repro_torch.core, repro_torch.serve\n"
            "from repro_torch.kernels import _build\n"
            "assert 'host_adam' not in _build._libs, _build._libs\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


@pytest.mark.parametrize("name, flags", [("host_adam", "HOST_CXX_FLAGS"),
                                         ("overflow_check", "NVCC_FLAGS")])
def test_the_host_build_is_named_by_its_source_and_flags(name, flags,
                                                         monkeypatch):
    """A library is named by its compiler's flags and its sources, so a
    changed flag builds anew instead of loading the old library."""
    path = _build._target(name)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    with monkeypatch.context() as m:
        m.setattr(_build, flags, (*getattr(_build, flags), "-DNDEBUG"))
        assert _build._target(name) != path
    assert _build._target(name) == path
    if name == "host_adam":        # the CUDA build needs nvcc
        host_adam.best_isa()       # loads it, building if need be
        assert path.exists()


def test_a_missing_compiler_is_named(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build._host_cxx()
