"""The reference's ``tests/test_system.py`` on the port (models from the
port's ``make_offloadable_lm`` on the CPU).

End-to-end system behaviour: the full MemAscend stack working together,
reproducing the paper's headline claims at container scale."""

import numpy as np

from repro_torch.configs import ARCHS, PAPER_MODELS
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (AdaptiveBufferPool, AlignmentFreeAllocator,
                        FixedBufferPool, MemoryTracker,
                        OffloadedTrainer, PowerOfTwoCachingAllocator,
                        memascend_policy, zero_infinity_policy)
from repro_torch.core.model_adapter import make_offloadable_lm
from repro_torch.data import DataLoader, SyntheticTextDataset


def test_full_stack_memascend_vs_baseline(tmp_path):
    """The paper's end-to-end claim, at container scale: same losses,
    substantially lower peak host memory, lower overflow-check cost."""
    cfg = ModelConfig(name="sys", family="dense", n_layers=3, d_model=96,
                      n_heads=4, n_kv_heads=2, d_ff=192, vocab=512)

    def run(policy):
        model = make_offloadable_lm(cfg, 7, device="cpu")
        tr = OffloadedTrainer(model, policy)
        dl = DataLoader(SyntheticTextDataset(vocab=512, seed=3), batch=4,
                        seq_len=48)
        losses = []
        for _ in range(6):
            b = dl.next_batch()
            losses.append(tr.train_step(b["tokens"], b["labels"])["loss"])
        peak = tr.tracker.peak_allocated
        overflow_peak = tr.tracker.component("overflow_tmp").peak_allocated
        tr.close()
        return losses, peak, overflow_peak

    l_m, peak_m, ovf_m = run(memascend_policy(str(tmp_path / "m"), lr=1e-3))
    l_z, peak_z, ovf_z = run(zero_infinity_policy(str(tmp_path / "z"),
                                                  lr=1e-3))
    np.testing.assert_allclose(l_m, l_z, atol=1e-6)        # Fig. 19
    assert peak_m < 0.8 * peak_z                            # Fig. 15 (scaled)
    # Fig. 13: fused check is chunk-bounded (<=4 MiB) regardless of model
    # size, while baseline scales at 1.25x the flat buffer; at this tiny
    # scale the flat buffer is smaller than one chunk, so assert the bound
    # and the ordering rather than the at-scale 10x ratio.
    assert ovf_m <= 4 << 20
    assert ovf_m < ovf_z


def test_peak_memory_accounting_at_paper_scale():
    """Run the ALLOCATION POLICIES (accounting mode, no real buffers) at the
    paper's 8B scale and check the waste ordering it reports."""
    cfg = PAPER_MODELS["llama3.1-8b"]
    census = cfg.pool_census(inflight_blocks=2, shards=2)  # 2-GPU setup

    def peak_for(alloc_cls, pool_cls):
        t = MemoryTracker()
        alloc = alloc_cls(tracker=t, component="pinned")
        pool = pool_cls(census, alloc)
        # gradient flat buffer, fp32, whole model (paper §III-C)
        flat = alloc.alloc(cfg.param_count() * 4 // 2)     # per-rank shard
        pool.close(); flat.free()
        return t.peak_allocated

    baseline = peak_for(PowerOfTwoCachingAllocator, FixedBufferPool)
    memascend = peak_for(AlignmentFreeAllocator, AdaptiveBufferPool)
    saving = 1 - memascend / baseline
    # paper: ~50.9% peak saving for Llama3.1-8B (Fig. 15); accept a band
    assert saving > 0.30, f"saving {saving:.1%}"


def test_leak_free_after_training(tmp_path):
    cfg = ModelConfig(name="leak", family="dense", n_layers=2, d_model=64,
                      n_heads=2, n_kv_heads=1, d_ff=128, vocab=128)
    model = make_offloadable_lm(cfg, 0, device="cpu")
    tr = OffloadedTrainer(model, memascend_policy(str(tmp_path), lr=1e-3))
    dl = DataLoader(SyntheticTextDataset(vocab=128, seed=0), batch=2,
                    seq_len=16)
    for _ in range(2):
        b = dl.next_batch()
        tr.train_step(b["tokens"], b["labels"])
    tr.close()
    tr.tracker.assert_quiescent()     # every byte returned


def test_moe_census_pool_pressure():
    """Fig. 18: MoE models magnify the fixed pool's waste (many small
    experts vs one giant embedding slot)."""
    cfg = ARCHS["deepseek-v3-671b"]
    census = cfg.pool_census()
    t1, t2 = MemoryTracker(), MemoryTracker()
    fixed = FixedBufferPool(
        census, AlignmentFreeAllocator(tracker=t1, component="p"))
    adaptive = AdaptiveBufferPool(
        census, AlignmentFreeAllocator(tracker=t2, component="p"))
    saving = 1 - adaptive.pool_bytes / fixed.pool_bytes
    assert saving > 0.6, f"MoE pool saving {saving:.1%}"
    fixed.close(); adaptive.close()
