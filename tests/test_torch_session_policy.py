"""The reference's ``tests/test_policy.py`` on the port (models from the
port's ``make_offloadable_lm`` on the CPU).

OffloadPolicy: registry round-trips, builder chaining, validation."""

import pytest

from repro_torch.core import (AdaptiveBufferPool, AlignmentFreeAllocator,
                        DirectNVMeEngine, FilesystemEngine, OffloadPolicy,
                        memascend_policy, policy_names)
from repro_torch.core.optimizer import AdamConfig


def test_registry_names():
    names = policy_names()
    assert {"memascend", "zero-infinity", "memascend-bf16"} <= set(names)
    assert OffloadPolicy.names() == names


def test_preset_round_trip(tmp_path):
    built = (OffloadPolicy.preset("memascend")
             .with_store(str(tmp_path / "a")).with_adam(lr=1e-3).build())
    direct = memascend_policy(str(tmp_path / "b"), lr=1e-3)
    assert built.name == direct.name
    assert built.allocator_cls is direct.allocator_cls
    assert built.pool_cls is direct.pool_cls
    assert built.fused_overflow == direct.fused_overflow
    assert built.adam == direct.adam
    store = built.store_factory()
    assert isinstance(store, DirectNVMeEngine)
    store.close()


def test_preset_bf16_and_baseline(tmp_path):
    bf16 = (OffloadPolicy.preset("memascend-bf16")
            .with_store(str(tmp_path / "bf")).build())
    assert bf16.adam.state_dtype == "bfloat16"
    assert bf16.name == "memascend-bf16"   # registry name round-trips
    base = (OffloadPolicy.preset("zero-infinity")
            .with_store(str(tmp_path / "z")).build())
    store = base.store_factory()
    assert isinstance(store, FilesystemEngine)
    store.close()


def test_unknown_preset():
    with pytest.raises(KeyError, match="unknown offload policy"):
        OffloadPolicy.preset("warp-drive")


def test_builder_requires_store():
    with pytest.raises(ValueError, match="no store"):
        OffloadPolicy.preset("memascend").build()


def test_builder_store_exclusive(tmp_path):
    with pytest.raises(ValueError, match="exactly one"):
        OffloadPolicy.preset("memascend").with_store(
            str(tmp_path), factory=lambda: None)


def test_builder_store_kwargs_reach_preset_engine(tmp_path):
    p = (OffloadPolicy.preset("memascend")
         .with_store(str(tmp_path), n_devices=4).build())
    store = p.store_factory()
    assert isinstance(store, DirectNVMeEngine)
    assert store.n_devices == 4
    store.close()


def test_builder_unknown_store_kwarg_fails_at_build(tmp_path):
    # zero-infinity's factory funnels unknown kwargs into AdamConfig; the
    # builder must surface that as its own error, not a deep TypeError
    with pytest.raises(ValueError, match="zero-infinity.*rejected"):
        (OffloadPolicy.preset("zero-infinity")
         .with_store(str(tmp_path), fsync=False).build())


def test_builder_rejects_misrouted_options(tmp_path):
    # options must go through the method that names their component
    with pytest.raises(ValueError, match="non-Adam option"):
        OffloadPolicy.preset("memascend").with_adam(n_devices=4)
    with pytest.raises(ValueError, match="use with_adam"):
        OffloadPolicy.preset("memascend").with_store(str(tmp_path), lr=0.1)


def test_builder_store_kwargs_forbidden_with_factory():
    with pytest.raises(ValueError, match="only apply with"):
        OffloadPolicy.preset("memascend").with_store(
            factory=lambda: None, n_devices=4)


def test_builder_overrides(tmp_path):
    p = (OffloadPolicy.preset("memascend").with_store(str(tmp_path))
         .with_inflight_blocks(3).with_lookahead(2)
         .with_overrides(offload_checkpoints=False).build())
    assert p.inflight_blocks == 3 and p.lookahead == 2
    assert not p.offload_checkpoints


def test_validation_inflight_blocks(tmp_path):
    with pytest.raises(ValueError, match="inflight_blocks"):
        (OffloadPolicy.preset("memascend").with_store(str(tmp_path))
         .with_inflight_blocks(0).build())


def test_validation_lookahead_bounded(tmp_path):
    # lookahead beyond the pool's prefetch depth would oversubscribe slots
    with pytest.raises(ValueError, match="lookahead"):
        (OffloadPolicy.preset("memascend").with_store(str(tmp_path))
         .with_lookahead(5).build())


def test_validation_classes_and_dtypes(tmp_path):
    good = memascend_policy(str(tmp_path))
    with pytest.raises(ValueError, match="allocator_cls"):
        good.replace(allocator_cls=dict)
    with pytest.raises(ValueError, match="pool_cls"):
        good.replace(pool_cls=int)
    with pytest.raises(ValueError, match="state_dtype"):
        good.replace(adam=AdamConfig(state_dtype="float8"))
    with pytest.raises(ValueError, match="compute_dtype"):
        good.replace(adam=AdamConfig(compute_dtype="int4"))
    # replace() with valid changes keeps the rest intact
    deeper = good.replace(inflight_blocks=4, lookahead=4)
    assert deeper.pool_cls is AdaptiveBufferPool
    assert deeper.allocator_cls is AlignmentFreeAllocator
