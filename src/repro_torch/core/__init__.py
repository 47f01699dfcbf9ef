"""MemAscend core on torch: the offload substrate and the offload session.

* memory accounting      — :mod:`repro_torch.core.memory_tracker`
* pinned allocators      — :mod:`repro_torch.core.pinned_alloc` (§III-B/§IV-C)
* parameter buffer pools — :mod:`repro_torch.core.buffer_pool` (§III-A/§IV-B)
* overflow checking      — :mod:`repro_torch.core.overflow` (§III-C/§IV-D)
* loss scaling           — :mod:`repro_torch.core.loss_scale`
* SSD tensor stores      — :mod:`repro_torch.core.nvme` (§III-D/§IV-E)
* host Adam              — :mod:`repro_torch.core.optimizer`
* prefetch swapper       — :mod:`repro_torch.core.swapper`
* overlap machinery      — :mod:`repro_torch.core.overlap`
* spans, timed counters  — :mod:`repro_torch.core.trace`
* schedule IR            — :mod:`repro_torch.core.stream_plan`
* paged KV cache         — :mod:`repro_torch.core.kv_cache`
* the offload session    — :mod:`repro_torch.core.session` (train + serve)
* trainer checkpoints    — :mod:`repro_torch.core.checkpoint`
* policies + presets     — :mod:`repro_torch.core.offload_engine`
* host bf16 bridge       — :mod:`repro_torch.core.dtypes`
"""

from .memory_tracker import MemoryTracker, GLOBAL_TRACKER, fmt_bytes
from .pinned_alloc import (AlignmentFreeAllocator, PinnedAllocatorBase,
                           PowerOfTwoCachingAllocator, next_power_of_two,
                           align_up, DMA_ALIGNMENT)
from .buffer_pool import (AdaptiveBufferPool, FixedBufferPool, KV_CLASS,
                          PoolCensus, ShapeClass)
from .kv_cache import DecodeSpec, KVStats, SpillableKVCache
from .overflow import baseline_overflow_check, fused_overflow_check
from .loss_scale import DynamicLossScaler
from .nvme import DirectNVMeEngine, FilesystemEngine, TensorStore, IOStats
from .optimizer import AdamConfig, OffloadedAdam, adam_update
from .swapper import ParameterSwapper, SwapStats
from .overlap import DeviceSlots, OverlapStats, SerialWorker
from .stream_plan import (ActFetchOp, ActSaveOp, ComputeOp, FetchOp,
                          GradWriteOp, KVReadOp, KVWriteOp, OptimStepOp,
                          OverflowCheckOp, PlanError, ReleaseOp, StreamPlan,
                          compile_decode, compile_decode_cached, compile_eval,
                          compile_prefill, compile_train, resolve_act_policy)
from .session import OffloadSession
from .offload_engine import (OffloadableModel, OffloadedTrainer, OffloadUnit,
                             OffloadPolicy, PolicyBuilder,
                             memascend_bf16_policy,
                             memascend_policy, policy_names, register_policy,
                             zero_infinity_policy)
from .checkpoint import (load_pytree, restore_trainer_step, save_pytree,
                         snapshot_trainer)

__all__ = [n for n in dir() if not n.startswith("_")]
