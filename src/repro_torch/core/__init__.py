"""MemAscend core on torch: the offload substrate and the serving session.

* memory accounting      — :mod:`repro_torch.core.memory_tracker`
* pinned allocators      — :mod:`repro_torch.core.pinned_alloc` (§III-B/§IV-C)
* parameter buffer pools — :mod:`repro_torch.core.buffer_pool` (§III-A/§IV-B)
* SSD tensor stores      — :mod:`repro_torch.core.nvme` (§III-D/§IV-E)
* prefetch swapper       — :mod:`repro_torch.core.swapper`
* overlap machinery      — :mod:`repro_torch.core.overlap`
* schedule IR            — :mod:`repro_torch.core.stream_plan`
* paged KV cache         — :mod:`repro_torch.core.kv_cache`
* the offload session    — :mod:`repro_torch.core.session` (serve mode)
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
from .nvme import DirectNVMeEngine, FilesystemEngine, TensorStore, IOStats
from .optimizer import AdamConfig
from .swapper import ParameterSwapper, SwapStats
from .overlap import DeviceSlots, OverlapStats, SerialWorker
from .stream_plan import (ComputeOp, FetchOp, KVReadOp, KVWriteOp, PlanError,
                          ReleaseOp, StreamPlan, compile_decode_cached,
                          compile_prefill)
from .session import OffloadSession
from .offload_engine import (OffloadableModel, OffloadUnit, OffloadPolicy,
                             PolicyBuilder, memascend_bf16_policy,
                             memascend_policy, policy_names, register_policy,
                             zero_infinity_policy)

__all__ = [n for n in dir() if not n.startswith("_")]
