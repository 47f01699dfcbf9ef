from repro_torch.core.kv_cache import DecodeSpec

from .offloaded import OffloadedDecoder
from .request import Request, RequestMetrics, RequestState
from .scheduler import FifoScheduler, ServingEngine, ServingReport
from .spec import DraftSource, NGramDraft, SpecConfig, SpecStats

__all__ = [
    "DecodeSpec",
    "OffloadedDecoder",
    "Request",
    "RequestMetrics",
    "RequestState",
    "FifoScheduler",
    "ServingEngine",
    "ServingReport",
    "DraftSource",
    "NGramDraft",
    "SpecConfig",
    "SpecStats",
]
