from repro_torch.core.kv_cache import DecodeSpec

from .decode import build_serve_step, build_verify_step
from .offloaded import OffloadedDecoder
from .request import Request, RequestMetrics, RequestState
from .scheduler import FifoScheduler, ServingEngine, ServingReport
from .spec import DraftSource, NGramDraft, SpecConfig, SpecStats

__all__ = [
    "build_serve_step",
    "build_verify_step",
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
