from repro_torch.core.kv_cache import DecodeSpec

from .offloaded import OffloadedDecoder

__all__ = ["DecodeSpec", "OffloadedDecoder"]
