"""Host bf16 as ``np.uint16`` bit patterns, and the bridge to torch.

The reference keeps host compute weights as ``ml_dtypes.bfloat16`` arrays.
The port runs on hosts that may lack ``ml_dtypes``, and ``torch.from_numpy``
rejects that dtype anyway, so every bf16 host buffer here is a ``uint16``
array holding the raw bf16 bits.  Pool slots, store files and KV pages move
those bits unchanged; only this module converts between them and torch
tensors, zero-copy in both directions.
"""

from __future__ import annotations

import numpy as np
import torch

#: host dtype of bf16 data (raw bit patterns)
BF16_HOST = np.dtype(np.uint16)

_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
_HOST = {"bfloat16": BF16_HOST, "float16": np.dtype(np.float16),
         "float32": np.dtype(np.float32)}


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16" | "float16" | "float32"`` -> the torch dtype."""
    return _TORCH[name]


def host_dtype(name: str) -> np.dtype:
    """``"bfloat16" | "float16" | "float32"`` -> the host numpy dtype."""
    return _HOST[name]


def to_torch(host: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Zero-copy CPU tensor over a host array holding ``dtype`` data
    (``uint16`` bits for bf16)."""
    if dtype == torch.bfloat16:
        if host.dtype != BF16_HOST:
            raise TypeError(f"bf16 host data must be uint16 bits, got "
                            f"{host.dtype}")
        return torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(host)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Host numpy array of a tensor's values (D2H when it lies on a
    device); bf16 comes back as ``uint16`` bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def cast_host(values: np.ndarray, name: str) -> np.ndarray:
    """Round an fp32 host array to the host form of dtype ``name`` (bf16
    rounds to nearest even, as ``ml_dtypes`` and torch do)."""
    if name == "bfloat16":
        values = np.ascontiguousarray(values, np.float32)
        if not values.flags.writeable:     # torch wants a writable buffer
            values = values.copy()
        return to_host(torch.from_numpy(values).to(torch.bfloat16))
    return np.asarray(values, _HOST[name])
