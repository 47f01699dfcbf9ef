"""Adam configuration of an offload policy.

Only :class:`AdamConfig` is ported so far: the serving session reads its
compute dtype (the precision weights stream and run in).  The offloaded
host Adam (``OffloadedAdam`` in ``src/repro/core/optimizer.py``) comes with
the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dtypes import host_dtype


@dataclass
class AdamConfig:
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: str = "float32"      # "float32" | "bfloat16"  (paper's bf16 mode)
    compute_dtype: str = "bfloat16"   # precision of weights used by fwd/bwd

    @property
    def state_np_dtype(self) -> np.dtype:
        """Host dtype of optimizer state (bf16 as uint16 bits)."""
        return host_dtype(self.state_dtype)

    @property
    def compute_np_dtype(self) -> np.dtype:
        """Host dtype of compute weights (bf16 as uint16 bits)."""
        return host_dtype(self.compute_dtype)

    @property
    def state_bytes_per_param(self) -> int:
        return self.state_np_dtype.itemsize
