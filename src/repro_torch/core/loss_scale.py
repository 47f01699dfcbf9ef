"""Dynamic loss scaling driven by the overflow check (port of
``src/repro/core/loss_scale.py``, unchanged).

Standard fp16-style mixed-precision recipe (Micikevicius et al., 2018),
reproduced because the *overflow check it requires every iteration* is one
of MemAscend's four targets.  The scaler is deliberately tiny; the
interesting part (the check itself) lives in :mod:`repro_torch.core.overflow` and
:mod:`repro_torch.kernels.overflow_check`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DynamicLossScaler:
    scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24
    _good_steps: int = 0
    n_overflows: int = 0
    n_steps: int = 0

    def update(self, overflowed: bool) -> bool:
        """Record one step's overflow status.

        Returns True if the optimizer step should be APPLIED (no overflow),
        False if it must be skipped.
        """
        self.n_steps += 1
        if overflowed:
            self.n_overflows += 1
            self.scale = max(self.scale * self.backoff_factor, self.min_scale)
            self._good_steps = 0
            return False
        self._good_steps += 1
        if self._good_steps >= self.growth_interval:
            self.scale = min(self.scale * self.growth_factor, self.max_scale)
            self._good_steps = 0
        return True
