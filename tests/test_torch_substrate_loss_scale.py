"""The reference's ``tests/test_loss_scale.py`` on the port: its ``repro``
imports read ``repro_torch``.
"""

import torch

from repro_torch.core import DynamicLossScaler

torch.set_num_threads(2)


def test_backoff_on_overflow():
    s = DynamicLossScaler(scale=1024.0)
    assert not s.update(True)          # overflow -> skip step
    assert s.scale == 512.0
    assert s.n_overflows == 1


def test_growth_after_interval():
    s = DynamicLossScaler(scale=8.0, growth_interval=3)
    for _ in range(2):
        assert s.update(False)
    assert s.scale == 8.0
    assert s.update(False)
    assert s.scale == 16.0


def test_overflow_resets_growth_counter():
    s = DynamicLossScaler(scale=8.0, growth_interval=2)
    s.update(False)
    s.update(True)
    s.update(False)
    assert s.scale == 4.0              # halved once, not yet regrown


def test_scale_bounds():
    s = DynamicLossScaler(scale=2.0, min_scale=1.0)
    for _ in range(10):
        s.update(True)
    assert s.scale == 1.0
    s2 = DynamicLossScaler(scale=2.0 ** 23, growth_interval=1,
                           max_scale=2.0 ** 24)
    for _ in range(5):
        s2.update(False)
    assert s2.scale == 2.0 ** 24
