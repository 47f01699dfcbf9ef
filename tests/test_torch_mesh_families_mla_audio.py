"""MLA + MoE + MTP (deepseek-v3) and whisper's encoder-decoder through the
meshed steps on the 1x1 host mesh, bit for bit the unmeshed steps at bf16
compute: the checks of ``tests/test_torch_mesh_families.py``, in a file of
their own so that two workers share the families' planning time."""

import pytest
import torch

from test_torch_mesh_families import check_meshed_steps

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-tiny"])
def test_meshed_steps_are_the_unmeshed_steps(arch):
    check_meshed_steps(arch)
