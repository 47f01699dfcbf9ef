"""Model math on torch tensors: layers, GQA and MLA attention, MoE, the
decoder LM.

See :mod:`repro_torch.models.registry` for the uniform build interface.
"""

from .registry import (LONG_CONTEXT_WINDOW, ModelImpl, TensorSpec, build,
                       shape_supported, variant_for_shape)
from . import attention, layers, moe, transformer

__all__ = ["build", "ModelImpl", "TensorSpec", "variant_for_shape",
           "shape_supported", "LONG_CONTEXT_WINDOW", "transformer", "layers",
           "attention", "moe"]
