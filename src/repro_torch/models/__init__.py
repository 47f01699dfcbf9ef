"""Model zoo on torch tensors: dense/GQA/MLA, MoE, Mamba, xLSTM, whisper
enc-dec, VLM prefix.

See :mod:`repro_torch.models.registry` for the uniform build interface.
"""

from .registry import (LONG_CONTEXT_WINDOW, ModelImpl, TensorSpec, build,
                       shape_supported, variant_for_shape)
from . import attention, layers, mamba, moe, transformer, whisper, xlstm

__all__ = ["build", "ModelImpl", "TensorSpec", "variant_for_shape",
           "shape_supported", "LONG_CONTEXT_WINDOW", "transformer", "whisper",
           "layers", "attention", "moe", "mamba", "xlstm"]
