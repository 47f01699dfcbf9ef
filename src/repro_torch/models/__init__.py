"""Model math on torch tensors: layers, GQA attention, per-layer pieces."""

from . import attention, layers, transformer

__all__ = ["attention", "layers", "transformer"]
