"""Hand-written Hopper kernels of the port, beside their plain versions.

* :mod:`swa_attention` — banded flash attention (port of the Pallas
  ``swa_attention_pallas``), CUDA C++ in ``csrc/swa_attention.cu``.

``ops`` dispatches on the tensors' device; ``_build`` compiles the CUDA
sources with nvcc on first use.
"""
