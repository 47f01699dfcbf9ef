"""Hand-written Hopper kernels of the port, beside their plain versions.

* :mod:`swa_attention` — banded flash attention (port of the Pallas
  ``swa_attention_pallas``), CUDA C++ in ``csrc/swa_attention.cu``.
* :mod:`overflow_check` — the fused Inf/NaN gradient screen (port of the
  Pallas ``overflow_check_pallas``), CUDA C++ in ``csrc/overflow_check.cu``.
* :mod:`fused_adam` — the fused AdamW step (port of the Pallas
  ``fused_adam_pallas``), CUDA C++ in ``csrc/fused_adam.cu``.

``ops`` dispatches on the tensors' device; ``_build`` compiles the CUDA
sources with nvcc on first use.
"""
