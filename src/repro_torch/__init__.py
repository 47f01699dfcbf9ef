"""PyTorch/CUDA port of the MemAscend reproduction (``src/repro``).

The JAX package stays the reference; this package mirrors its
sub-packages (``configs``, ``kernels``, ``models``, ``core``, ``serve``)
and runs on an NVIDIA H100 unless the caller passes ``device="cpu"``.
It imports torch and numpy, never JAX, ``ml_dtypes`` or ``repro``; host
bf16 data is ``uint16`` bits (:mod:`repro_torch.core.dtypes`).

Ported so far: SSD-offloaded cached decode — ``make_offloadable_lm`` →
``OffloadPolicy.preset("memascend").with_store(root).build()`` →
``OffloadedDecoder(model, policy, decode=DecodeSpec(...)).generate(...)``,
with prompt attention in the hand-written Hopper kernel
(``csrc/swa_attention.cu``).
"""
