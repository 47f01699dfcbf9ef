"""PyTorch/CUDA port of the MemAscend reproduction (``src/repro``).

The JAX package stays the reference; this package mirrors its
sub-packages (``configs``, ``kernels``, ``models``, ``core``, ``serve``,
``data``) and runs on an NVIDIA H100 unless the caller passes
``device="cpu"``.  It imports torch and numpy, never JAX, ``ml_dtypes`` or
``repro``; host bf16 data is ``uint16`` bits (:mod:`repro_torch.core.dtypes`).

Ported so far: SSD-offloaded training (``OffloadSession(model, policy)
.train_step`` with the host/ssd/recompute activation-checkpoint tiers, the
``OffloadedTrainer`` shim, trainer snapshots in ``core.checkpoint``) and
serving (``OffloadedDecoder.generate`` — cached, uncached, speculative —
and ``ServingEngine``), each Pallas kernel of the reference as a
hand-written Hopper kernel under ``csrc/``.
"""
