"""The host Adam's element-wise update: hand-written C++ over threads.

The offloaded trainer runs Adam on the CPU (ZeRO-Infinity's
DeepSpeedCPUAdam is C++ with AVX and OpenMP); this is the port's loop of
that kind.  ``csrc/host_adam.cpp`` gives every element the reference's
float32 operations in the reference's order, so its result is the bits of
the numpy loop (:func:`repro_torch.core.optimizer.adam_update_plain`) and
of the reference's ``adam_update``, whatever the thread count or vector
width.  It builds with the host C++ compiler on first use
(:func:`repro_torch.kernels._build.library`), never at import, and
is called through ctypes, which releases the GIL for the whole call.

* :func:`threads_for` is the rule for a call's width: the CPUs this
  process may run on, less the pipeline threads busy beside the Adam
  stage, and no more threads than leave each
  :data:`MIN_ELEMS_PER_THREAD` elements.
* :func:`host_adam_f32` runs one in-place step.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import _build

# CPUs left to the offload pipeline's own threads that work beside the
# update: the state-read and write-back streams, which copy while it runs
# (the executor and the gradient writer mostly wait then).  On an H100
# host of 8 CPUs the update ran fastest at 6 threads beside two copy
# streams, and 8 threads starved the copies (PERF.md §6).
RESERVED_THREADS = 2
# a thread's start and join cost ~0.5 ms on that host, ~0.4 M elements of
# one thread's work: each thread gets ten times that or none
MIN_ELEMS_PER_THREAD = 1 << 22

_F32 = np.dtype(np.float32)


def cpus() -> int:
    """The CPUs this process may run on."""
    return len(os.sched_getaffinity(0))


def threads_for(n: int, cpus_: int | None = None) -> int:
    """Threads an update of ``n`` elements takes on ``cpus_`` CPUs (the
    process's own by default)."""
    cpus_ = cpus() if cpus_ is None else cpus_
    return max(1, min(cpus_ - RESERVED_THREADS, n // MIN_ELEMS_PER_THREAD))


def _fns():
    lib = _build.library("host_adam")
    if lib.host_adam_f32.argtypes is None:
        p, f = ctypes.c_void_p, ctypes.c_float
        args = [p, p, p, p, ctypes.c_int64] + [f] * 9 + [ctypes.c_int]
        lib.host_adam_f32.argtypes = args
        lib.host_adam_f32.restype = ctypes.c_int
        lib.host_adam_f32_isa.argtypes = [ctypes.c_int] + args
        lib.host_adam_f32_isa.restype = ctypes.c_int
        lib.host_adam_best_isa.argtypes = []
        lib.host_adam_best_isa.restype = ctypes.c_int
    return lib


def best_isa() -> int:
    """The vector ISA the kernel runs on this CPU: 0 the x86-64 baseline
    (or another architecture), 1 AVX2, 2 AVX-512F."""
    return _fns().host_adam_best_isa()


def host_adam_f32(master: np.ndarray, grad: np.ndarray, m: np.ndarray,
                  v: np.ndarray, *, step: int, beta1: float, beta2: float,
                  eps: float, weight_decay: float, lr: float,
                  threads: int | None = None, isa: int | None = None) -> int:
    """One in-place AdamW step on C-contiguous fp32 ``master``, ``m`` and
    ``v`` with the fp32 gradient ``grad`` (already unscaled), on
    ``threads`` threads (:func:`threads_for` by default) and the widest
    vector ISA the CPU has, or ``isa``.  Returns the threads that ran."""
    arrays = (master, grad, m, v)
    n = master.size
    for a in arrays:
        if a.dtype != _F32 or not a.flags.c_contiguous or a.size != n:
            raise ValueError("host_adam_f32 takes C-contiguous float32 "
                             "arrays of one size")
    threads = threads_for(n) if threads is None else threads
    # the float32 constants numpy casts the Python floats to; the bias
    # corrections in double first, as the reference computes them
    consts = (beta1, 1.0 - beta1, beta2, 1.0 - beta2, 1.0 - beta1 ** step,
              1.0 - beta2 ** step, eps, weight_decay, lr)
    consts = [float(np.float32(c)) for c in consts]
    ptrs = [a.ctypes.data for a in arrays]
    lib = _fns()
    if isa is None:
        return lib.host_adam_f32(*ptrs, n, *consts, threads)
    ran = lib.host_adam_f32_isa(isa, *ptrs, n, *consts, threads)
    if ran < 0:
        raise RuntimeError(f"this CPU lacks the vector ISA {isa}")
    return ran
