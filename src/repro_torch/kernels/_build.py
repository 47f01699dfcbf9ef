"""Build the port's kernel sources and load them with ctypes.

Every ``csrc/*.cu`` file becomes one shared library with a plain C
interface (no PyTorch headers, so each compiles in seconds), built by
``nvcc`` for ``sm_90a``; every ``csrc/*.cpp`` file is host code, built by
the host C++ compiler (``g++``, the one nvcc drives).  Both kinds go into
``build/repro_torch_kernels/`` under the repository root, named by a hash
of the compiler's flags and every source that goes into the library, so
an edited source or flag rebuilds and an unchanged one is reused.
:func:`build_all` starts one compiler per CUDA source at once;
:func:`library` builds either kind on first use; :func:`report` returns
the ptxas report kept beside each CUDA build.  Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# -ffp-contract=off and no -ffast-math: the host kernels keep numpy's
# float32 operations one rounding each (csrc/host_adam.cpp)
HOST_CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread",
                  "-ffp-contract=off", "-fno-math-errno")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}     # guarded-by: _lock


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu`` file."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _host_cxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host kernels (csrc/*.cpp) build "
                       "with the host C++ compiler")


def _recipe(name: str):
    """(source, compiler, flags, headers) of ``name``'s library."""
    cu = CSRC / f"{name}.cu"
    if cu.exists():
        return cu, _nvcc, NVCC_FLAGS, sorted(CSRC.glob("*.cuh"))
    return CSRC / f"{name}.cpp", _host_cxx, HOST_CXX_FLAGS, []


def _target(name: str) -> Path:
    """Where ``name``'s library is built, named by a hash of its sources
    and its compiler's flags."""
    src, _cc, flags, headers = _recipe(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in headers:
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: the CUDA ones) concurrently,
    each to a name of this process's own that is then renamed into place,
    so processes that build at once never load a half-written library.
    Returns ``{name: compiler output}`` (a CUDA build's ptxas report) for
    the ones built now; raises with the output if any compile fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        src, cc, flags, _headers = _recipe(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [cc(), *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target, src.suffix == ".cu")
    reports, failed = {}, []
    for name, (proc, tmp, target, cuda) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}:\n{out}")
            continue
        if cuda:
            target.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, target)
        reports[name] = out
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return reports


def built(name: str) -> bool:
    """Whether ``name``'s current sources have a build on disk (a process
    that must not compile checks this before it loads)."""
    return _target(name).exists()


def report(name: str) -> str:
    """nvcc's ptxas report (registers, spills) of ``csrc/{name}.cu``'s
    current build, saved beside the library when it was built."""
    build_all([name])
    return _target(name).with_suffix(".ptxas.txt").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/{name}.cu`` or
    ``csrc/{name}.cpp``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
