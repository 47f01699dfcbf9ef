"""Build the port's kernel sources and load them with ctypes.

Every ``csrc/*.cu`` file becomes one shared library with a plain C
interface (no PyTorch headers, so each compiles in seconds), built for
``sm_90a`` into ``build/repro_torch_kernels/`` under the repository root
and named by a hash of its source, so an edited source rebuilds and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per source
at once; :func:`library` builds on first use; :func:`report` returns the
ptxas report kept beside each build.  Every ``csrc/*.cpp`` file is host
code: :func:`host_library` builds it with the host C++ compiler (``g++``,
the one nvcc drives) on first use, into the same directory, named by a
hash of its source and flags.  Nothing here runs at import.
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


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all) concurrently; returns
    ``{name: ptxas report}`` for the ones built now.  Raises with nvcc's
    output if any compile fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        target.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, target)
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def built(name: str) -> bool:
    """Whether ``csrc/{name}.cu``'s current source has a build on disk
    (a process that must not compile checks this before it loads)."""
    return _target(name).exists()


def report(name: str) -> str:
    """nvcc's ptxas report (registers, spills) of ``csrc/{name}.cu``'s
    current build, saved beside the library when it was built."""
    build_all([name])
    return _target(name).with_suffix(".ptxas.txt").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/{name}.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def _host_target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join(HOST_CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _build_host(name: str) -> Path:
    """Compile ``csrc/{name}.cpp`` unless its build is on disk: to a name
    of this process's own, then renamed into place, so processes that
    build at once never load a half-written library."""
    target = _host_target(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_host_cxx(), *HOST_CXX_FLAGS, "-o", str(tmp),
         str(CSRC / f"{name}.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}")
    os.replace(tmp, target)
    return target


def host_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of the host source ``csrc/{name}.cpp``,
    built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build_host(name)))
            _libs[name] = lib
        return lib
