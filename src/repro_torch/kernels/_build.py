"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file becomes one shared library with a plain C
interface (no PyTorch headers, so each compiles in seconds), built for
``sm_90a`` into ``build/repro_torch_kernels/`` under the repository root
and named by a hash of its source, so an edited source rebuilds and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per source
at once; :func:`library` builds on first use; :func:`report` returns the
ptxas report kept beside each build.  Nothing here runs at import.
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
