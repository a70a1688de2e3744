"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` into a shared library under ``build/repro_torch/``
at the root of the checkout, named by a digest of its source and flags, so a
changed source rebuilds and an unchanged one is loaded as it is.  The
wrappers load the library with ``ctypes`` at their first launch; importing
this module runs no compiler, so the package imports on a host without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``<checkout>/build/repro_torch`` (``src/repro_torch/kernels`` is three levels down)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: kernel name → its source under ``csrc/``
SOURCES: Dict[str, str] = {
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
    "array_ops": "array_ops.cu",
}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Dict[str, object]]:
    """Compile the named kernels (all by default) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns, per kernel, the
    library path, the seconds its build took (0 when it was already built)
    and the compiler's report (``ptxas`` registers and shared memory).
    Raises ``RuntimeError`` with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Dict[str, object]] = {}
    running = {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = {"path": str(target), "seconds": 0.0, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"path": str(target), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name]["path"])
        _LOADED[name] = lib
    return lib
