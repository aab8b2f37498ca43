"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

Each csrc/<name>.cu has a plain C interface and becomes its own shared
library, _build/lib<name>-<hash>.so, compiled for Hopper (sm_90a) the first
time it is needed. The hash covers the source, the headers of csrc/ (*.cuh)
and the flags, so an edited kernel is rebuilt and an unchanged one is not. Missing libraries are
compiled by nvcc processes started together, one per source. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("dft_magnitude", "dft_mixed", "dft_cluster", "dft_gemm", "digit_hist")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library of `names` that is not built yet.

    Returns {name: nvcc output} for the sources compiled by this call
    (ptxas prints each kernel's registers, shared memory and spills).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
