"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

Each csrc/<name>.cu has a plain C interface and becomes its own shared
library, _build/lib<name>-<hash>.so, compiled for Hopper (sm_90a) the first
time it is needed. The FFT sources of VARIANTS are built once per largest
odd radix they take and sample type (-DORCAI_ODD=<r> -DORCAI_DTYPE=<t>,
lib<name>-odd<r>-t<t>-<hash>.so), so that their kernels compile in
processes of their own. The hash covers the source, the headers of csrc/
(*.cuh) and the flags, so an edited kernel is rebuilt and an unchanged one
is not. Missing libraries are compiled by nvcc processes started together,
one per library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("dft_magnitude", "dft_mixed", "dft_cluster", "dft_staged", "dft_gemm", "digit_hist")
# the builds of a source, (the largest odd radix it takes, sample type: 0
# float32, 1 int16, 2 uint8; ops/dft.py::_build_variant picks the build of
# a plan): one nvcc would compile dft_mixed.cu's 30, dft_cluster.cu's 6 and
# dft_staged.cu's 12 kernels one after another, where the card's host has
# cores for them side by side; radix 19 shares radix 23's builds and 29
# radix 31's, which no size of the earlier radices runs
VARIANTS = {"dft_mixed": tuple((r, t) for r in (11, 13, 17, 23, 31) for t in range(3)),
            "dft_cluster": tuple((r, t) for r in (17, 23) for t in range(3)),
            "dft_staged": tuple((r, t) for r in (13, 31) for t in range(3))}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[tuple[str, tuple[int, int] | None], ctypes.CDLL] = {}


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


def _flags(variant: tuple[int, int] | None) -> tuple[str, ...]:
    if variant is None:
        return NVCC_FLAGS
    return (*NVCC_FLAGS, f"-DORCAI_ODD={variant[0]}", f"-DORCAI_DTYPE={variant[1]}")


def _tag(variant: tuple[int, int] | None) -> str:
    return "" if variant is None else f"-odd{variant[0]}-t{variant[1]}"


def library_path(name: str, variant: tuple[int, int] | None = None) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(variant)).encode())
    return BUILD_DIR / f"lib{name}{_tag(variant)}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library of `names` (each build of VARIANTS) that is
    not built yet.

    Returns {name or name-odd<r>-t<t>: nvcc output} for the libraries
    compiled by this call (ptxas prints each kernel's registers, shared
    memory and spills); build.seconds holds each one's wall from the start
    of the call to the end of its nvcc.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        for variant in VARIANTS.get(name, (None,)):
            out = library_path(name, variant)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *_flags(variant), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs[f"{name}{_tag(variant)}"] = (proc, tmp, out)
    logs, seconds, failed = {}, {}, []

    def wait(name, proc):
        logs[name], _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(name, proc)) for name, (proc, _, _) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for name, (proc, tmp, out) in procs.items():
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build.seconds = dict(sorted(seconds.items(), key=lambda kv: kv[1]))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


build.seconds = {}


def load(name: str, variant: tuple[int, int] | None = None) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (its build for `variant`, one
    of VARIANTS[name]), built on first use with the other builds of name."""
    if variant not in VARIANTS.get(name, (None,)):
        raise ValueError(f"{name}.cu has the builds {VARIANTS.get(name, (None,))}, not {variant}")
    key = (name, variant)
    if key not in _loaded:
        path = library_path(name, variant)
        if not path.exists():
            build([name])
        _loaded[key] = ctypes.CDLL(str(path))
    return _loaded[key]
