"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

Each csrc/<name>.cu has a plain C interface and becomes its own shared
library, _build/lib<name>-<hash>.so, compiled for Hopper (sm_90a) the first
time it is needed. The FFT sources of VARIANTS are built once per largest
odd radix they take, dft_mixed.cu and dft_cluster.cu also once per sample
type (-DORCAI_ODD=<r> -DORCAI_DTYPE=<t>, lib<name>-odd<r>-t<t>-<hash>.so;
dft_staged.cu takes its sample type at run time, lib<name>-odd<r>-<hash>.so),
so that their kernels compile in processes of their own. The hash covers
the source, the headers of csrc/ (*.cuh) and the flags, so an edited kernel
is rebuilt and an unchanged one is not. Missing libraries are compiled by nvcc processes, one per library,
as many at once as there are cores, the longest first. Nothing here runs at
import time.
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
# float32, 1 int16, 2 uint8, or None where the source takes it at run time;
# ops/dft.py::_build_variant picks the build of a plan): one nvcc would
# compile dft_mixed.cu's 30 and dft_cluster.cu's 6 kernels one after
# another, where the card's host has cores for them side by side; radix 19
# shares radix 23's builds and 29 radix 31's, which no size of the earlier
# radices runs. dft_staged.cu's sample type reaches its kernel 1 alone, so
# one build per odd radix compiles its sample-free kernels once.
VARIANTS = {"dft_mixed": tuple((r, t) for r in (11, 13, 17, 23, 31) for t in range(3)),
            "dft_cluster": tuple((r, t) for r in (17, 23) for t in range(3)),
            "dft_staged": ((13, None), (31, None))}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[tuple[str, tuple[int, int | None] | None], ctypes.CDLL] = {}


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


def _flags(variant: tuple[int, int | None] | None) -> tuple[str, ...]:
    if variant is None:
        return NVCC_FLAGS
    odd, dtype = variant
    return (*NVCC_FLAGS, f"-DORCAI_ODD={odd}",
            *(() if dtype is None else (f"-DORCAI_DTYPE={dtype}",)))


def _tag(variant: tuple[int, int | None] | None) -> str:
    if variant is None:
        return ""
    return f"-odd{variant[0]}" + ("" if variant[1] is None else f"-t{variant[1]}")


def library_path(name: str, variant: tuple[int, int | None] | None = None) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(variant)).encode())
    return BUILD_DIR / f"lib{name}{_tag(variant)}-{h.hexdigest()[:16]}.so"


def _weight(name: str, variant: tuple[int, int | None] | None) -> tuple[int, int]:
    """How long a library's nvcc runs, to order the builds longest first:
    its largest odd radix (the unrolled sums of a radix-R pass grow as R^2),
    then its source (dft_staged.cu's build compiles every sample type's
    kernel 1, dft_cluster.cu's the largest kernels of the others)."""
    rank = {"dft_staged": 2, "dft_cluster": 1}.get(name, 0)
    return (variant[0] if variant else 0, rank)


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library of `names` (each build of VARIANTS) that is
    not built yet: one nvcc a library, as many at once as the process has
    cores, the longest first (_weight), so that no long build is left to
    run alone at the end.

    Returns {name, name-odd<r> or name-odd<r>-t<t>: nvcc output} for the libraries
    compiled by this call (ptxas prints each kernel's registers, shared
    memory and spills); build.seconds holds each one's wall from the start
    of the call to the end of its nvcc.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    t0 = time.perf_counter()
    for name in names:
        for variant in VARIANTS.get(name, (None,)):
            out = library_path(name, variant)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *_flags(variant), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs.append((_weight(name, variant), f"{name}{_tag(variant)}", cmd, tmp, out))
    jobs.sort(key=lambda job: job[0], reverse=True)
    queue = iter(jobs)
    lock = threading.Lock()
    logs, seconds, codes = {}, {}, {}

    def worker():
        while True:
            with lock:
                job = next(queue, None)
            if job is None:
                return
            _, name, cmd, _, _ = job
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs[name], codes[name] = proc.stdout, proc.returncode
            seconds[name] = time.perf_counter() - t0

    workers = [threading.Thread(target=worker)
               for _ in range(min(len(jobs), len(os.sched_getaffinity(0))))]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    failed = []
    for _, name, _, tmp, out in jobs:
        if codes[name] != 0:
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build.seconds = dict(sorted(seconds.items(), key=lambda kv: kv[1]))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


build.seconds = {}


def load(name: str, variant: tuple[int, int | None] | None = None) -> ctypes.CDLL:
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
