"""Host C helpers built at first use and loaded with ctypes: the LZ4 block
codec behind blosc-framed zarr stores (lz4enc.c, lz4dec.c).

Counterpart of the LZ4 part of orcai_tpu/native/__init__.py. The sources
are compiled together by the host C compiler into
`orcai_tpu_torch/_build/liborcai_lz4-<hash>.so`, the directory the CUDA
kernels are built into (ops/_build.py); the hash covers the sources and the
host's instruction-set flags, since the library is built with
-march=native. Every entry point returns None when the library cannot be
built or loaded (no compiler, or ORCAI_TPU_DISABLE_NATIVE=1): io/blosc.py
then decodes in Python and refuses to encode, and zarrlite's "auto" codec
is gzip. These are host codecs, not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

_SOURCES = ("lz4enc.c", "lz4dec.c")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def _compilers() -> list[str]:
    return [os.environ["CC"]] if os.environ.get("CC") else ["cc", "gcc"]


def _isa_fingerprint() -> bytes:
    """The host's instruction-set flags: a library built with -march=native
    elsewhere must not be loaded here."""
    marker = platform.machine().encode()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    marker += b"|" + b" ".join(sorted(line.split()[2:]))
                    break
    except OSError:
        pass
    return marker


def library_path() -> Path:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((Path(__file__).parent / name).read_bytes())
    h.update(_isa_fingerprint())
    return BUILD_DIR / f"liborcai_lz4-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile the sources into `out` (atomic rename); True on success.
    -march=native first, plain -O3 where the compiler rejects it: the code
    is integer arithmetic, so the flag changes speed, never output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = [str(Path(__file__).parent / name) for name in _SOURCES]
    for cc in _compilers():
        for arch in (["-march=native"], []):
            fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so")
            os.close(fd)
            try:
                proc = subprocess.run(
                    [cc, "-O3", *arch, "-shared", "-fPIC", "-o", tmp, *srcs],
                    capture_output=True, timeout=120,
                )
                if proc.returncode == 0:
                    os.replace(tmp, out)
                    return True
            except (OSError, subprocess.TimeoutExpired):
                pass
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return False


@lru_cache(maxsize=1)
def _load() -> ctypes.CDLL | None:
    if os.environ.get("ORCAI_TPU_DISABLE_NATIVE") == "1":
        return None
    try:
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        lib = ctypes.CDLL(str(so))
        for fn in (lib.orcai_lz4_decompress, lib.orcai_lz4_compress):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
            fn.restype = ctypes.c_int64
        return lib
    except Exception:  # noqa: BLE001 - any failure means no native codec
        return None


def native_available() -> bool:
    return _load() is not None


def lz4_decompress_native(src: bytes, dest_size: int) -> bytes | None:
    """LZ4 block decode via C, or None if unavailable; ValueError on a
    malformed block."""
    lib = _load()
    if lib is None:
        return None
    dst = ctypes.create_string_buffer(dest_size)
    n = lib.orcai_lz4_decompress(src, len(src), dst, dest_size)
    if n != dest_size:
        raise ValueError(
            "corrupt lz4 block: bad match offset, truncation, or overrun "
            f"(produced {n} bytes, expected {dest_size})"
        )
    return dst.raw


def lz4_compress_native(src: bytes) -> bytes | None:
    """LZ4 block encode via C, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(src)
    if n > 0x7FFFFFF0:
        raise ValueError(
            f"lz4 compress: input too large ({n} bytes > 0x7ffffff0); chunk the payload"
        )
    cap = n + n // 255 + 16
    dst = ctypes.create_string_buffer(cap)
    written = lib.orcai_lz4_compress(src, n, dst, cap)
    if written < 0:  # pragma: no cover - cap is the worst case by the spec
        raise ValueError("lz4 compress: output buffer overflow")
    return dst.raw[:written]
