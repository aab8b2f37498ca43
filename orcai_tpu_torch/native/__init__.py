"""Host C helpers built at first use and loaded with ctypes: the LZ4 block
codec behind blosc-framed zarr stores (lz4enc.c, lz4dec.c), the wire-codec
encoders (wirecodec.c: mu-law, bfp6/bfp5), the L/M polyphase resamplers
of the spectral wires (resample.c), the evaluation upload's u8/u16
quantizer (quant.c) and the CRC-32C that checks every record of a tf.data
snapshot (crc32c.c).

Counterpart of orcai_tpu/native/__init__.py. The sources are compiled
together by the host C compiler into
`orcai_tpu_torch/_build/liborcai_native-<hash>.so`, the directory the CUDA
kernels are built into (ops/_build.py); the hash covers the sources and the
host's instruction-set flags, since the library is built with
-march=native. Every entry point returns None (or False) when the library
cannot be built or loaded (no compiler, or ORCAI_TPU_DISABLE_NATIVE=1):
io/blosc.py then decodes in Python and refuses to encode, zarrlite's "auto"
codec is gzip, and the wire codecs, the resampler and the quantizer take
their numpy paths, which give the same integers. The snapshot reader has no
Python path: without the library it raises. These are host codecs, not
device kernels.
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

import numpy as np

_SOURCES = ("lz4enc.c", "lz4dec.c", "wirecodec.c", "resample.c", "quant.c", "crc32c.c")
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
    return BUILD_DIR / f"liborcai_native-{h.hexdigest()[:16]}.so"


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
        lib.orcai_mulaw_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.orcai_mulaw_encode.restype = None
        lib.orcai_bfp_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.orcai_bfp_encode.restype = None
        lib.orcai_resample34.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.orcai_resample34.restype = ctypes.c_int64
        lib.orcai_resample_poly.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.orcai_resample_poly.restype = ctypes.c_int64
        for fn in (lib.orcai_quant_u8, lib.orcai_quant_u16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            fn.restype = None
        lib.orcai_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
        lib.orcai_crc32c.restype = ctypes.c_uint32
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


def crc32c_native(data: bytes) -> int | None:
    """CRC-32C of `data` via C, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.orcai_crc32c(data, len(data), 0))


def quantize_linear_native(x: np.ndarray, dtype) -> np.ndarray | None:
    """float32 -> uint8 / uint16 codes, rint(x * scale) clipped to [0,
    scale] (255 or 65535), via C in one pass, or None if unavailable.
    Bit-equal to the numpy chain of train/evaluate.quantize_eval_upload."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype)
    fn = lib.orcai_quant_u8 if out.dtype == np.uint8 else lib.orcai_quant_u16
    fn(x.ctypes.data, x.size, out.ctypes.data)
    return out


def mulaw_encode_native(x: np.ndarray, lut: np.ndarray) -> np.ndarray | None:
    """int16 PCM -> uint8 mu-law codes via C, or None if unavailable.
    `lut` is wire_codec.encode_table(): sharing it keeps the native path
    identical to the numpy path by construction."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.int16)
    out = np.empty(x.size, np.uint8)
    lib.orcai_mulaw_encode(x.ctypes.data, x.size, lut.ctypes.data, out.ctypes.data)
    return out.reshape(x.shape)


# the C kernel's fixed layout (wirecodec.c): 128-sample blocks, packed
# bytes per block keyed by mantissa width
_BFP_C_BLOCK = 128
_BFP_C_BLOCK_BYTES = {6: 96, 5: 80}


def bfp_encode_into(
    x: np.ndarray, mant_bits: int, block: int, packed_out: np.ndarray,
    shifts_out: np.ndarray,
) -> bool:
    """Encode into caller-provided output views (e.g. one shared buffer).

    Returns False, without touching the outputs, when the library is
    unavailable. The outputs must be C-contiguous uint8 views sized for
    ceil(len(x)/block) blocks; x is zero-padded to a whole block count.
    Raises ValueError for a geometry the C kernel does not implement (it
    takes 128-sample blocks and 6/5-bit mantissas only) and for outputs of
    the wrong size or type (the C side cannot check them).
    """
    lib = _load()
    if lib is None:
        return False
    if block != _BFP_C_BLOCK or mant_bits not in _BFP_C_BLOCK_BYTES:
        raise ValueError(
            f"native bfp encoder supports block={_BFP_C_BLOCK}, mant_bits in "
            f"{sorted(_BFP_C_BLOCK_BYTES)}; got block={block}, mant_bits={mant_bits}"
        )
    x = np.ascontiguousarray(x, dtype=np.int16)
    pad = (-x.shape[0]) % block
    if pad:
        x = np.pad(x, (0, pad))
    n_blocks = x.shape[0] // block
    for name, out, want in (
        ("packed_out", packed_out, n_blocks * _BFP_C_BLOCK_BYTES[mant_bits]),
        ("shifts_out", shifts_out, n_blocks),
    ):
        if out.dtype != np.uint8 or not out.flags.c_contiguous:
            raise ValueError(f"{name} must be a C-contiguous uint8 array")
        if out.size != want:
            raise ValueError(f"{name} has {out.size} bytes, need {want}")
    lib.orcai_bfp_encode(
        x.ctypes.data, n_blocks, mant_bits, packed_out.ctypes.data, shifts_out.ctypes.data,
    )
    return True


def bfp_encode_native(
    x: np.ndarray, mant_bits: int, block: int, block_bytes: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """int16 PCM (n,) -> (packed uint8, shifts uint8) via C, or None;
    bit-exact with wire_codec.bfp_encode."""
    n_blocks = -(-np.asarray(x).shape[0] // block)
    packed = np.empty(n_blocks * block_bytes, np.uint8)
    shifts = np.empty(n_blocks, np.uint8)
    if not bfp_encode_into(x, mant_bits, block, packed, shifts):
        return None
    return packed, shifts


def resample34_native(x: np.ndarray, taps: np.ndarray, n_out: int) -> np.ndarray | None:
    """3/4 polyphase resample via C (resample.c), or None if unavailable.

    `taps` is the int16 Q15 prototype of ops.spectral.design_taps(sr,
    pass_hz, 3, 4). Bit-exact with the numpy path of ops/spectral.py.
    Raises ValueError when the C kernel rejects the geometry: the designer
    never makes one it rejects, so that is a fault, not a fallback.
    """
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.int16)
    taps = np.ascontiguousarray(taps, dtype=np.int16)
    out = np.empty(int(n_out), np.int16)
    rc = lib.orcai_resample34(
        x.ctypes.data, x.size, taps.ctypes.data, taps.size, out.ctypes.data, out.size,
    )
    if rc == -2:
        return None  # allocation failure: the numpy path still works
    if rc != 0:
        raise ValueError(
            f"native resampler rejected geometry (rc={rc}): n_taps={taps.size}, "
            f"n_in={x.size}, n_out={n_out}"
        )
    return out


def resample_poly_native(
    x: np.ndarray, taps: np.ndarray, L: int, M: int, n_out: int
) -> np.ndarray | None:
    """Generic L/M polyphase resample via C (resample.c), or None if
    unavailable (or L beyond the C kernel's per-phase arrays, 64).
    Bit-exact with ops/spectral._resample_poly_numpy; raises ValueError on
    a geometry the C kernel rejects."""
    if int(L) > 64:
        return None
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.int16)
    taps = np.ascontiguousarray(taps, dtype=np.int16)
    out = np.empty(int(n_out), np.int16)
    rc = lib.orcai_resample_poly(
        x.ctypes.data, x.size, taps.ctypes.data, taps.size, int(L), int(M),
        out.ctypes.data, out.size,
    )
    if rc == -2:
        return None
    if rc != 0:
        raise ValueError(
            f"native poly resampler rejected geometry (rc={rc}): L={L} M={M} "
            f"n_taps={taps.size}, n_in={x.size}, n_out={n_out}"
        )
    return out
