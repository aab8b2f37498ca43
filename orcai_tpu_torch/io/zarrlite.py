"""Minimal zarr-v3-compatible chunked array store (no zarr dependency).

Counterpart of orcai_tpu/io/zarrlite.py, copied with the same on-disk
format and codec policy. A store is a directory with a ``zarr.json`` v3
metadata document and chunk files under ``c/<i>/<j>`` (default chunk-key
encoding), each chunk encoded with the ``bytes`` (little-endian) codec
followed optionally by ``gzip`` or ``blosc``.

Only what the pipeline needs is implemented: 2-D (and 1-D) arrays, C order,
regular chunk grid; gzip, blosc (lz4/zlib/zstd inner codecs, byte-shuffle,
via io/blosc.py), zstd (gated on an available implementation) or
uncompressed codecs. Edge chunks are stored full-size padded with the fill
value, per the v3 spec. The codec that `save_as_zarr(compress="auto")`
chooses is logged once per process.
"""

from __future__ import annotations

import gzip
import json
import logging
import math
import zlib
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)
_logged_codecs: set[str] = set()

_DTYPES = {
    "float32": np.float32,
    "float64": np.float64,
    "int32": np.int32,
    "int64": np.int64,
    "int8": np.int8,
    "uint8": np.uint8,
    "bool": np.bool_,
}


def _zstd_decompress(data: bytes) -> bytes:
    """Decompress a zstd frame via whichever implementation is available.

    Tries the 3.14+ stdlib module, then the `zstandard` package. Raises a
    clear error when neither exists (real-world
    zarr v3 stores default to zstd, so the hook matters for users who do
    have one of these modules).
    """
    try:  # pragma: no cover - stdlib module requires python >= 3.14
        from compression import zstd  # type: ignore

        return zstd.decompress(data)
    except ImportError:
        pass
    try:  # pragma: no cover - zstandard is optional
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data)
    except ImportError:
        raise NotImplementedError(
            "this zarr array uses the zstd codec; reading it needs either "
            "python >= 3.14 (compression.zstd) or the `zstandard` package"
        ) from None


def _decode_chunk(raw: bytes, codecs: list[dict], dtype, chunk_shape) -> np.ndarray:
    data = raw
    # apply bytes->bytes codecs in reverse order down to the bytes codec
    for codec in reversed(codecs):
        name = codec["name"]
        if name == "gzip":
            data = gzip.decompress(data)
        elif name == "zstd":
            data = _zstd_decompress(data)
        elif name == "blosc":
            from orcai_tpu_torch.io.blosc import blosc_decompress

            data = blosc_decompress(data)
        elif name == "bytes":
            endian = codec.get("configuration", {}).get("endian", "little")
            dt = np.dtype(dtype).newbyteorder("<" if endian == "little" else ">")
            return np.frombuffer(data, dtype=dt).reshape(chunk_shape).astype(dtype)
        else:
            raise NotImplementedError(f"codec {name!r} not supported by zarrlite")
    # no explicit bytes codec: assume little-endian raw
    return np.frombuffer(data, dtype=dtype).reshape(chunk_shape)


class ZarrArray:
    """Read-only view of a zarr v3 array directory with numpy-style slicing."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        meta = json.loads((self.path / "zarr.json").read_text())
        if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
            raise ValueError(f"{self.path} is not a zarr v3 array")
        self.shape = tuple(meta["shape"])
        self.dtype = _DTYPES[meta["data_type"]]
        self.chunk_shape = tuple(
            meta["chunk_grid"]["configuration"]["chunk_shape"]
        )
        self.fill_value = meta.get("fill_value", 0)
        self.codecs = meta.get("codecs", [{"name": "bytes"}])
        cfg = meta.get("chunk_key_encoding", {"configuration": {"separator": "/"}})
        self.sep = cfg.get("configuration", {}).get("separator", "/")

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _chunk_path(self, idx: tuple[int, ...]) -> Path:
        return self.path / self.sep.join(["c", *map(str, idx)])

    def _read_chunk(self, idx: tuple[int, ...]) -> np.ndarray:
        p = self._chunk_path(idx)
        if not p.exists():
            return np.full(self.chunk_shape, self.fill_value, dtype=self.dtype)
        return _decode_chunk(p.read_bytes(), self.codecs, self.dtype, self.chunk_shape)

    def __getitem__(self, key) -> np.ndarray:
        # normalize to per-axis slices
        if not isinstance(key, tuple):
            key = (key,)
        key = key + (slice(None),) * (self.ndim - len(key))
        slices = []
        for k, n in zip(key, self.shape):
            if isinstance(k, slice):
                if k.step not in (None, 1):
                    raise NotImplementedError(
                        "zarrlite supports step-1 slices only"
                    )
                slices.append(slice(*k.indices(n)))
            elif isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += n
                if not 0 <= k < n:
                    raise IndexError(
                        f"index {k} out of bounds for axis of size {n}"
                    )
                slices.append(slice(k, k + 1))
            else:
                raise TypeError(f"unsupported index {k!r}")
        # max(0, ...): an empty descending slice (start > stop, e.g. [5:2])
        # must return an empty array like numpy/zarr, not a negative dim
        out_shape = tuple(max(0, s.stop - s.start) for s in slices)
        out = np.empty(out_shape, dtype=self.dtype)
        if any(d == 0 for d in out_shape):
            return out

        # iterate over the chunks intersecting the request
        c0 = [s.start // c for s, c in zip(slices, self.chunk_shape)]
        c1 = [(s.stop - 1) // c for s, c in zip(slices, self.chunk_shape)]
        ranges = [range(a, b + 1) for a, b in zip(c0, c1)]

        def rec(axis, idx):
            if axis == self.ndim:
                chunk = self._read_chunk(tuple(idx))
                src, dst = [], []
                for ax in range(self.ndim):
                    cstart = idx[ax] * self.chunk_shape[ax]
                    lo = max(slices[ax].start, cstart)
                    hi = min(slices[ax].stop, cstart + self.chunk_shape[ax])
                    src.append(slice(lo - cstart, hi - cstart))
                    dst.append(slice(lo - slices[ax].start, hi - slices[ax].start))
                out[tuple(dst)] = chunk[tuple(src)]
                return
            for i in ranges[axis]:
                rec(axis + 1, idx + [i])

        rec(0, [])
        # collapse integer-indexed axes
        squeeze = tuple(
            ax for ax, k in enumerate(key[: self.ndim])
            if isinstance(k, (int, np.integer))
        )
        return out.squeeze(axis=squeeze) if squeeze else out


def open_zarr(path: Path | str) -> ZarrArray:
    return ZarrArray(path)


def resolve_zarr_codec(compress) -> str | None:
    """Normalize a save_as_zarr `compress` argument to a codec name.

    True/"gzip" -> "gzip" (the reference's layout); "blosc-lz4" -> blosc
    frames with byte-shuffle + the LZ4 inner codec (zarr-python v2's
    default compressor family); False/None -> uncompressed. "auto" picks
    blosc-lz4 when the native C encoder is available and gzip otherwise,
    since the port has no LZ4 encoder in Python (ORCAI_TPU_ZARR_CODEC
    overrides the auto choice).
    """
    if compress is True:
        return "gzip"
    if compress in (False, None):
        return None
    if compress == "auto":
        import os

        env = os.environ.get("ORCAI_TPU_ZARR_CODEC")
        if env:
            return resolve_zarr_codec(env if env != "none" else None)
        from orcai_tpu_torch.native import native_available

        codec = "blosc-lz4" if native_available() else "gzip"
        if codec not in _logged_codecs:
            _logged_codecs.add(codec)
            log.info(
                "zarr codec: %s (%s)", codec,
                "the C LZ4 encoder loaded" if codec == "blosc-lz4"
                else "no C LZ4 encoder: the host compiler did not build it",
            )
        return codec
    if compress in ("gzip", "blosc-lz4"):
        return compress
    raise ValueError(
        f"unsupported zarr codec {compress!r} "
        "(expected True/False/None, 'gzip', 'blosc-lz4' or 'auto')"
    )


def save_as_zarr(
    obj: np.ndarray,
    filename: Path | str,
    chunks: tuple[int, ...] | None = None,
    dtype: str = "float32",
    compress: bool | str | None = True,
    gzip_level: int = 5,
) -> None:
    """Write an array as a zarr v3 directory.

    Defaults match the reference's layout (io.py:296-331): float32, chunk
    rows of 2000 spanning the full width, gzip compression. `compress`
    also accepts "blosc-lz4" (byte-shuffled LZ4 frames via the native C
    encoder — ~20-50x faster chunk writes than gzip on the single host
    core, the codec family zarr-python v2 wrote by default) and "auto"
    (blosc-lz4 when the C encoder is available, else gzip); see
    resolve_zarr_codec.
    """
    arr = np.asarray(obj, dtype=_DTYPES[dtype])
    if chunks is None:
        chunks = (min(2000, arr.shape[0]), *arr.shape[1:])
    chunks = tuple(int(min(c, s)) if s > 0 else 1 for c, s in zip(chunks, arr.shape))

    codec = resolve_zarr_codec(compress)
    path = Path(filename)
    path.mkdir(parents=True, exist_ok=True)
    codecs = [{"name": "bytes", "configuration": {"endian": "little"}}]
    if codec == "gzip":
        codecs.append({"name": "gzip", "configuration": {"level": gzip_level}})
    elif codec == "blosc-lz4":
        codecs.append(
            {
                "name": "blosc",
                "configuration": {
                    "cname": "lz4",
                    "clevel": 1,
                    "shuffle": "shuffle",
                    "typesize": int(np.dtype(_DTYPES[dtype]).itemsize),
                    "blocksize": 0,
                },
            }
        )
    meta = {
        "zarr_format": 3,
        "node_type": "array",
        "shape": list(arr.shape),
        "data_type": dtype,
        "chunk_grid": {
            "name": "regular",
            "configuration": {"chunk_shape": list(chunks)},
        },
        "chunk_key_encoding": {
            "name": "default",
            "configuration": {"separator": "/"},
        },
        "fill_value": 0.0 if "float" in dtype else 0,
        "codecs": codecs,
        "attributes": {},
    }
    (path / "zarr.json").write_text(json.dumps(meta, indent=2))

    n_chunks = [math.ceil(s / c) for s, c in zip(arr.shape, chunks)]
    for flat in range(int(np.prod(n_chunks))):
        idx, rem = [], flat
        for n in reversed(n_chunks):
            idx.append(rem % n)
            rem //= n
        idx = tuple(reversed(idx))
        sel = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, arr.shape)
        )
        block = arr[sel]
        if block.shape != chunks:  # pad edge chunks to full size (v3 spec)
            full = np.full(chunks, meta["fill_value"], dtype=arr.dtype)
            full[tuple(slice(0, b) for b in block.shape)] = block
            block = full
        data = np.ascontiguousarray(block, dtype="<" + np.dtype(arr.dtype).str[1:])
        raw = data.tobytes()
        if codec == "gzip":
            co = zlib.compressobj(gzip_level, zlib.DEFLATED, 31)
            raw = co.compress(raw) + co.flush()
        elif codec == "blosc-lz4":
            from orcai_tpu_torch.io.blosc import blosc_compress

            raw = blosc_compress(
                raw, typesize=np.dtype(arr.dtype).itemsize, cname="lz4"
            )
        chunk_file = path.joinpath("c", *map(str, idx))
        chunk_file.parent.mkdir(parents=True, exist_ok=True)
        chunk_file.write_bytes(raw)
