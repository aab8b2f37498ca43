"""A small pure-Python msgpack decoder and encoder for flax checkpoints.

flax.serialization writes a nested map of str keys whose leaves are numpy
arrays, each packed as msgpack ExtType 1 holding another msgpack document:
the tuple (shape, dtype name, raw C-order bytes). ExtType 3 is a numpy
scalar in the same form. This module decodes that subset (maps, arrays,
str, bin, ints, floats, nil, bools, ExtType 1 and 3) and encodes it
(`packb`), so the port reads the bundled weights and writes checkpoints
that flax reads, without the `msgpack` package.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {
            0xC0: lambda: None,
            0xC2: lambda: False,
            0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"),
            0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"),
            0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"),
            0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"),
            0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"),
            0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1),
            0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str(self.unpack(">B")),
            0xDA: lambda: self.str(self.unpack(">H")),
            0xDB: lambda: self.str(self.unpack(">I")),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ExtType {code}")
        shape, dtype_name, buffer = unpackb(payload)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode("ascii")
        if dtype_name == "bfloat16":
            raise ValueError("bfloat16 checkpoint leaves are not supported")
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes):
    """Decode one msgpack document (the whole of `data`)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack document")
    return out


def _pack_len(n: int, fix: tuple[int, int] | None, codes: tuple[int, ...]) -> bytes:
    """The header of a sized value: `fix` is (base byte, largest fix
    length) where the format has a fix form, `codes` its 8/16/32-bit (or
    16/32-bit) type bytes."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    if len(codes) == 3 and n < 1 << 8:
        return bytes([codes[0]]) + struct.pack(">B", n)
    if n < 1 << 16:
        return bytes([codes[-2]]) + struct.pack(">H", n)
    if n < 1 << 32:
        return bytes([codes[-1]]) + struct.pack(">I", n)
    raise ValueError(f"value of length {n} does not fit a msgpack header")


def _pack_ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype == object:
        raise ValueError("object arrays cannot be packed")
    payload = _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        head = bytes([0xD4 + (1, 2, 4, 8, 16).index(n)])
    else:
        head = _pack_len(n, None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", _EXT_NDARRAY) + payload


def _pack(obj) -> bytes:
    if obj is None:
        return b"\xc0"
    if isinstance(obj, (bool, np.bool_)):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, (int, np.integer)):
        v = int(obj)
        if 0 <= v <= 0x7F:
            return bytes([v])
        if -32 <= v < 0:
            return struct.pack(">b", v)
        # the smallest form that holds it, as the msgpack package chooses
        if v >= 0:
            for code, fmt, bits in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                                    (0xCE, ">I", 32), (0xCF, ">Q", 64)):
                if v < 1 << bits:
                    return bytes([code]) + struct.pack(fmt, v)
            raise ValueError(f"integer {v} does not fit msgpack")
        for code, fmt, bits in ((0xD0, ">b", 8), (0xD1, ">h", 16),
                                (0xD2, ">i", 32), (0xD3, ">q", 64)):
            if v >= -(1 << (bits - 1)):
                return bytes([code]) + struct.pack(fmt, v)
        raise ValueError(f"integer {v} does not fit msgpack")
    if isinstance(obj, (float, np.floating)):
        return b"\xcb" + struct.pack(">d", float(obj))
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        return _pack_len(len(raw), None, (0xC4, 0xC5, 0xC6)) + raw
    if isinstance(obj, np.ndarray):
        return _pack_ndarray(obj)
    if isinstance(obj, (list, tuple)):
        return _pack_len(len(obj), (0x90, 15), (0xDC, 0xDD)) + b"".join(
            _pack(v) for v in obj)
    if isinstance(obj, dict):
        out = [_pack_len(len(obj), (0x80, 15), (0xDE, 0xDF))]
        for key, value in obj.items():
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            out.append(_pack(key))
            out.append(_pack(value))
        return b"".join(out)
    raise ValueError(f"cannot pack a {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode nested dicts (str keys), lists, scalars, bytes and numpy
    arrays as one msgpack document in flax.serialization's layout: every
    array is ExtType 1 around the packed (shape, dtype name, C-order
    bytes), which is what `unpackb` and flax's `msgpack_restore` read."""
    return _pack(obj)
