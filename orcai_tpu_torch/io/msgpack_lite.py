"""A small pure-Python msgpack decoder for flax checkpoints.

flax.serialization writes a nested map of str keys whose leaves are numpy
arrays, each packed as msgpack ExtType 1 holding another msgpack document:
the tuple (shape, dtype name, raw C-order bytes). ExtType 3 is a numpy
scalar in the same form. This module decodes that subset (maps, arrays,
str, bin, ints, floats, nil, bools, ExtType 1 and 3) so the port can read
the bundled weights without the `msgpack` package.
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
