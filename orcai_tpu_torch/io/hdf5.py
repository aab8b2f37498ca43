"""A read-only HDF5 subset: what Keras and h5py write for model weights,
and nothing more. No h5py or libhdf5 is needed.

Read:
- superblock version 0 (8-byte offsets and lengths), version-1 object
  headers with continuation blocks;
- old-style groups: a symbol-table message, its version-1 B-tree of group
  nodes, the SNOD symbol nodes and the local heap of link names;
- dataspace (versions 1 and 2), datatype and layout (version 3) messages:
  IEEE float32 / float64 and integers, little-endian; fixed-length strings
  and variable-length strings (kept in the global heap, GCOL); contiguous
  and compact layouts;
- attributes (message versions 1-3) of those types.

A chunked or filtered dataset, a shared or new-style message, a soft link
or any other message it cannot read raises `H5Error` with the file and the
object's path: it never returns values that might be wrong. Values come
back as h5py gives attributes: numpy arrays, numpy scalars for scalar
dataspaces, `str` for variable-length strings and `bytes` for fixed ones.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types (HDF5 file format specification, IV.A.2)
NIL, DATASPACE, DATATYPE, FILL_OLD, FILL = 0x0, 0x1, 0x3, 0x4, 0x5
LAYOUT, FILTERS, ATTRIBUTE, COMMENT = 0x8, 0xB, 0xC, 0xD
MTIME_OLD, CONTINUATION, SYMBOL_TABLE, MTIME = 0xE, 0x10, 0x11, 0x12
# messages that hold nothing a value depends on (a fill value matters only
# for unallocated storage, which raises)
_IGNORED = {NIL, FILL_OLD, FILL, COMMENT, MTIME_OLD, MTIME}


class H5Error(ValueError):
    """Something the reader does not parse, named by file and object path."""


class _Type:
    """A datatype message: `kind` is "float", "int", "string" or "vlen_string"."""

    def __init__(self, kind: str, size: int, dtype: np.dtype | None = None):
        self.kind, self.size, self.dtype = kind, size, dtype


def _parse_datatype(buf: bytes, at: int, where: str) -> tuple[_Type, int]:
    """(datatype, bytes it took) of the message at buf[at:]."""
    head, b1, b2, b3, size = struct.unpack_from("<BBBBI", buf, at)
    cls, version = head & 0x0F, head >> 4
    bits = b1 | (b2 << 8) | (b3 << 16)
    if version not in (1, 2, 3):
        raise H5Error(f"{where}: datatype version {version}")
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", buf, at + 8)
        if bits & 1 or offset != 0 or precision != 8 * size or size not in (1, 2, 4, 8):
            raise H5Error(f"{where}: integer type of {size} bytes, precision {precision}, "
                          f"flags {bits:#x} is not read")
        kind = "i" if bits & 0x8 else "u"
        return _Type("int", size, np.dtype(f"<{kind}{size}")), 12
    if cls == 1:  # floating point
        props = struct.unpack_from("<HHBBBBI", buf, at + 8)
        ieee = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}
        sign = (bits >> 8) & 0xFF
        if bits & 0x41 or ieee.get(size) != props or sign != 8 * size - 1:
            raise H5Error(f"{where}: float type of {size} bytes {props}, flags {bits:#x} "
                          "is not a little-endian IEEE float32 or float64")
        return _Type("float", size, np.dtype(f"<f{size}")), 20
    if cls == 3:  # fixed-length string
        return _Type("string", size, np.dtype(f"S{size}")), 8
    if cls == 9:  # variable-length
        if bits & 0x0F != 1:
            raise H5Error(f"{where}: variable-length sequence type is not read")
        base, used = _parse_datatype(buf, at + 8, where)
        if base.size != 1:
            raise H5Error(f"{where}: variable-length string of {base.size}-byte characters")
        return _Type("vlen_string", size), 8 + used
    raise H5Error(f"{where}: datatype class {cls} is not read")


def _parse_dataspace(buf: bytes, at: int, where: str) -> tuple[int, ...]:
    """The shape in the dataspace message at buf[at:]."""
    version, rank, flags = buf[at], buf[at + 1], buf[at + 2]
    if version == 1:
        start = at + 8
        if flags & 2:
            raise H5Error(f"{where}: dataspace permutation is not read")
    elif version == 2:
        if buf[at + 3] == 2:
            raise H5Error(f"{where}: null dataspace (no data) is not read")
        start = at + 4
    else:
        raise H5Error(f"{where}: dataspace version {version}")
    return tuple(int(d) for d in struct.unpack_from(f"<{rank}Q", buf, start))


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class H5File:
    """An HDF5 file in memory; `root` is its root group."""

    def __init__(self, source: Path | str | bytes, name: str | None = None):
        if isinstance(source, (str, Path)):
            name = name or str(source)
            source = Path(source).read_bytes()
        self.buf, self.name = bytes(source), name or "<bytes>"
        if self.buf[:8] != SIGNATURE:
            raise H5Error(f"{self.name}: no HDF5 signature at offset 0")
        version, offsets, lengths = self.buf[8], self.buf[13], self.buf[14]
        if version != 0:
            raise H5Error(f"{self.name}: superblock version {version}, only 0 is read")
        if offsets != 8 or lengths != 8:
            raise H5Error(f"{self.name}: {offsets}-byte offsets and {lengths}-byte lengths")
        self.base = struct.unpack_from("<Q", self.buf, 24)[0]
        root_header = struct.unpack_from("<Q", self.buf, 56 + 8)[0]
        self._heaps: dict[int, dict[int, bytes]] = {}
        self.root = self._open("/", root_header)

    # -- raw access --------------------------------------------------------------

    def _at(self, address: int, n: int, where: str) -> bytes:
        start = self.base + address
        if address == UNDEFINED or start + n > len(self.buf):
            raise H5Error(f"{self.name}:{where}: address {address:#x} (+{n}) outside the file")
        return self.buf[start:start + n]

    def _signed(self, address: int, signature: bytes, size: int, where: str) -> bytes:
        block = self._at(address, size, where)
        if block[:4] != signature:
            raise H5Error(f"{self.name}:{where}: no {signature.decode()} at {address:#x}")
        return block

    def _messages(self, address: int, path: str) -> list[tuple[int, bytes]]:
        """(type, data) of every message of the version-1 object header at
        `address`, continuation blocks followed."""
        header = self._at(address, 16, path)
        version, size = header[0], struct.unpack_from("<I", header, 8)[0]
        if version != 1:
            raise H5Error(f"{self.name}:{path}: object header version {version}")
        blocks, out = [(address + 16, size)], []
        while blocks:
            start, length = blocks.pop(0)
            block = self._at(start, length, path)
            pos = 0
            while pos + 8 <= length:
                kind, n, flags = struct.unpack_from("<HHB", block, pos)
                data = block[pos + 8:pos + 8 + n]
                pos += 8 + n
                if flags & 0x2:
                    raise H5Error(f"{self.name}:{path}: shared message of type {kind:#x}")
                if kind == CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif kind not in _IGNORED:
                    out.append((kind, data))
        return out

    def _open(self, path: str, address: int):
        messages = self._messages(address, path)
        kinds = {kind for kind, _ in messages}
        if SYMBOL_TABLE in kinds:
            return H5Group(self, path, messages)
        if LAYOUT in kinds:
            return H5Dataset(self, path, messages)
        raise H5Error(f"{self.name}:{path}: object with messages {sorted(kinds)} is neither "
                      "an old-style group nor a dataset")

    def _links(self, btree: int, heap: int, path: str) -> dict[str, int]:
        """name -> object header address of a group's symbol table."""
        hp = self._signed(heap, b"HEAP", 32, path)
        seg_size, _, seg_addr = struct.unpack_from("<QQQ", hp, 8)
        names = self._at(seg_addr, seg_size, path)
        links: dict[str, int] = {}
        nodes = [btree]
        while nodes:
            node = nodes.pop(0)
            head = self._signed(node, b"TREE", 24, path)
            node_type, level, used = head[4], head[5], struct.unpack_from("<H", head, 6)[0]
            if node_type != 0:
                raise H5Error(f"{self.name}:{path}: B-tree node type {node_type} in a group")
            body = self._at(node + 24, 8 + 16 * used, path)
            children = [struct.unpack_from("<Q", body, 16 * i + 8)[0] for i in range(used)]
            if level > 0:
                nodes[:0] = children
                continue
            for snod in children:
                head = self._signed(snod, b"SNOD", 8, path)
                n = struct.unpack_from("<H", head, 6)[0]
                entries = self._at(snod + 8, 40 * n, path)
                for i in range(n):
                    offset, obj, cache = struct.unpack_from("<QQI", entries, 40 * i)
                    name = names[offset:names.index(b"\0", offset)].decode()
                    if cache == 2:
                        raise H5Error(f"{self.name}:{path}/{name}: soft link is not read")
                    links[name] = obj
        return links

    def _vlen_string(self, element: bytes, where: str) -> str:
        length, collection, index = struct.unpack("<IQI", element)
        if collection == 0 and length == 0:
            return ""
        if collection not in self._heaps:
            head = self._signed(collection, b"GCOL", 16, where)
            size = struct.unpack_from("<Q", head, 8)[0]
            block = self._at(collection, size, where)
            objects, pos = {}, 16
            while pos + 16 <= size:
                idx, _, n = struct.unpack_from("<HHxxxxQ", block, pos)
                if idx == 0:  # free space: the end of the objects
                    break
                objects[idx] = block[pos + 16:pos + 16 + n]
                pos += 16 + _pad8(n)
            self._heaps[collection] = objects
        objects = self._heaps[collection]
        if index not in objects or len(objects[index]) < length:
            raise H5Error(f"{self.name}:{where}: global heap object {index} missing or short")
        return objects[index][:length].decode("utf-8")

    def _values(self, raw: bytes, dtype: _Type, shape: tuple[int, ...], where: str):
        count = int(np.prod(shape, dtype=np.int64))
        if len(raw) != count * dtype.size:
            raise H5Error(f"{self.name}:{where}: {len(raw)} bytes for {count} elements of "
                          f"{dtype.size} bytes")
        if dtype.kind == "vlen_string":
            flat = [self._vlen_string(raw[16 * i:16 * i + 16], where) for i in range(count)]
            out = np.empty(count, object)
            out[:] = flat
            out = out.reshape(shape)
        else:
            out = np.frombuffer(raw, dtype.dtype).reshape(shape).copy()
        return out[()] if shape == () else out


class _Object:
    def __init__(self, file: H5File, path: str, messages: list[tuple[int, bytes]]):
        self.file, self.name, self._messages = file, path, messages
        self._attrs: dict | None = None

    def _where(self) -> str:
        return f"{self.file.name}:{self.name}"

    @property
    def attrs(self) -> dict:
        """Attribute name -> value, decoded on first use."""
        if self._attrs is None:
            self._attrs = {}
            for kind, data in self._messages:
                if kind == ATTRIBUTE:
                    name, value = self._attribute(data)
                    self._attrs[name] = value
        return self._attrs

    def _attribute(self, data: bytes):
        version = data[0]
        name_size, type_size, space_size = struct.unpack_from("<HHH", data, 2)
        if version == 1:
            pos, pad = 8, _pad8
        elif version in (2, 3):
            if data[1] & 0x3:
                raise H5Error(f"{self._where()}: attribute with a shared datatype or dataspace")
            pos, pad = 8 + (version == 3), (lambda n: n)
        else:
            raise H5Error(f"{self._where()}: attribute message version {version}")
        name = data[pos:pos + name_size].rstrip(b"\0").decode()
        pos += pad(name_size)
        where = f"{self.name} attribute {name!r}"
        dtype, _ = _parse_datatype(data, pos, f"{self.file.name}:{where}")
        pos += pad(type_size)
        shape = _parse_dataspace(data, pos, f"{self.file.name}:{where}")
        pos += pad(space_size)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.size
        return name, self.file._values(data[pos:pos + n], dtype, shape, where)

    def _message(self, kind: int) -> bytes:
        found = [data for k, data in self._messages if k == kind]
        if len(found) != 1:
            raise H5Error(f"{self._where()}: {len(found)} messages of type {kind:#x}")
        return found[0]


class H5Group(_Object):
    """An old-style (symbol table) group."""

    def __init__(self, file, path, messages):
        super().__init__(file, path, messages)
        unread = {k for k, _ in messages} - {SYMBOL_TABLE, ATTRIBUTE}
        if unread:
            raise H5Error(f"{self._where()}: group messages {sorted(unread)} are not read")
        self._btree, self._heap = struct.unpack_from("<QQ", self._message(SYMBOL_TABLE))
        self._links: dict[str, int] | None = None

    def _table(self) -> dict[str, int]:
        if self._links is None:
            self._links = self.file._links(self._btree, self._heap, self.name)
        return self._links

    def keys(self) -> list[str]:
        return list(self._table())

    def __contains__(self, path: str) -> bool:
        head, _, rest = path.strip("/").partition("/")
        if head not in self._table():
            return False
        if not rest:
            return True
        child = self[head]
        return isinstance(child, H5Group) and rest in child

    def __getitem__(self, path: str):
        head, _, rest = path.strip("/").partition("/")
        if head not in self._table():
            raise KeyError(f"{self.file.name}: no object {head!r} in {self.name}")
        child = self.file._open(f"{self.name.rstrip('/')}/{head}", self._table()[head])
        return child[rest] if rest else child


class H5Dataset(_Object):
    """A contiguous or compact dataset."""

    def __init__(self, file, path, messages):
        super().__init__(file, path, messages)
        kinds = {k for k, _ in messages}
        if FILTERS in kinds:
            raise H5Error(f"{self._where()}: filtered dataset is not read")
        unread = kinds - {DATASPACE, DATATYPE, LAYOUT, ATTRIBUTE}
        if unread:
            raise H5Error(f"{self._where()}: dataset messages {sorted(unread)} are not read")
        self._type, _ = _parse_datatype(self._message(DATATYPE), 0, self._where())
        self.shape = _parse_dataspace(self._message(DATASPACE), 0, self._where())
        self.dtype = self._type.dtype if self._type.kind != "vlen_string" else np.dtype(object)

    def read(self):
        """The dataset's values, as h5py's `dataset[()]`."""
        layout = self._message(LAYOUT)
        version, cls = layout[0], layout[1]
        if version not in (3, 4):
            raise H5Error(f"{self._where()}: layout message version {version}")
        if cls == 0:
            (n,) = struct.unpack_from("<H", layout, 2)
            raw = layout[4:4 + n]
        elif cls == 1:
            address, n = struct.unpack_from("<QQ", layout, 2)
            if address != UNDEFINED:
                raw = self.file._at(address, n, self.name)
            elif 0 in self.shape:
                raw = b""
            else:  # never written: h5py would give the fill value
                raise H5Error(f"{self._where()}: no storage allocated")
        else:
            raise H5Error(f"{self._where()}: {'chunked' if cls == 2 else 'virtual'} "
                          "dataset is not read")
        return self.file._values(raw, self._type, self.shape, self.name)
