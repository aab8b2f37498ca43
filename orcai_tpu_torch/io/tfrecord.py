"""Reader of `tf.data.Dataset.save` snapshots, without TensorFlow or protobuf.

The JAX package reads these through TensorFlow (orcai_tpu/io/tfdata_convert.py);
this package reads the files themselves. A snapshot directory holds

    dataset_spec.pb
    snapshot.metadata              SnapshotMetadataRecord (version 2)
    <run_id>/<8-digit shard>.shard/<8-digit>.snapshot

Each `.snapshot` file is a TFRecord file, either raw or one gzip stream
(`compression="GZIP"`). A record is framed as

    u64 length | u32 masked crc32c(length) | data | u32 masked crc32c(data)

and holds one `TensorProto` per component, so an element of a (spectrogram,
labels) dataset is two records in a row. `Dataset.load` reads the shards
through `interleave(cycle_length=multiprocessing.cpu_count())` with blocks
of one element (tensorflow/python/data/ops/load_op.py), and
`TFSnapshot.__iter__` yields the elements in that order.

Every crc is checked (with the host C library of `native/`; without it the
reader raises), and anything the reader does not parse raises and names
the file and the record: it never returns values that might be wrong.
"""

from __future__ import annotations

import gzip
import multiprocessing
import struct
import zlib
from pathlib import Path

import numpy as np

from orcai_tpu_torch.native import crc32c_native

SNAPSHOT_VERSION = 2
DT_FLOAT = 1  # tensorflow/core/framework/types.proto
_MASK_DELTA = 0xA282EAD8


class DataLossError(ValueError):
    """A record whose framing, crc or compression does not check out: the
    error a wrong compression flag gives, as TensorFlow's DataLossError."""


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC-32C of `data` (tsl/lib/hash/crc32c.h::Mask)."""
    crc = crc32c_native(data)
    if crc is None:
        raise RuntimeError(
            "the host C library (orcai_tpu_torch/native) could not be built or "
            "loaded: tf.data snapshot records cannot be checked without its crc32c"
        )
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) & 0xFFFFFFFF


# -- protobuf wire format -------------------------------------------------------

def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ValueError("truncated or overlong varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a message: an int
    for varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            if pos + 8 > len(buf):
                raise ValueError(f"truncated fixed64 field {number}")
            value, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            if pos + n > len(buf):
                raise ValueError(f"truncated length-delimited field {number}")
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            if pos + 4 > len(buf):
                raise ValueError(f"truncated fixed32 field {number}")
            value, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        else:
            raise ValueError(f"field {number} has wire type {wire}, which is not read")
        yield number, wire, value


def _packed_varints(wire: int, value) -> list[int]:
    if wire == 0:
        return [value]
    out, pos = [], 0
    while pos < len(value):
        v, pos = _varint(value, pos)
        out.append(v)
    return out


def read_metadata(path: Path | str) -> dict:
    """`snapshot.metadata` (SnapshotMetadataRecord) as a dict: run_id,
    version, dtypes, num_elements, finalized."""
    path = Path(path)
    # proto3 leaves out a field at its default: an empty snapshot has no
    # num_elements (0)
    meta = {"run_id": None, "version": None, "dtypes": [], "num_elements": 0,
            "finalized": False}
    try:
        for number, wire, value in _fields(path.read_bytes()):
            if number == 2 and wire == 2:
                meta["run_id"] = value.decode()
            elif number == 4 and wire == 0:
                meta["version"] = value
            elif number == 5 and wire in (0, 2):
                meta["dtypes"] += _packed_varints(wire, value)
            elif number == 6 and wire == 0:
                meta["num_elements"] = value
            elif number == 1000 and wire == 0:
                meta["finalized"] = bool(value)
    except (ValueError, UnicodeDecodeError) as err:
        raise ValueError(f"{path}: not a SnapshotMetadataRecord ({err})") from None
    if meta["version"] != SNAPSHOT_VERSION:
        raise ValueError(f"{path}: snapshot version {meta['version']}, only "
                         f"{SNAPSHOT_VERSION} is read")
    if not meta["finalized"]:
        raise ValueError(f"{path}: the snapshot was not finalized (an interrupted save)")
    if not meta["run_id"]:
        raise ValueError(f"{path}: no run id")
    return meta


def parse_tensor(data: bytes) -> np.ndarray:
    """A float32 `TensorProto` (dtype, tensor_shape, tensor_content) as a
    numpy array; any other dtype or field raises."""
    dtype, dims, content = None, None, None
    for number, wire, value in _fields(data):
        if number == 1 and wire == 0:
            dtype = value
        elif number == 2 and wire == 2:
            dims = []
            for n2, w2, v2 in _fields(value):
                if n2 == 2 and w2 == 2:
                    size = 0
                    for n3, w3, v3 in _fields(v2):
                        if n3 == 1 and w3 == 0:
                            size = v3
                    if size >= 1 << 62:  # a negative int64: unknown size
                        raise ValueError("tensor of unknown dimension")
                    dims.append(size)
                elif n2 == 3 and w2 == 0 and v2:
                    raise ValueError("tensor of unknown rank")
        elif number == 3 and wire == 0:
            pass  # version_number
        elif number == 4 and wire == 2:
            content = value
        else:
            raise ValueError(f"TensorProto field {number} is not read")
    if dtype != DT_FLOAT:
        raise ValueError(f"tensor dtype {dtype}, only DT_FLOAT ({DT_FLOAT}) is read")
    if dims is None:
        raise ValueError("tensor without a shape")
    count = int(np.prod(dims, dtype=np.int64))
    if content is None and count:
        raise ValueError("tensor without tensor_content")
    content = content or b""
    if len(content) != 4 * count:
        raise ValueError(f"tensor_content holds {len(content)} bytes for shape {dims}")
    return np.frombuffer(content, "<f4").reshape(dims).astype(np.float32)


# -- TFRecord files -------------------------------------------------------------

def read_records(path: Path | str, compression: str | None):
    """The data of each record of a TFRecord file, both crcs checked.
    `compression` is "GZIP" or None."""
    path = Path(path)
    if compression not in ("GZIP", None):
        raise ValueError(f"compression {compression!r}: GZIP or None")
    opener = gzip.open if compression == "GZIP" else open
    index = 0
    with opener(path, "rb") as f:
        while True:
            where = f"{path} record {index}"
            try:
                header = f.read(12)
                if not header:
                    return
                if len(header) < 12:
                    raise DataLossError(f"{where}: truncated record header")
                (length,) = struct.unpack("<Q", header[:8])
                if struct.unpack("<I", header[8:])[0] != masked_crc32c(header[:8]):
                    raise DataLossError(f"{where}: corrupted record length (crc mismatch)")
                body = f.read(length + 4)
            except (OSError, EOFError, zlib.error) as err:
                # gzip.BadGzipFile is an OSError
                raise DataLossError(f"{where}: {compression or 'raw'} read failed: "
                                    f"{type(err).__name__}: {err}") from None
            if len(body) < length + 4:
                raise DataLossError(f"{where}: truncated record data")
            data = body[:length]
            if struct.unpack("<I", body[length:])[0] != masked_crc32c(data):
                raise DataLossError(f"{where}: corrupted record data (crc mismatch)")
            yield data
            index += 1


class TFSnapshot:
    """The elements of a `tf.data.Dataset.save` directory, in
    `Dataset.load`'s order: tuples of float32 arrays, one per component."""

    def __init__(self, path: Path | str, compression: str | None):
        self.path = Path(path)
        self.compression = compression
        meta = read_metadata(self.path / "snapshot.metadata")
        self.num_elements = meta["num_elements"]
        self.n_components = len(meta["dtypes"])
        if any(d != DT_FLOAT for d in meta["dtypes"]) or not self.n_components:
            raise ValueError(f"{self.path}: component dtypes {meta['dtypes']}, only "
                             f"DT_FLOAT ({DT_FLOAT}) is read")
        run_dir = self.path / meta["run_id"]
        if self.num_elements and not run_dir.is_dir():
            raise ValueError(f"{self.path}: no run directory {meta['run_id']}")
        # a shard is the files of its directory, read one after the other
        self.shards = []
        for shard_dir in sorted(run_dir.glob("*.shard")):
            files = sorted(shard_dir.glob("*.snapshot"))
            if [f.name for f in files] != [f"{i:08d}.snapshot" for i in range(len(files))]:
                raise ValueError(f"{shard_dir}: snapshot files {[f.name for f in files]} "
                                 "are not numbered from 00000000")
            self.shards.append(files)

    def __len__(self) -> int:
        return self.num_elements

    def _shard_elements(self, files: list[Path]):
        n = self.n_components
        for path in files:
            element = []
            for index, data in enumerate(read_records(path, self.compression)):
                try:
                    element.append(parse_tensor(data))
                except ValueError as err:
                    raise ValueError(f"{path} record {index}: {err}") from None
                if len(element) == n:
                    yield tuple(element)
                    element = []
            if element:
                raise DataLossError(f"{path}: the last element has {len(element)} of "
                                    f"its {n} components")

    def __iter__(self):
        """Round-robin over the shards as `Dataset.load` reads them: up to
        multiprocessing.cpu_count() shards open into a cycle of slots in
        order, the cycle takes one element a slot in turn, and a slot whose
        shard is spent takes the next shard when the cycle comes back to it."""
        cycle = [None] * multiprocessing.cpu_count()
        pending = iter(self.shards)
        index = count = 0
        try:
            while True:
                if cycle[index] is None:
                    files = next(pending, None)
                    if files is not None:
                        cycle[index] = self._shard_elements(files)
                        continue
                    if all(c is None for c in cycle):
                        break
                else:
                    element = next(cycle[index], None)
                    if element is not None:
                        count += 1
                        yield element
                    else:
                        cycle[index] = None
                index = (index + 1) % len(cycle)
        finally:
            for shard in cycle:
                if shard is not None:
                    shard.close()
        if count != self.num_elements:
            raise ValueError(f"{self.path}: read {count} elements, the metadata says "
                             f"{self.num_elements}")
