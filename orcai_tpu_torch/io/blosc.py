"""Dependency-free blosc1 chunk codec (counterpart of orcai_tpu/io/blosc.py,
copied with its imports pointed at this package).

zarr-python v2's default compressor is ``Blosc(cname="lz4", clevel=5,
shuffle=1)``, so real-world orcAI stores are commonly blosc-framed. This
module implements the classic c-blosc1 frame so `zarrlite` can read and
write such stores without the blosc C library:

16-byte header::

    0: version   1: versionlz   2: flags   3: typesize
    4-7:  nbytes    (uncompressed size, uint32 LE)
    8-11: blocksize (uncompressed bytes per block, uint32 LE)
    12-15: cbytes   (total frame size, uint32 LE)

flags: 0x1 byte-shuffle, 0x2 pure-memcpy, 0x4 bit-shuffle, 0x10 blocks are
not split, bits 5-7 = inner codec (0 blosclz, 1 lz4/lz4hc, 2 snappy,
3 zlib, 4 zstd).

After the header (memcpy frames carry the raw payload directly) comes one
uint32 LE start offset per block, then the blocks. A block holds
``nsplits`` sub-streams — ``typesize`` of them when the block is split
(typesize <= 16, block divisible, not the leftover block, 0x10 unset),
else one — each a uint32 LE compressed-size prefix followed by the data
(stored raw when that size equals the sub-stream's uncompressed size).
Byte-shuffle is applied per block: the shuffled image groups byte-plane i
of every element together; a trailing ``blocksize % typesize`` remainder
stays unshuffled.

Inner codecs supported: lz4 (the C block codec of orcai_tpu_torch.native;
the decoder falls back to pure Python where the host compiler cannot build
it, the encoder does not), zlib (stdlib) and zstd (via zarrlite's gated
hook, decode only); blosclz and snappy raise with a clear message.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_FLAG_BYTE_SHUFFLE = 0x1
_FLAG_MEMCPY = 0x2
_FLAG_BIT_SHUFFLE = 0x4
_FLAG_DONT_SPLIT = 0x10
_MAX_SPLITS = 16

_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}


# ------------------------------------------------------------------ lz4


def lz4_decompress_block(
    src: bytes, dest_size: int, *, native: bool = True
) -> bytes:
    """Decode one raw LZ4 block (no frame) of known decompressed size.

    Dispatches to the C decoder in orcai_tpu_torch.native when available (the
    Python loop below is the semantics reference and fallback; byte-equal
    output asserted in tests) — bulk reads of upstream blosc-lz4 zarr
    stores run at memcpy speed instead of a few MB/s.
    """
    if native:
        from orcai_tpu_torch.native import lz4_decompress_native

        out = lz4_decompress_native(src, dest_size)
        if out is not None:
            return out
    try:
        return _lz4_decompress_py(src, dest_size)
    except IndexError:
        # reading past the stream end (truncated extension bytes etc.):
        # normalize to the same exception type the native decoder raises
        raise ValueError("corrupt lz4 block: truncated stream") from None


def _lz4_decompress_py(src: bytes, dest_size: int) -> bytes:
    dst = bytearray(dest_size)
    s, d, n = 0, 0, len(src)
    while s < n:
        token = src[s]
        s += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[s]
                s += 1
                lit += b
                if b != 255:
                    break
        if lit:
            dst[d : d + lit] = src[s : s + lit]
            s += lit
            d += lit
        if s >= n:
            break  # last sequence: literals only
        offset = src[s] | (src[s + 1] << 8)
        s += 2
        if offset == 0 or offset > d:
            raise ValueError("corrupt lz4 block: bad match offset")
        mlen = token & 15
        if mlen == 15:
            while True:
                b = src[s]
                s += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        if offset >= mlen:  # non-overlapping: one slice copy
            dst[d : d + mlen] = dst[d - offset : d - offset + mlen]
            d += mlen
        else:  # overlapping match: repeat the window
            for _ in range(mlen):
                dst[d] = dst[d - offset]
                d += 1
    if d != dest_size:
        raise ValueError(
            f"corrupt lz4 block: produced {d} bytes, expected {dest_size}"
        )
    return bytes(dst)


def lz4_compress_block(src: bytes) -> bytes:
    """LZ4 block encoder: the C encoder of orcai_tpu_torch.native.

    It carries the blosc-lz4 write path of the spectrogram and label
    stores. There is no Python encoder: where the host compiler cannot
    build the library, save_as_zarr's "auto" codec is gzip, and asking for
    blosc-lz4 raises here.
    """
    from orcai_tpu_torch.native import lz4_compress_native

    out = lz4_compress_native(src)
    if out is None:
        raise RuntimeError(
            "blosc-lz4 needs the C LZ4 encoder (orcai_tpu_torch/native), which the "
            "host C compiler did not build; write gzip stores instead"
        )
    return out


# ------------------------------------------------------------- shuffle


def _unshuffle(data: bytes, typesize: int) -> bytes:
    """Invert blosc's per-block byte shuffle."""
    nel = len(data) // typesize
    main = nel * typesize
    arr = np.frombuffer(data, np.uint8, count=main)
    out = arr.reshape(typesize, nel).T.tobytes()
    return out + data[main:]


def _shuffle(data: bytes, typesize: int) -> bytes:
    nel = len(data) // typesize
    main = nel * typesize
    arr = np.frombuffer(data, np.uint8, count=main)
    out = arr.reshape(nel, typesize).T.tobytes()
    return out + data[main:]


# -------------------------------------------------------------- decode


def _decode_sub(codec: str, payload: bytes, out_size: int) -> bytes:
    if codec == "zlib":
        return zlib.decompress(payload)
    if codec == "lz4":
        return lz4_decompress_block(payload, out_size)
    if codec == "zstd":
        from orcai_tpu_torch.io.zarrlite import _zstd_decompress

        return _zstd_decompress(payload)
    raise NotImplementedError(
        f"blosc inner codec {codec!r} is not supported by this "
        "dependency-free decoder (supported: lz4, zlib, zstd, memcpy)"
    )


def blosc_decompress(frame: bytes) -> bytes:
    """Decode one blosc1 frame to its raw payload bytes."""
    if len(frame) < 16:
        raise ValueError("blosc frame shorter than its 16-byte header")
    flags, typesize = frame[2], frame[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", frame, 4)
    if cbytes != len(frame):
        raise ValueError(
            f"blosc header cbytes {cbytes} != frame length {len(frame)}"
        )
    if flags & _FLAG_BIT_SHUFFLE:
        raise NotImplementedError("blosc bit-shuffle filter not supported")
    if flags & _FLAG_MEMCPY:
        return frame[16 : 16 + nbytes]
    codec = _CODECS.get(flags >> 5, f"unknown({flags >> 5})")
    if nbytes == 0:
        return b""
    if blocksize <= 0:
        raise ValueError("blosc header has zero blocksize")

    nblocks = -(-nbytes // blocksize)
    starts = struct.unpack_from(f"<{nblocks}I", frame, 16)
    shuffled = bool(flags & _FLAG_BYTE_SHUFFLE) and typesize > 1
    dont_split = bool(flags & _FLAG_DONT_SPLIT)

    out = bytearray()
    for b, start in enumerate(starts):
        bsize = min(blocksize, nbytes - b * blocksize)
        leftover = bsize != blocksize
        split = (
            not dont_split
            and not leftover
            and 1 < typesize <= _MAX_SPLITS
            and bsize % typesize == 0
        )
        nsplits = typesize if split else 1
        neblock = bsize // nsplits
        block = bytearray()
        pos = start
        for _ in range(nsplits):
            (sub_cbytes,) = struct.unpack_from("<I", frame, pos)
            pos += 4
            payload = frame[pos : pos + sub_cbytes]
            pos += sub_cbytes
            if sub_cbytes == neblock:  # stored raw
                block += payload
            else:
                sub = _decode_sub(codec, payload, neblock)
                if len(sub) != neblock:
                    raise ValueError(
                        f"blosc sub-stream decoded to {len(sub)} bytes, "
                        f"expected {neblock}"
                    )
                block += sub
        if shuffled:
            block = _unshuffle(bytes(block), typesize)
        out += block
    if len(out) != nbytes:
        raise ValueError(
            f"blosc frame decoded to {len(out)} bytes, expected {nbytes}"
        )
    return bytes(out)


# -------------------------------------------------------------- encode


def blosc_compress(
    data: bytes,
    typesize: int,
    cname: str = "lz4",
    shuffle: bool = True,
    blocksize: int | None = None,
) -> bytes:
    """Encode a blosc1 frame (fixture/test-grade writer, spec-conformant).

    Mirrors the decoder's layout exactly — split sub-streams, raw fallback
    when compression does not help, per-block byte shuffle — so stores it
    writes are readable by any c-blosc1 build as well as by
    :func:`blosc_decompress`.
    """
    codec_id = {v: k for k, v in _CODECS.items()}[cname]
    nbytes = len(data)
    if blocksize is None:
        blocksize = min(max(typesize, 1 << 17), max(nbytes, typesize, 1))
        if typesize > 1:
            blocksize -= blocksize % typesize
    shuffle = shuffle and typesize > 1
    flags = (codec_id << 5) | (_FLAG_BYTE_SHUFFLE if shuffle else 0)

    nblocks = -(-nbytes // blocksize) if nbytes else 0
    blocks: list[bytes] = []
    for b in range(nblocks):
        raw = data[b * blocksize : b * blocksize + blocksize]
        bsize = len(raw)
        if shuffle:
            raw = _shuffle(raw, typesize)
        leftover = bsize != blocksize
        split = (
            not leftover and 1 < typesize <= _MAX_SPLITS and bsize % typesize == 0
        )
        nsplits = typesize if split else 1
        neblock = bsize // nsplits
        enc = bytearray()
        for s in range(nsplits):
            sub = raw[s * neblock : (s + 1) * neblock]
            if cname == "zlib":
                comp = zlib.compress(sub, 5)
            elif cname == "lz4":
                comp = lz4_compress_block(sub)
            else:
                raise NotImplementedError(f"encoder for {cname!r} not written")
            if len(comp) >= neblock:  # store raw when compression loses
                comp = sub
            enc += struct.pack("<I", len(comp)) + comp
        blocks.append(bytes(enc))

    header_and_starts = 16 + 4 * nblocks
    total = header_and_starts + sum(len(b) for b in blocks)
    if total >= nbytes + 16:  # frame would exceed memcpy mode: store raw
        frame = bytearray(16)
        frame[0], frame[1] = 2, 1
        frame[2], frame[3] = _FLAG_MEMCPY | (codec_id << 5), typesize & 0xFF
        struct.pack_into("<III", frame, 4, nbytes, blocksize, 16 + nbytes)
        return bytes(frame) + data

    frame = bytearray(16)
    frame[0], frame[1] = 2, 1  # format version, codec format version
    frame[2], frame[3] = flags, typesize & 0xFF
    struct.pack_into("<III", frame, 4, nbytes, blocksize, total)
    pos = header_and_starts
    for b in blocks:
        frame += struct.pack("<I", pos)
        pos += len(b)
    for b in blocks:
        frame += b
    return bytes(frame)
