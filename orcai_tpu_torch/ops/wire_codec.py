"""Wire codecs for the host-to-device audio upload: 8-bit mu-law and
block floating point (bfp6 / bfp5), with the names of the spectral wires.

Counterpart of orcai_tpu/ops/wire_codec.py. The host half (tables,
encoders, the host decoders, the byte arithmetic) is numpy, copied as it
is, with the C encoders of orcai_tpu_torch/native beside it, bit-exact by
construction. The device half (`mulaw_decode_f32`, `bfp_decode_i16`,
`bfp_decode_wire_i16`) is plain torch, as it is plain jnp there: integer
shifts and masks with no gather. Kernel B1 (csrc/) decodes mu-law codes
itself, with the same integer steps.

mu-law: sign + 3-bit exponent + 4-bit mantissa over the 14-bit domain,
bias 33, without G.711's bit inversion, so code 0x00 decodes to +0 and a
zero-filled buffer is silence; encode(x) is the code whose reconstruction
is nearest to x (ties toward the smaller magnitude). bfp: per 128-sample
block one shift byte and 128 two's-complement mantissas of 6 or 5 bits,
packed little-endian, so the all-zero byte string is silence; the decode
reconstructs int16 PCM exactly (q << shift), and every consumer runs its
ordinary int16 path on it.

Off the TPU the reference resolves its wire to `exact`; so does the port
(`resolve_wire`), and a coded wire is the caller's choice.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from orcai_tpu_torch.ops.wire_names import WIRE_CODECS

_BIAS = 33  # mu-law bias in the 14-bit magnitude domain
_CLIP14 = 0x1FFF  # max biased 14-bit magnitude


@lru_cache(maxsize=1)
def decode_table_int16() -> np.ndarray:
    """(256,) int16 reconstruction table: code byte -> PCM sample.

    decode(code) = sign * ((((2*mant + 33) << e) - 33) << 2) with
    sign = bit 7, e = bits 6:4, mant = bits 3:0.
    """
    codes = np.arange(256, dtype=np.int32)
    sign = codes >> 7
    e = (codes >> 4) & 0x7
    mant = codes & 0xF
    m14 = ((2 * mant + _BIAS) << e) - _BIAS
    x16 = m14 << 2
    out = np.where(sign == 1, -x16, x16).astype(np.int16)
    out.setflags(write=False)
    return out


def round_to_int16(x: np.ndarray) -> np.ndarray:
    """Round float audio in [-1, 1] to int16; int16 passes through.

    The ONE float->int16 conversion every host wire encoder and the 3/4
    resampler share. Identical rounding is a parity contract — the device's
    exact wire applies the same 1/32768 scaling, and any two call sites
    diverging here would make coded wires disagree on the same float input.
    """
    x = np.asarray(x)
    if x.dtype == np.int16:
        return x
    return np.clip(
        np.rint(x.astype(np.float64) * 32768.0), -32768, 32767
    ).astype(np.int16)


@lru_cache(maxsize=1)
def encode_table() -> np.ndarray:
    """(65536,) uint8 LUT: int16 sample (viewed as uint16) -> code byte.

    Built as the nearest-reconstruction inverse of decode_table_int16 (ties
    toward smaller magnitude), computed per sign from the 128 positive
    reconstruction levels. -32768 encodes as the most negative level.
    """
    dec = decode_table_int16().astype(np.int32)
    pos_levels = dec[:128]  # strictly increasing: 0 .. 32124
    # cell boundaries between consecutive levels; value v maps to level i
    # iff v <= (level[i] + level[i+1]) // 2 (ties toward smaller magnitude)
    mids = (pos_levels[:-1] + pos_levels[1:]) // 2
    mags = np.arange(32768, dtype=np.int64)
    pos_code = np.searchsorted(mids, mags, side="left").astype(np.uint8)

    lut = np.empty(65536, dtype=np.uint8)
    lut[:32768] = pos_code  # int16 0..32767 -> uint16 view 0..32767
    # int16 -1..-32768 -> uint16 view 65535..32768
    neg_mags = np.minimum(-np.arange(-32768, 0, dtype=np.int64), 32767)
    lut[32768:] = (0x80 | pos_code[neg_mags]).astype(np.uint8)
    lut.setflags(write=False)
    return lut


def mulaw_encode(x: np.ndarray, *, native: bool = True) -> np.ndarray:
    """Host-side encode: int16 PCM (any shape) -> uint8 mu-law codes.

    float input in [-1, 1] is first rounded to int16 (the device's exact
    wire applies the same 1/32768 scaling, so this adds at most half an
    int16 LSB on top of the mu-law cell width). Dispatches to the C loop in
    orcai_tpu_torch.native when available (identical by construction — it indexes
    the same LUT); `native=False` forces the numpy path (tests).
    """
    x = round_to_int16(x)
    if native:
        from orcai_tpu_torch.native import mulaw_encode_native

        out = mulaw_encode_native(x, encode_table())
        if out is not None:
            return out
    return encode_table()[x.view(np.uint16)]


def mulaw_decode_host(codes: np.ndarray) -> np.ndarray:
    """Host-side decode: uint8 codes -> int16 PCM (tests / tooling)."""
    return decode_table_int16()[np.asarray(codes, dtype=np.uint8)]


def mulaw_decode_f32(codes: torch.Tensor) -> torch.Tensor:
    """Device decode: uint8 codes -> float32 in [-1, 1], by integer shifts
    and masks (no gather); bit-equal to decode_table_int16 / 32768."""
    c = codes.to(torch.int32)
    e = (c >> 4) & 0x7
    mant = c & 0xF
    m14 = ((2 * mant + _BIAS) << e) - _BIAS
    x16 = torch.where((c >> 7) == 1, -m14, m14) << 2
    return x16.to(torch.float32) * (1.0 / 32768.0)


# --------------------------------------------------------------------------
# Block-floating-point wire (bfp6 / bfp5)
#
# The mu-law codec's 1 byte/sample is not the floor: wire_lab measured that
# 128-sample block-floating-point at 6-bit (0.758 bytes/sample, ~33 dB SNR)
# and 5-bit (0.633, 27 dB) mantissas hold the same annotation-level parity
# band as mulaw8's own perturbation (PERFORMANCE.md, wire-lab table). Layout:
# per 128-sample block, one uint8 left-shift + 128 two's-complement
# mantissas bit-packed little-endian (6-bit: 4 codes -> 3 bytes; 5-bit:
# 8 codes -> 5 bytes). Two's-complement storage makes the all-zero byte
# string decode to exact silence, so zero-initialized device buffers are
# valid padding. Decode reconstructs int16 PCM exactly (q << shift), so
# every downstream consumer — XLA DFT, Pallas kernel, streaming stats —
# runs its ordinary int16 branch and the host round-trip that wire_lab
# benchmarked is bit-identical to what the device computes.

BFP_BLOCK = 128
_BFP_GROUP = {6: (4, 3), 5: (8, 5)}  # mant_bits -> (codes, bytes) per group


def bfp_bytes_per_sample(mant_bits: int) -> float:
    """Wire bytes per PCM sample incl. the per-block shift byte."""
    g, b = _BFP_GROUP[mant_bits]
    return b / g + 1.0 / BFP_BLOCK


def bfp_block_bytes(mant_bits: int) -> int:
    """Packed mantissa bytes per 128-sample block (shift byte excluded)."""
    g, b = _BFP_GROUP[mant_bits]
    return BFP_BLOCK // g * b


def _pack_np(u: np.ndarray, mant_bits: int) -> np.ndarray:
    """(n,) codes in [0, 2^mant_bits) -> little-endian packed uint8."""
    g, nb = _BFP_GROUP[mant_bits]
    c = u.astype(np.uint16).reshape(-1, g)
    out = np.empty((c.shape[0], nb), np.uint16)
    if mant_bits == 6:
        out[:, 0] = c[:, 0] | (c[:, 1] << 6)
        out[:, 1] = (c[:, 1] >> 2) | (c[:, 2] << 4)
        out[:, 2] = (c[:, 2] >> 4) | (c[:, 3] << 2)
    else:
        out[:, 0] = c[:, 0] | (c[:, 1] << 5)
        out[:, 1] = (c[:, 1] >> 3) | (c[:, 2] << 2) | (c[:, 3] << 7)
        out[:, 2] = (c[:, 3] >> 1) | (c[:, 4] << 4)
        out[:, 3] = (c[:, 4] >> 4) | (c[:, 5] << 1) | (c[:, 6] << 6)
        out[:, 4] = (c[:, 6] >> 2) | (c[:, 7] << 3)
    return (out & 0xFF).astype(np.uint8).reshape(-1)


def _unpack_cols(b, mant_bits: int):
    """(m, nb) int byte columns -> list of g code columns (numpy arrays or
    torch tensors alike: pure shifts/masks)."""
    mask = (1 << mant_bits) - 1
    if mant_bits == 6:
        return [
            b[:, 0] & mask,
            ((b[:, 0] >> 6) | (b[:, 1] << 2)) & mask,
            ((b[:, 1] >> 4) | (b[:, 2] << 4)) & mask,
            (b[:, 2] >> 2) & mask,
        ]
    return [
        b[:, 0] & mask,
        ((b[:, 0] >> 5) | (b[:, 1] << 3)) & mask,
        (b[:, 1] >> 2) & mask,
        ((b[:, 1] >> 7) | (b[:, 2] << 1)) & mask,
        ((b[:, 2] >> 4) | (b[:, 3] << 4)) & mask,
        (b[:, 3] >> 1) & mask,
        ((b[:, 3] >> 6) | (b[:, 4] << 2)) & mask,
        (b[:, 4] >> 3) & mask,
    ]


def bfp_encode(
    x: np.ndarray, mant_bits: int = 6, *, native: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Host encode: int16 PCM (n,) -> (packed uint8, shifts uint8).

    The input is zero-padded to a multiple of BFP_BLOCK (decode returns the
    padded length; callers slice). Per block the shift is the smallest s
    with (max |x| >> s) < 2^(mant_bits-1); mantissas are round-half-up
    quantized and stored two's-complement so q == 0 packs to zero bytes.
    Float input in [-1, 1] is first rounded to int16 (as mulaw_encode).

    Dispatches to the C encoder in orcai_tpu_torch.native when available: this
    encode sits on the predict critical path (one host core; the numpy pass
    runs at the same order as the link rate) and the C loop is ~10x faster.
    Bit-exact equality between the two paths is asserted in tests;
    `native=False` forces numpy.
    """
    x = round_to_int16(x)
    if native:
        from orcai_tpu_torch.native import bfp_encode_native

        out = bfp_encode_native(
            x, mant_bits, BFP_BLOCK, bfp_block_bytes(mant_bits)
        )
        if out is not None:
            return out
    half = 1 << (mant_bits - 1)
    pad = (-x.shape[0]) % BFP_BLOCK
    xb = np.pad(x.astype(np.int32), (0, pad)).reshape(-1, BFP_BLOCK)
    peak = np.abs(xb).max(axis=1, keepdims=True)
    shift = np.zeros_like(peak)
    for _ in range(16):  # peak < 2^16 => converges in <= 16 doublings
        shift = np.where((peak >> shift) >= half, shift + 1, shift)
    q = np.clip((xb + ((1 << shift) >> 1)) >> shift, -half, half - 1)
    packed = _pack_np((q & ((1 << mant_bits) - 1)).reshape(-1), mant_bits)
    return packed, shift.reshape(-1).astype(np.uint8)


def bfp_decode_host(
    packed: np.ndarray, shifts: np.ndarray, mant_bits: int = 6
) -> np.ndarray:
    """Host decode mirror of the device path: -> int16 (n_blocks * 128,)."""
    g, nb = _BFP_GROUP[mant_bits]
    half = 1 << (mant_bits - 1)
    mask = (1 << mant_bits) - 1
    b = np.asarray(packed, np.uint8).astype(np.int32).reshape(-1, nb)
    u = np.stack(_unpack_cols(b, mant_bits), axis=-1).reshape(-1, BFP_BLOCK)
    q = ((u + half) & mask) - half
    x = q << np.asarray(shifts, np.uint8).astype(np.int32)[:, None]
    return np.clip(x, -32768, 32767).astype(np.int16).reshape(-1)


def bfp_decode_i16(packed: torch.Tensor, shifts: torch.Tensor, mant_bits: int = 6):
    """Device decode: (packed uint8, shifts uint8) -> int16 PCM, bit-exact
    with bfp_decode_host: shifts and masks and one per-block broadcast."""
    g, nb = _BFP_GROUP[mant_bits]
    half = 1 << (mant_bits - 1)
    mask = (1 << mant_bits) - 1
    b = packed.to(torch.int32).reshape(-1, nb)
    u = torch.stack(_unpack_cols(b, mant_bits), dim=-1).reshape(-1, BFP_BLOCK)
    q = ((u + half) & mask) - half
    x = q << shifts.to(torch.int32)[:, None]
    return torch.clamp(x, -32768, 32767).to(torch.int16).reshape(-1)


def bfp_encode_wire(
    x: np.ndarray, mant_bits: int = 6, *, native: bool = True
) -> np.ndarray:
    """Host encode into ONE wire buffer: [packed mantissas || shift bytes].

    Semantically identical to bfp_encode, but the two output arrays share a
    single uint8 allocation so a chunk crosses the host->device link as ONE
    upload instead of two. On remote-dispatch backends every upload is an
    RPC; the separate (~tile/128)-byte shifts arrays each paid the per-call
    floor for ~0.1% of the bytes. Layout: n_blocks * block_bytes packed
    mantissas followed by n_blocks shift bytes (n_blocks recoverable from
    the length: len = n_blocks * (block_bytes + 1)).
    """
    x = round_to_int16(x)
    bpb = bfp_block_bytes(mant_bits)
    n_blocks = -(-x.shape[0] // BFP_BLOCK)
    buf = np.empty(n_blocks * (bpb + 1), np.uint8)
    pk_view = buf[: n_blocks * bpb]
    sh_view = buf[n_blocks * bpb :]
    if native:
        from orcai_tpu_torch.native import bfp_encode_into

        if bfp_encode_into(x, mant_bits, BFP_BLOCK, pk_view, sh_view):
            return buf
    pk, sh = bfp_encode(x, mant_bits, native=False)
    pk_view[:] = pk
    sh_view[:] = sh
    return buf


def bfp_wire_split(buf, mant_bits: int):
    """(packed, shifts) views of a bfp_encode_wire buffer (numpy or torch)."""
    bpb = bfp_block_bytes(mant_bits)
    n_blocks = buf.shape[0] // (bpb + 1)
    return buf[: n_blocks * bpb], buf[n_blocks * bpb :]


def bfp_decode_wire_i16(buf, mant_bits: int = 6):
    """Device decode of a single-buffer bfp wire -> int16 PCM."""
    packed, shifts = bfp_wire_split(buf, mant_bits)
    return bfp_decode_i16(packed, shifts, mant_bits)


def wire_bfp_bits(wire: str) -> int:
    """Mantissa bits of a resolved bfp wire codec, 0 for non-bfp wires."""
    return {"bfp6": 6, "bfp5": 5}.get(wire, 0)


def spectral_wire_base(wire: str) -> str | None:
    """Base byte codec of a spectral ("sp-"/"sp11-") wire, None for plain
    wires.

    The spectral wires (ops/spectral.py) resample the audio on host —
    dropping the band the frontend crops anyway — and then ship the
    reduced-rate samples through the named base codec, stacking to L/M of
    its bytes per native-rate sample (sp-* = 3/4, sp11-* = 11/16).
    Geometries where the transform can't hold the spectrogram grid fall
    back to the base codec at the native rate (the streaming predictor
    regrids too since round 5 — ops/streaming.resolve_streaming_wire).
    """
    return {"sp-bfp6": "bfp6", "sp-bfp5": "bfp5", "sp11-bfp5": "bfp5"}.get(
        wire
    )


def spectral_wire_ratio(wire: str) -> tuple[int, int]:
    """Resample ratio (L, M) of a spectral wire: output rate = sr * L / M.

    sp-* is the conservative 3/4 (transition band ~4 kHz at the reference
    geometry, ~160 filter taps); sp11-* is the near-optimal 11/16 (output
    Nyquist 516 Hz above the retained band at the reference geometry,
    ~2400 taps — still cheap next to the link, see ops/spectral.py). Both
    land on the IDENTICAL spectrogram grid. Raises for non-spectral wires.
    """
    if wire.startswith("sp11-"):
        return 11, 16
    if wire.startswith("sp-"):
        return 3, 4
    raise ValueError(f"not a spectral wire: {wire!r}")


def bfp_streaming_aligned(n_fft: int, hop: int) -> bool:
    """Whether the streaming predictor can keep a bfp buffer in HBM.

    Device tile slices start at t0 * hop - n_fft // 2 in recording space;
    the packed block grid is anchored at the recording origin, so every
    slice must land on a BFP_BLOCK boundary: hop and the centered-STFT
    offset n_fft // 2 must both be block multiples (true for the reference
    defaults nfft=512, hop=256). Misaligned geometries downgrade the
    streaming wire to mulaw8 (per-sample codes slice anywhere).
    """
    return hop % BFP_BLOCK == 0 and (n_fft // 2) % BFP_BLOCK == 0


def wire_bytes_per_sample(wire: str) -> float:
    """Host->device bytes per NATIVE-RATE PCM sample for a resolved wire
    codec (the sp-* wires carry 3/4 as many samples, so their cost per
    original sample is 0.75x the base codec's)."""
    return {
        "exact": 2.0,
        "mulaw8": 1.0,
        "bfp6": bfp_bytes_per_sample(6),
        "bfp5": bfp_bytes_per_sample(5),
        "sp-bfp6": 0.75 * bfp_bytes_per_sample(6),
        "sp-bfp5": 0.75 * bfp_bytes_per_sample(5),
        "sp11-bfp5": 11 / 16 * bfp_bytes_per_sample(5),
    }[wire]


def resolve_wire(wire: str | None) -> str:
    """Resolve a wire-codec request to a member of WIRE_CODECS.

    None/'auto' -> the ORCAI_TPU_WIRE environment variable if set, else
    "exact". The reference gives sp-bfp5 on a TPU backend only, where the
    upload crossed a slow link, and exact on any other; the port runs on a
    CUDA or a CPU device, neither of which is a TPU, so its outputs stay
    those of the exact wire unless a caller opts in.
    """
    if wire in (None, "auto"):
        wire = os.environ.get("ORCAI_TPU_WIRE", "auto")
    if wire in (None, "auto"):
        wire = "exact"
    if wire not in WIRE_CODECS:
        raise ValueError(
            f"unknown wire codec {wire!r} ({'|'.join(WIRE_CODECS)}|auto)"
        )
    return wire
