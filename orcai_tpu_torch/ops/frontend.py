"""Audio frontend: wav samples -> normalized spectrogram, on the device.

Counterpart of orcai_tpu/ops/frontend.py. The chain follows librosa's defaults as the reference does: center=True
zero padding, periodic Hann, |rFFT|, amplitude_to_db(ref=global max over
the full spectrum, amin 1e-5, top_db 80), frequency crop, clip to the
nearest-method percentiles of the valid frames, min-max normalize.

The recording is cut into tiles of up to 32768 frames inside a power-of-two
frame bucket. Each real tile's audio chunk is uploaded and turned into
magnitudes by kernel B1 (ops/dft.py, a batched FFT); the tile max over the
valid frames of the full 257-bin spectrum is kept as the dB reference, then
the crop is stored. The finalize takes the percentiles as order statistics of the
cropped magnitudes (dB is monotone in |S|) by radix selection, kernel B2
(ops/radix_select.py), then applies the dB, clip and normalize.

The upload takes one of the wires of ops/wire_codec.py (`prepare_wire_audio`):
exact uploads the PCM as it is (the default: "auto" resolves to exact off
the TPU); mulaw8 uploads uint8 codes, which B1 decodes as it reads them;
bfp6/bfp5 upload one [packed mantissas || shifts] buffer per tile, decoded to
int16 on the device before B1; the spectral wires resample L/M on the host
(ops/spectral.py) and run the same chain at the scaled geometry through
their base codec.
"""

from __future__ import annotations

import numpy as np
import torch

from orcai_tpu_torch.ops.dft import dft_magnitude
from orcai_tpu_torch.ops.radix_select import select_order_statistics_at
from orcai_tpu_torch.ops.wire_codec import (
    bfp_decode_wire_i16,
    bfp_encode_wire,
    mulaw_encode,
    resolve_wire,
    round_to_int16,
    spectral_wire_base,
    spectral_wire_ratio,
    wire_bfp_bits,
)
from orcai_tpu_torch.utils.device import resolve_device

_AMIN = 1e-5  # librosa amplitude_to_db amin
_TOP_DB = 80.0
_MIN_BUCKET = 2048  # minimum padded frame count
_TILE_FRAMES = 32768  # frames per upload/DFT tile
# profiler spans of a wire's host work: the resample and whole-recording
# encode, and each tile's bfp encode (read by chip_smoke.py's wires phase)
SPAN_PREPARE, SPAN_TILE_ENCODE = "wire.prepare", "wire.tile_encode"


def fft_frequencies(sr: int, n_fft: int) -> np.ndarray:
    """Center frequencies of rFFT bins: i * sr / n_fft, i = 0..n_fft//2."""
    return np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)


def frames_to_time(n_frames: int, sr: int, hop_length: int) -> np.ndarray:
    """Frame-center times for a centered STFT: i * hop / sr."""
    return np.arange(n_frames) * (hop_length / sr)


def freq_crop_indices(frequencies: np.ndarray, freq_range) -> tuple[int, int]:
    """Crop bounds [lo_idx, hi_idx) as the reference computes them:
    the first index with f <= freq_range[0], the first with f >= freq_range[1].
    """
    lo_candidates = np.flatnonzero(frequencies <= freq_range[0])
    hi_candidates = np.flatnonzero(frequencies >= freq_range[1])
    if len(lo_candidates) == 0 or len(hi_candidates) == 0:
        raise ValueError(
            f"freq_range {freq_range} outside spectrogram frequencies "
            f"[{frequencies[0]}, {frequencies[-1]}]"
        )
    return int(lo_candidates[0]), int(hi_candidates[0])


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, as used by librosa.stft."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)


def nearest_quantile_index(q: float, n: int) -> int:
    """Index of the q-quantile with numpy's method='nearest' over n values:
    q*(n-1) rounded half to even, in host float64 (n can exceed float32's
    exact integers)."""
    return int(np.round(q * (n - 1)))


def _bucket_frames(n_frames: int) -> int:
    b = _MIN_BUCKET
    while b < n_frames:
        b *= 2
    return b


def _tile_plan(n_frames: int) -> tuple[int, int, int]:
    """(tile, n_tiles, n_real_tiles) for a recording of n_frames frames."""
    bucket = _bucket_frames(n_frames)
    tile = min(_TILE_FRAMES, bucket)
    return tile, bucket // tile, -(-n_frames // tile)


def _audio_tile_chunk(audio: np.ndarray, t: int, tile: int, n_fft: int, hop: int):
    """Host chunk of (tile - 1) * hop + n_fft samples for frames
    [t*tile, (t+1)*tile), including the centered-STFT zero padding.
    Interior chunks are views of the audio; only the first and last are
    materialized with their zero padding."""
    n = audio.shape[0]
    tlen = (tile - 1) * hop + n_fft
    s0 = t * tile * hop - n_fft // 2
    s1 = s0 + tlen
    if s0 >= 0 and s1 <= n:
        return audio[s0:s1]
    chunk = np.zeros((tlen,), audio.dtype)
    lo, hi = max(0, s0), min(n, s1)
    if hi > lo:
        chunk[lo - s0 : hi - s0] = audio[lo:hi]
    return chunk


def _db(m: torch.Tensor, ref20: torch.Tensor) -> torch.Tensor:
    return torch.clamp(20.0 * torch.log10(torch.clamp(m, min=_AMIN)) - ref20, min=-_TOP_DB)


def finalize(
    mag: torch.Tensor, maxes: torch.Tensor, n_frames: int, idx_lo: int, idx_hi: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global statistics + normalization over the magnitude buffer.

    mag (bucket, bins) holds the cropped magnitudes (rows >= n_frames are
    padding), maxes the per-tile maxima of the full spectrum. Returns the
    normalized (bucket, bins) spectrogram and the dB clip bounds (lo, hi).
    """
    n_bins = mag.shape[1]
    ref20 = 20.0 * torch.log10(torch.clamp(maxes.max(), min=_AMIN))
    # the count and the ranks are host integers: the kernels take their values
    lo_mag, hi_mag = select_order_statistics_at(
        mag.reshape(-1), n_frames * n_bins, idx_lo, idx_hi)
    lo, hi = _db(lo_mag, ref20), _db(hi_mag, ref20)
    # with nearest percentiles the clipped extremes are exactly lo / hi; the
    # final clip keeps float32 rounding inside the [0, 1] contract
    out = (torch.clamp(_db(mag, ref20), lo, hi) - lo) / (hi - lo)
    return torch.clamp(out, 0.0, 1.0), lo, hi


def tile_magnitudes(
    audio: np.ndarray, n_fft: int, hop: int, lo_idx: int, hi_idx: int,
    dev: torch.device, bfp_bits: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The recording's cropped magnitudes (bucket, hi_idx - lo_idx) on `dev`
    (rows past the last frame are zero) and the per-tile maxima of the full
    spectrum over the valid frames (-inf for an all-padding tile).

    `audio` is in the byte form of prepare_wire_audio: float32 or int16
    samples, or uint8 mu-law codes, uploaded per tile as they are; with
    `bfp_bits` (int16 audio) each tile's chunk is uploaded as one
    bfp_encode_wire buffer and decoded to int16 on the device."""
    n_frames = 1 + audio.shape[0] // hop
    tile, n_tiles, n_real = _tile_plan(n_frames)
    tlen = (tile - 1) * hop + n_fft
    window = hann_window(n_fft)
    mag = torch.zeros((n_tiles * tile, hi_idx - lo_idx), dtype=torch.float32, device=dev)
    maxes = torch.full((n_tiles,), float("-inf"), dtype=torch.float32, device=dev)
    for t in range(n_real):
        chunk = _audio_tile_chunk(audio, t, tile, n_fft, hop)
        if bfp_bits:
            with torch.profiler.record_function(SPAN_TILE_ENCODE):
                encoded = bfp_encode_wire(chunk, bfp_bits)
            wirebuf = torch.from_numpy(encoded).to(dev)
            samples = bfp_decode_wire_i16(wirebuf, bfp_bits)[:tlen]
        else:
            samples = torch.from_numpy(np.array(chunk)).to(dev)
        full = dft_magnitude(samples, window, n_fft=n_fft, hop=hop)
        n_valid = min(tile, n_frames - t * tile)
        maxes[t] = full[:n_valid].max()
        mag[t * tile : (t + 1) * tile] = full[:, lo_idx:hi_idx]
    return mag, maxes


def prepare_wire_audio(
    audio: np.ndarray,
    sampling_rate: int,
    n_fft: int,
    hop_length: int,
    freq_range,
    wire: str | None,
) -> tuple[np.ndarray, int, int, int, str, int]:
    """The host side of a wire: resolve it, apply the spectral L/M resample
    where the geometry allows, and put the audio in the byte form the
    per-tile upload takes. Returns (audio, sampling_rate, n_fft, hop_length,
    effective wire, bfp_bits); the geometry is the scaled one under a
    spectral wire, and a geometry the transform cannot hold runs the base
    codec at the native rate."""
    audio = np.asarray(audio)
    if audio.dtype not in (np.float32, np.int16):
        audio = audio.astype(np.float32)
    if audio.ndim != 1:
        raise ValueError("compute_spectrogram expects mono audio (n,)")
    wire = resolve_wire(wire)
    spectral_base = spectral_wire_base(wire)
    with torch.profiler.record_function(SPAN_PREPARE):
        if spectral_base is not None:
            from orcai_tpu_torch.ops.spectral import spectral_downsample

            ds = spectral_downsample(
                audio, sampling_rate, n_fft, hop_length, freq_range,
                ratio=spectral_wire_ratio(wire),
            )
            wire = spectral_base
            if ds is not None:
                audio, sampling_rate, n_fft, hop_length = ds
        bfp_bits = wire_bfp_bits(wire)
        if wire == "mulaw8":
            # the uint8 dtype is the wire's marker downstream: raw uint8 PCM
            # never gets here (it was widened to float32 above)
            audio = mulaw_encode(audio)
        elif bfp_bits:
            # bfp encodes per tile; round float input to int16 once so each
            # tile's encode is a slice of an integer buffer
            audio = round_to_int16(audio)
    return audio, sampling_rate, n_fft, hop_length, wire, bfp_bits


def compute_spectrogram_device(
    audio: np.ndarray,
    sampling_rate: int,
    n_fft: int,
    hop_length: int,
    freq_range,
    quantiles,
    device: str | torch.device = "cuda",
    wire: str | None = None,
) -> tuple[torch.Tensor, int, np.ndarray, np.ndarray]:
    """Device-resident frontend for one recording.

    Returns (padded spectrogram (bucket, bins) on `device`, n_valid_frames,
    frequencies of the uncropped spectrum, frame times). Rows >= n_frames
    are padding; every statistic covers the valid frames only. Accepts
    float32 audio in [-1, 1] or int16 PCM (scaled on the device).

    `wire` is the upload's byte form (prepare_wire_audio, ops/wire_codec.py);
    None or "auto" resolves through ORCAI_TPU_WIRE, else to "exact". The
    frequency vector is the caller's native geometry's whatever the wire,
    and so are the crop indices; the times come from the geometry the DFT
    ran at, which a spectral wire keeps on the same grid.
    """
    dev = resolve_device(device)
    native_sr, native_n_fft = sampling_rate, n_fft
    audio, sampling_rate, n_fft, hop_length, wire, bfp_bits = prepare_wire_audio(
        audio, sampling_rate, n_fft, hop_length, freq_range, wire
    )
    if n_fft % hop_length != 0:
        raise ValueError("the frontend requires hop_length dividing n_fft")
    n_frames = 1 + audio.shape[0] // hop_length
    frequencies = fft_frequencies(native_sr, native_n_fft)
    times = frames_to_time(n_frames, sampling_rate, hop_length)
    lo_idx, hi_idx = freq_crop_indices(frequencies, freq_range)
    n_bins = hi_idx - lo_idx

    mag, maxes = tile_magnitudes(
        audio, n_fft, hop_length, lo_idx, hi_idx, dev, bfp_bits=bfp_bits
    )

    n_elem = n_frames * n_bins
    out, _, _ = finalize(
        mag,
        maxes,
        n_frames,
        nearest_quantile_index(float(quantiles[0]), n_elem),
        nearest_quantile_index(float(quantiles[1]), n_elem),
    )
    return out, n_frames, frequencies, times


def compute_spectrogram(
    audio: np.ndarray,
    sampling_rate: int,
    n_fft: int,
    hop_length: int,
    freq_range,
    quantiles,
    device: str | torch.device = "cuda",
    wire: str | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full frontend for one recording, returned to the host: (spectrogram
    (T, bins) float32 in [0, 1], uncropped frequencies, frame times)."""
    out, n_frames, frequencies, times = compute_spectrogram_device(
        audio, sampling_rate, n_fft, hop_length, freq_range, quantiles, device,
        wire=wire,
    )
    return out[:n_frames].cpu().numpy(), frequencies, times


def make_spectrogram_from_params_device(
    audio: np.ndarray,
    spectrogram_parameter: dict,
    device: str | torch.device = "cuda",
    wire: str | None = None,
):
    """compute_spectrogram_device keyed by the orcai parameter schema (its
    "n_overlap" key holds the hop length, as in the reference)."""
    return compute_spectrogram_device(
        audio,
        sampling_rate=spectrogram_parameter["sampling_rate"],
        n_fft=spectrogram_parameter["nfft"],
        hop_length=spectrogram_parameter["n_overlap"],
        freq_range=spectrogram_parameter["freq_range"],
        quantiles=spectrogram_parameter["quantiles"],
        device=device,
        wire=wire,
    )


def compute_spectrogram_host(
    audio: np.ndarray,
    sampling_rate: int,
    n_fft: int,
    hop_length: int,
    freq_range,
    quantiles,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host (numpy rFFT) frontend with the device path's semantics, a copy
    of the reference's `compute_spectrogram_host`.

    The same chain (centered STFT with a periodic Hann window, dB against
    the full-spectrum max with amin 1e-5 and top_db 80, crop, nearest
    percentile clip, min-max normalize) on one host core: strided window
    views, a per-chunk rFFT of about 16 MB, and the dB computed on the
    cropped bins only. Returns the (spectrogram (T, bins) float32 in
    [0, 1], uncropped frequencies, frame times) triple of
    compute_spectrogram.
    """
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    elif audio.dtype != np.float32:
        audio = audio.astype(np.float32)
    if audio.ndim != 1:
        raise ValueError("compute_spectrogram_host expects mono audio (n,)")
    n = audio.shape[0]
    n_frames = 1 + n // hop_length

    frequencies = fft_frequencies(sampling_rate, n_fft)
    times = frames_to_time(n_frames, sampling_rate, hop_length)
    lo_idx, hi_idx = freq_crop_indices(frequencies, freq_range)
    n_bins = hi_idx - lo_idx

    padded = np.zeros((n_frames - 1) * hop_length + n_fft, np.float32)
    padded[n_fft // 2 : n_fft // 2 + n] = audio
    win = hann_window(n_fft).astype(np.float32)

    out = np.empty((n_frames, n_bins), np.float32)
    ref = np.float32(0.0)
    chunk = max(1, (1 << 22) // (n_fft * 4))  # ~16 MB of framed f32
    for t0 in range(0, n_frames, chunk):
        t1 = min(t0 + chunk, n_frames)
        view = np.lib.stride_tricks.sliding_window_view(
            padded[t0 * hop_length : (t1 - 1) * hop_length + n_fft], n_fft
        )[::hop_length]
        S = np.abs(np.fft.rfft(view * win, axis=1))
        ref = max(ref, S.max())  # dB reference: the full uncropped spectrum
        out[t0:t1] = S[:, lo_idx:hi_idx]

    np.maximum(out, np.float32(_AMIN), out=out)
    np.log10(out, out=out)
    out *= np.float32(20.0)
    out -= np.float32(20.0) * np.log10(np.maximum(ref, np.float32(_AMIN)))
    np.maximum(out, np.float32(-_TOP_DB), out=out)

    q_lo, q_hi = quantiles
    lo, hi = np.percentile(out, [100.0 * q_lo, 100.0 * q_hi], method="nearest")
    np.clip(out, lo, hi, out=out)
    mn, mx = out.min(), out.max()
    out -= mn
    if mx > mn:
        out /= mx - mn
    return out, frequencies, times
