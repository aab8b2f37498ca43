"""Two-pass streaming predict for recordings beyond the device-memory budget.

Counterpart of orcai_tpu/ops/streaming.py. The in-memory
path (ops/frontend.py + ops/overlap.py) keeps a recording's whole
spectrogram on the device; this module bounds device memory to one tile,
whatever the recording's length:

pass 1 (stats): the global dB reference (max |S| over the full spectrum)
  and the two nearest-method percentiles of the cropped magnitudes, over
  fixed-size tiles of `stats_tile_frames` frames. The percentiles are exact:
  dB is monotone in |S|, and the k-th smallest cropped |S| is found by
  radix selection on the float32 bit patterns. Per level, every tile goes
  through kernel B1 (ops/dft.py::dft_magnitude) and one sweep of kernel B2
  (ops/radix_select.py::digit_histograms); the tiles' int32 counts are
  summed into an int64 accumulator on the device (a day of audio passes
  2**31 values), and the digit is picked there from the int64 counts
  (ops/radix_select.py::radix_pick), so the three levels chain on the
  stream with no fetch between them; `pick_int64` is the same pick on the
  host, the form the tests hold the device's against.

pass 2 (inference): per chunk of `windows_per_chunk` windows, the audio
  tile goes through B1 again, is normalized with the pass-1 bounds by the
  arithmetic of ops/frontend.py::finalize, runs through the model and is
  scatter-added (WindowPredictor._run_chunk) into the recording's small
  output grid on the device, fetched once at the end.

Both passes must see the same magnitudes, or pass 1's bounds would clip
values that differ at float tolerance in pass 2. B1 packs frames t and t + 1
of a tile into one complex FFT, so a frame's rounding depends on its
partner: every tile therefore has to start on an even frame. Normalize
tiles start at multiples of wpc * shift (shift is a multiple of 16);
`stats_tile_frames` must be even.

Audio residency: when the audio fits `hbm_audio_budget` bytes
(ORCAI_TPU_HBM_AUDIO_BYTES, default 8e9) it is uploaded once, in bounded
chunks, into a zero-padded device buffer that tiles are views of; else each
tile is sliced on the host from the (memory-mapped) audio with explicit
zero padding and uploaded per sweep.

Wires (`resolve_streaming_wire`): the tiles travel, and stay resident, in
the wire's byte form. mulaw8 keeps uint8 codes, which B1 decodes; bfp6/bfp5
keep a packed buffer on a block grid anchored at the recording's first
sample, and a tile that starts inside a block is decoded from the block
that holds it, with the offset dropped on the device, so every sample
decodes alike in every tile of either pass, resident or host-sliced; the
spectral wires run the two passes at the scaled geometry over a lazy,
bit-exact ResampledStream of the recording (ops/spectral.py), so a
recording beyond RAM is never resampled whole.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from orcai_tpu_torch.ops.dft import dft_magnitude
from orcai_tpu_torch.ops.frontend import (
    _AMIN,
    _db,
    fft_frequencies,
    freq_crop_indices,
    hann_window,
    nearest_quantile_index,
)
from orcai_tpu_torch.ops.radix_select import _LEVELS, digit_histograms, radix_pick
from orcai_tpu_torch.ops.spectral import ResampledStream, spectral_geometry
from orcai_tpu_torch.ops.wire_codec import (
    BFP_BLOCK,
    bfp_block_bytes,
    bfp_decode_i16,
    bfp_decode_wire_i16,
    bfp_encode,
    bfp_encode_wire,
    mulaw_encode,
    resolve_wire,
    spectral_wire_base,
    spectral_wire_ratio,
    wire_bfp_bits,
    wire_bytes_per_sample,
)

_UPLOAD_SAMPLES = 64 * 1024 * 1024  # samples per chunk of the resident upload


def pick_int64(hist: np.ndarray, k: int) -> tuple[int, int]:
    """The digit of the k-th order statistic (0-based) in int64 counts, and
    k within that digit's bin: b is the number of bins whose cumulative
    count is <= k."""
    cum = np.cumsum(np.asarray(hist, dtype=np.int64))
    b = int(np.searchsorted(cum, k + 1))
    return b, int(k - (cum[b - 1] if b else 0))


class _AudioSource:
    """Fixed-size audio tiles for frame ranges, from device or host memory.

    Frame t covers samples [t*hop - n_fft//2, t*hop + n_fft//2) of the
    recording (centered STFT, zero padding); a tile of `tpad` frames
    starting at frame t0 is the contiguous sample span of that frame range.
    `audio` is an array or a ResampledStream (anything with shape, dtype,
    nbytes and contiguous slices), and `wire` the resolved byte codec.
    """

    def __init__(self, audio, n_fft: int, hop: int, budget_bytes: int,
                 max_tile_frames: int, device: torch.device, wire: str = "exact"):
        self.audio = audio
        self.n = int(audio.shape[0])
        self.n_fft = n_fft
        self.hop = hop
        self.device = device
        self.offset = n_fft // 2  # zero pad before sample 0
        # the tail margin covers the worst tile overrun past the last frame
        self.max_tile_samples = (max_tile_frames - 1) * hop + n_fft
        self._encode = wire == "mulaw8"
        self._bfp = wire_bfp_bits(wire)
        self._dev = None
        coded = self._encode or self._bfp
        nbytes = int(self.n * wire_bytes_per_sample(wire)) if coded else audio.nbytes
        if nbytes <= budget_bytes:
            self._upload()

    def _upload(self) -> None:
        """One zero-padded device copy, uploaded in bounded chunks."""
        step = _UPLOAD_SAMPLES  # a multiple of BFP_BLOCK
        if self._bfp:
            # the packed buffer on the recording-origin block grid: block
            # `_lead` starts at recording sample 0, the lead blocks cover the
            # centered-STFT zero padding, so every sample encodes in the block
            # it has in the host-sliced tiles and in a whole-recording
            # encode, whatever the geometry. Zero bytes decode to silence;
            # one spare block keeps a tile that starts inside a block in range.
            self._lead = -(-self.offset // BFP_BLOCK)
            nblk = self._lead + -(-(self.n + self.max_tile_samples) // BFP_BLOCK) + 1
            bpb = bfp_block_bytes(self._bfp)
            buf = torch.zeros(nblk * bpb, dtype=torch.uint8, device=self.device)
            sbuf = torch.zeros(nblk, dtype=torch.uint8, device=self.device)
            for start in range(0, self.n, step):
                pk, sh = bfp_encode(np.asarray(self.audio[start : start + step]), self._bfp)
                blk = self._lead + start // BFP_BLOCK
                buf[blk * bpb : blk * bpb + pk.shape[0]].copy_(torch.from_numpy(pk))
                sbuf[blk : blk + sh.shape[0]].copy_(torch.from_numpy(sh))
            self._dev = (buf, sbuf)
            return
        if self._encode:
            dtype = torch.uint8  # code 0 decodes to +0: the padding is silence
        else:
            dtype = torch.int16 if self.audio.dtype == np.int16 else torch.float32
        buf = torch.zeros(self.offset + self.n + self.max_tile_samples, dtype=dtype,
                          device=self.device)
        for start in range(0, self.n, step):
            chunk = np.array(self.audio[start : start + step])
            if self._encode:
                chunk = mulaw_encode(chunk)
            at = self.offset + start
            buf[at : at + chunk.shape[0]].copy_(torch.from_numpy(chunk))
        self._dev = buf

    @property
    def resident(self) -> bool:
        return self._dev is not None

    def _host_span(self, s0: int, length: int) -> np.ndarray:
        """Recording samples [s0, s0 + length), zero outside the recording."""
        out = np.zeros((length,), self.audio.dtype)
        lo, hi = max(0, s0), min(self.n, s0 + length)
        if hi > lo:
            out[lo - s0 : hi - s0] = self.audio[lo:hi]
        return out

    def tile(self, t0: int, tpad: int) -> torch.Tensor:
        """Device tensor of (tpad - 1) * hop + n_fft samples for frames
        [t0, t0 + tpad): float32 or int16 samples, or uint8 codes on the
        mulaw8 wire, zero (silence) outside the recording."""
        length = (tpad - 1) * self.hop + self.n_fft
        a0 = t0 * self.hop  # start in the padded stream (offset included)
        s0 = a0 - self.offset  # start in the recording
        if self._bfp:
            # the block grid is the recording's: start at the block holding
            # s0 and drop the r samples before s0 after the decode
            r = s0 % BFP_BLOCK  # in [0, BFP_BLOCK) for s0 < 0 too
            nblk = -(-(length + BFP_BLOCK - 1) // BFP_BLOCK)
            if self._dev is not None:
                buf, sbuf = self._dev
                blk = self._lead + (s0 - r) // BFP_BLOCK
                bpb = bfp_block_bytes(self._bfp)
                dec = bfp_decode_i16(buf[blk * bpb : (blk + nblk) * bpb],
                                     sbuf[blk : blk + nblk], self._bfp)
            else:
                # the tile's blocks filled from the recording to their end,
                # not only to the tile's last sample: a block cut short would
                # take another shift than in the whole-recording encode
                span = self._host_span(s0 - r, nblk * BFP_BLOCK)
                wirebuf = torch.from_numpy(bfp_encode_wire(span, self._bfp)).to(self.device)
                dec = bfp_decode_wire_i16(wirebuf, self._bfp)
            return dec[r : r + length]
        if self._dev is not None:
            return self._dev[a0 : a0 + length]
        out = self._host_span(s0, length)
        if self._encode:
            out = mulaw_encode(out)
        return torch.from_numpy(out).to(self.device)


def resolve_streaming_wire(
    spectrogram_parameter: dict, wire: str | None = None
) -> tuple[str, str, tuple[int, int, int], tuple[int, float, int, int] | None]:
    """Effective wire and two-pass geometry of the streaming predictor:
    (label, base wire, (sr, n_fft, hop), resample).

    resample is (native_sr, pass_hz, L, M) when a spectral wire can regrid
    the geometry (ops/spectral.spectral_geometry): the tiles then come from
    a ResampledStream and ship the base wire's bytes at the scaled rate,
    and the label is the spectral wire's name. Otherwise resample is None,
    the native grid holds, and a spectral wire falls back to its base codec
    (label and base wire both the base codec's name).
    """
    sp = spectrogram_parameter
    sr, n_fft, hop = sp["sampling_rate"], sp["nfft"], sp["n_overlap"]
    wire = resolve_wire(wire)
    base = spectral_wire_base(wire)
    if base is not None:
        L, M = spectral_wire_ratio(wire)
        geo = spectral_geometry(sr, n_fft, hop, sp["freq_range"], L, M)
        if geo is not None:
            sr_lm, n_fft_lm, hop_lm, pass_hz = geo
            return wire, base, (sr_lm, n_fft_lm, hop_lm), (sr, pass_hz, L, M)
        wire = base
    return wire, wire, (sr, n_fft, hop), None


class StreamingPredictor:
    """Two-pass bounded-memory aggregate over a WindowPredictor."""

    def __init__(
        self,
        predictor,
        spectrogram_parameter: dict,
        windows_per_chunk: int = 512,
        stats_tile_frames: int = 1 << 18,
        hbm_audio_budget: int | None = None,
        wire: str | None = None,
    ):
        self.wp = predictor
        sp = spectrogram_parameter
        # a spectral wire regrids both passes when the grid holds; `wire` is
        # the byte codec the tiles ship, `wire_label` what a run reports
        self.wire_label, self.wire, (self.sr, self.n_fft, self.hop), self._resample = (
            resolve_streaming_wire(sp, wire)
        )
        self.quantiles = sp["quantiles"]
        frequencies = fft_frequencies(self.sr, self.n_fft)
        self.lo_idx, self.hi_idx = freq_crop_indices(frequencies, sp["freq_range"])
        self.window = hann_window(self.n_fft)
        self.wpc = max(
            self.wp.batch_size,
            windows_per_chunk // self.wp.batch_size * self.wp.batch_size,
        )
        self.tile_frames = (self.wpc + 1) * self.wp.shift  # a normalize tile
        if stats_tile_frames < 2 or stats_tile_frames % 2:
            raise ValueError(
                f"stats_tile_frames must be even, got {stats_tile_frames}: a tile "
                "that starts on an odd frame pairs its frames differently in the "
                "FFT kernel, and the two passes would not see the same magnitudes"
            )
        self.stats_tile_frames = stats_tile_frames
        self.hbm_audio_budget = (
            hbm_audio_budget
            if hbm_audio_budget is not None
            else int(os.environ.get("ORCAI_TPU_HBM_AUDIO_BYTES", 8_000_000_000))
        )

    def _magnitudes(self, source: _AudioSource, t0: int, tpad: int) -> torch.Tensor:
        return dft_magnitude(source.tile(t0, tpad), self.window, n_fft=self.n_fft, hop=self.hop)

    # -- pass 1 ------------------------------------------------------------

    def _select_percentiles(
        self, source: _AudioSource, n_frames: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ref_mag, lo_mag, hi_mag), 0-d float32 tensors on the source's
        device: the exact global max and the two order statistics of the
        cropped magnitudes. Nothing is fetched: each level's digits are
        picked on the device from its int64 counts."""
        dev = source.device
        tpad = self.stats_tile_frames
        n_bins = self.hi_idx - self.lo_idx
        tiles = [(t0, min(tpad, n_frames - t0)) for t0 in range(0, n_frames, tpad)]
        # the ranks stay on the host: radix_pick takes their values
        ranks = torch.tensor(
            [nearest_quantile_index(float(q), n_frames * n_bins) for q in self.quantiles],
            dtype=torch.int64,
        )
        prefixes = torch.zeros(2, dtype=torch.int32, device=dev)
        ref = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
        for level, (shift, bits, pshift) in enumerate(_LEVELS):
            acc = torch.zeros((2, 1 << bits), dtype=torch.int64, device=dev)
            for t0, n_valid in tiles:
                mag = self._magnitudes(source, t0, tpad)
                if level == 0:
                    ref = torch.maximum(ref, mag[:n_valid].max())
                # B2 reads a contiguous flat buffer; the row-major crop keeps
                # the valid rows first, so n_valid * n_bins bounds them
                flat = mag[:, self.lo_idx : self.hi_idx].contiguous().reshape(-1)
                del mag
                acc += digit_histograms(
                    flat,
                    torch.full((1,), n_valid * n_bins, dtype=torch.int32, device=dev),
                    prefixes, shift, bits, pshift,
                )
                del flat
            prefixes, ranks = radix_pick(acc, ranks, prefixes, bits, pshift is None)
        lo_mag, hi_mag = prefixes.view(torch.float32)
        return ref, lo_mag, hi_mag

    # -- pass 2 ------------------------------------------------------------

    def _infer(
        self, source: _AudioSource, n_frames: int, ref: torch.Tensor,
        lo_mag: torch.Tensor, hi_mag: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Normalize and run every window chunk with pass 1's device
        statistics; returns the device grids (agg, count) and the number of
        output rows, without fetching."""
        wp = self.wp
        # the bounds by the arithmetic of ops/frontend.py::finalize, in
        # float32 on the device, so both paths normalize alike
        ref20 = 20.0 * torch.log10(torch.clamp(ref, min=_AMIN))
        lo, hi = _db(torch.stack((lo_mag, hi_mag)), ref20)
        wpc = self.wpc
        n_win = (n_frames - wp.snippet_len) // wp.shift + 1
        n_out_total = n_frames // wp.down
        n_chunks = -(-n_win // wpc)
        # the grid covers every chunk's window span, widened by shift_out when
        # the recording's tail outruns it (as WindowPredictor.plan does)
        n_out_pad = (n_chunks * wpc - 1) * wp.shift_out + wp.out_len
        if n_out_total > n_out_pad:
            n_out_pad += wp.shift_out
        agg, count = wp._zero_grid(n_out_pad, wp.n_labels(self.hi_idx - self.lo_idx))
        for w0 in range(0, n_win, wpc):
            mag = self._magnitudes(source, w0 * wp.shift, self.tile_frames)
            crop = mag[:, self.lo_idx : self.hi_idx]
            spec = torch.clamp(
                (torch.clamp(_db(crop, ref20), lo, hi) - lo) / (hi - lo), 0.0, 1.0
            )
            del mag, crop
            wp._run_chunk(agg, count, spec, wpc, 0, w0, min(wpc, n_win - w0))
            del spec
        return agg, count, n_out_total

    def source(self, audio: np.ndarray) -> tuple[_AudioSource, int]:
        """(tile source, frame count) for mono float32 or int16 audio; the
        upload happens here when the coded audio fits the budget. A spectral
        wire wraps the audio in a ResampledStream first."""
        if not isinstance(audio, np.memmap):
            audio = np.asarray(audio)
        if audio.dtype not in (np.float32, np.int16):
            audio = audio.astype(np.float32)
        if audio.ndim != 1:
            raise ValueError("streaming predict expects mono audio (n,)")
        if self._resample is not None:
            native_sr, pass_hz, L, M = self._resample
            audio = ResampledStream(audio, native_sr, pass_hz, L, M)
        n_frames = 1 + int(audio.shape[0]) // self.hop
        if n_frames < self.wp.snippet_len:
            raise ValueError(
                f"Recording too short for prediction: {n_frames} spectrogram "
                f"frames < snippet length {self.wp.snippet_len}"
            )
        return _AudioSource(
            audio, self.n_fft, self.hop, self.hbm_audio_budget,
            max(self.stats_tile_frames, self.tile_frames), self.wp.device,
            wire=self.wire,
        ), n_frames

    @torch.inference_mode()
    def aggregate(self, audio: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(aggregated (T // down, L), overlap_count), streaming both passes."""
        source, n_frames = self.source(audio)
        stats = self._select_percentiles(source, n_frames)
        return self.wp.fetch_aggregated(*self._infer(source, n_frames, *stats))
