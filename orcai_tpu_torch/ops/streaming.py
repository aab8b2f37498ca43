"""Two-pass streaming predict for recordings beyond the device-memory budget.

Counterpart of orcai_tpu/ops/streaming.py on the exact wire. The in-memory
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
  2**31 values), fetched once per level, and the digit is picked on the
  host from the int64 counts (`pick_int64`).

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
zero padding and uploaded per sweep. The coded and spectral wires of the
reference are not ported.
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
from orcai_tpu_torch.ops.radix_select import _LEVELS, digit_histograms

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
    """

    def __init__(self, audio: np.ndarray, n_fft: int, hop: int,
                 budget_bytes: int, max_tile_frames: int, device: torch.device):
        self.audio = audio
        self.n = int(audio.shape[0])
        self.n_fft = n_fft
        self.hop = hop
        self.device = device
        self.offset = n_fft // 2  # zero pad before sample 0
        self._dev = None
        if audio.nbytes <= budget_bytes:
            # the tail margin covers the worst tile overrun past the last frame
            tail = (max_tile_frames - 1) * hop + n_fft
            self._dev = torch.zeros(
                self.offset + self.n + tail,
                dtype=torch.int16 if audio.dtype == np.int16 else torch.float32,
                device=device,
            )
            for start in range(0, self.n, _UPLOAD_SAMPLES):
                chunk = torch.from_numpy(np.array(audio[start : start + _UPLOAD_SAMPLES]))
                at = self.offset + start
                self._dev[at : at + chunk.shape[0]].copy_(chunk)

    @property
    def resident(self) -> bool:
        return self._dev is not None

    def tile(self, t0: int, tpad: int) -> torch.Tensor:
        """Device tensor of (tpad - 1) * hop + n_fft samples for frames
        [t0, t0 + tpad); samples outside the recording are zero."""
        length = (tpad - 1) * self.hop + self.n_fft
        a0 = t0 * self.hop  # start in the padded stream (offset included)
        if self._dev is not None:
            return self._dev[a0 : a0 + length]
        s0 = a0 - self.offset
        out = np.zeros((length,), self.audio.dtype)
        lo, hi = max(0, s0), min(self.n, s0 + length)
        if hi > lo:
            out[lo - s0 : hi - s0] = self.audio[lo:hi]
        return torch.from_numpy(out).to(self.device)


class StreamingPredictor:
    """Two-pass bounded-memory aggregate over a WindowPredictor."""

    def __init__(
        self,
        predictor,
        spectrogram_parameter: dict,
        windows_per_chunk: int = 512,
        stats_tile_frames: int = 1 << 18,
        hbm_audio_budget: int | None = None,
    ):
        self.wp = predictor
        sp = spectrogram_parameter
        self.sr, self.n_fft, self.hop = sp["sampling_rate"], sp["nfft"], sp["n_overlap"]
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
    ) -> tuple[torch.Tensor, float, float]:
        """(ref_mag as a 0-d device tensor, lo_mag, hi_mag): the exact
        global max and the two order statistics of the cropped magnitudes."""
        dev = source.device
        tpad = self.stats_tile_frames
        n_bins = self.hi_idx - self.lo_idx
        tiles = [(t0, min(tpad, n_frames - t0)) for t0 in range(0, n_frames, tpad)]
        ranks = [
            nearest_quantile_index(float(q), n_frames * n_bins) for q in self.quantiles
        ]
        prefixes = [0, 0]
        ref = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
        for level, (shift, bits, pshift) in enumerate(_LEVELS):
            acc = torch.zeros((2, 1 << bits), dtype=torch.int64, device=dev)
            prefixes_dev = torch.tensor(prefixes, dtype=torch.int32, device=dev)
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
                    prefixes_dev, shift, bits, pshift,
                )
                del flat
            hists = acc.cpu().numpy()
            for t in range(2):
                b, ranks[t] = pick_int64(hists[0 if pshift is None else t], ranks[t])
                prefixes[t] = (prefixes[t] << bits) | b
        lo_mag, hi_mag = (
            float(np.array(p, dtype=np.uint32).view(np.float32)) for p in prefixes
        )
        return ref, lo_mag, hi_mag

    # -- pass 2 ------------------------------------------------------------

    def _infer(
        self, source: _AudioSource, n_frames: int, ref: torch.Tensor,
        lo_mag: float, hi_mag: float,
    ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Normalize and run every window chunk; returns the device grids
        (agg, count) and the number of output rows, without fetching."""
        wp = self.wp
        # the bounds by the arithmetic of ops/frontend.py::finalize, in
        # float32 on the device, so both paths normalize alike
        ref20 = 20.0 * torch.log10(torch.clamp(ref, min=_AMIN))
        lo, hi = _db(
            torch.tensor([lo_mag, hi_mag], dtype=torch.float32, device=wp.device), ref20
        )
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
        upload happens here when the audio fits the budget."""
        if not isinstance(audio, np.memmap):
            audio = np.asarray(audio)
        if audio.dtype not in (np.float32, np.int16):
            audio = audio.astype(np.float32)
        if audio.ndim != 1:
            raise ValueError("streaming predict expects mono audio (n,)")
        n_frames = 1 + int(audio.shape[0]) // self.hop
        if n_frames < self.wp.snippet_len:
            raise ValueError(
                f"Recording too short for prediction: {n_frames} spectrogram "
                f"frames < snippet length {self.wp.snippet_len}"
            )
        return _AudioSource(
            audio, self.n_fft, self.hop, self.hbm_audio_budget,
            max(self.stats_tile_frames, self.tile_frames), self.wp.device,
        ), n_frames

    @torch.inference_mode()
    def aggregate(self, audio: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(aggregated (T // down, L), overlap_count), streaming both passes."""
        source, n_frames = self.source(audio)
        stats = self._select_percentiles(source, n_frames)
        return self.wp.fetch_aggregated(*self._infer(source, n_frames, *stats))
