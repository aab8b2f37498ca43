"""Spectral wire: a host L/M resample that keeps the spectrogram grid.

Counterpart of orcai_tpu/ops/spectral.py, copied with its numbers. The
reference's spectrogram chain keeps only the frequencies up to
freq_range[1] (default 16 kHz) of a 24 kHz Nyquist, so a third of the band
crosses the upload only to be cropped. Resampling 48 kHz -> 36 kHz (3/4,
the sp-* wires) or -> 33 kHz (11/16, the sp11-* wires) on the host and
running the frontend at n_fft 384 / hop 192 (352 / 176) lands on the
identical spectrogram grid:

- bin spacing: 36000/384 = 33000/352 = 48000/512 = 93.75 Hz, so the crop
  indices (and the model's input bins) are unchanged;
- frame hop: 192/36000 = 256/48000 s, so frame times are unchanged;
- frame count: with hop % M == 0, 1 + (L*n//M) // (L*hop//M) == 1 + n//hop
  for every n, so the overlap-add grid is the same;
- amplitude: the same continuous-time window sampled at L/M the rate
  scales every bin by about L/M, a constant dB shift that cancels through
  the normalize chain (dB reference, percentile clip, min-max).

What remains is the resampler's in-band ripple and the alias fold near the
new Nyquist, both held about 55 dB down by the tap design below. Kernel B1
runs the regridded geometry through its mixed-radix FFT route (384 = 8*8*2*3,
352 = 8*4*11; csrc/dft_mixed.cu, ops/dft.py::dft_route).

The hot loop runs in C (native/resample.c) with a bit-exact numpy path
here: both accumulate int32 Q15 products in ascending tap order, so they
give the same integers by construction.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from orcai_tpu_torch.ops.frontend import fft_frequencies, freq_crop_indices
from orcai_tpu_torch.ops.wire_codec import round_to_int16, spectral_wire_base

_PAD = 512  # must match RS_PAD in native/resample.c
_STOP_DB = 70.0  # stopband attenuation target for the tap design


@lru_cache(maxsize=None)
def design_taps(sr: int, pass_hz: float, L: int = 3, M: int = 4) -> np.ndarray:
    """Int16 Q15 prototype low-pass for the L/M resampler, Kaiser-windowed.

    Designed at the Lx-upsampled rate: passband edge `pass_hz` (the highest
    retained spectrogram bin), stopband edge (L/M)*sr - pass_hz (the lowest
    frequency that aliases back into the retained band), cutoff at the
    output Nyquist (L/M)*sr/2. Length is odd with group delay divisible by
    L (zero net delay through the polyphase), and the per-phase L1 norm is
    asserted against int32 accumulator overflow in the C/numpy kernels.
    """
    stop_hz = (L / M) * sr - pass_hz
    if stop_hz <= pass_hz:
        raise ValueError(
            f"no transition band: pass {pass_hz} Hz vs stop {stop_hz} Hz"
        )
    up_rate = L * sr
    delta_w = 2.0 * np.pi * (stop_hz - pass_hz) / up_rate
    n_min = int(np.ceil((_STOP_DB - 7.95) / (2.285 * delta_w))) + 1
    n_taps = n_min + (1 - n_min) % (2 * L)  # next length == 1 (mod 2L)
    atten = 2.285 * delta_w * (n_taps - 1) + 7.95  # achievable, >= target
    beta = 0.1102 * (atten - 8.7)
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    # cutoff = output Nyquist = up_rate / (2M); DC gain L compensates
    # zero-stuffing (sum of sinc(n/M) is M, times L/M)
    h = (L / M) * np.sinc(n / M) * np.kaiser(n_taps, beta)
    # Q15 quantization, rescaled (typically ~-0.12 dB) until every phase's
    # L1 norm fits the int32 accumulator even for adversarial full-scale
    # input: |acc| <= L1 * 32768 < 2^31. A constant gain on all samples is
    # a constant dB shift and cancels exactly through the normalize chain.
    scale = 32768.0
    for _ in range(8):
        taps = np.clip(np.rint(h * scale), -32768, 32767).astype(np.int16)
        max_l1 = max(
            int(np.abs(taps[p::L].astype(np.int64)).sum()) for p in range(L)
        )
        if max_l1 < 65536:
            break
        scale *= 65535.0 / max_l1
    else:  # pragma: no cover - design-time guard
        raise AssertionError(f"taps L1 {max_l1} will not fit int32 accum")
    if (n_taps + L - 1) // L + 8 > _PAD:
        raise ValueError(
            f"transition band {stop_hz - pass_hz:.0f} Hz needs {n_taps} "
            f"taps, beyond the kernel padding budget"
        )
    taps.setflags(write=False)
    return taps


def _resample_poly_numpy(
    x: np.ndarray, taps: np.ndarray, L: int, M: int, n_out: int
) -> np.ndarray:
    """Vectorized mirror of native/resample.c — bit-exact by construction.

    Same zero padding, same phase decomposition (output phase p uses
    prototype taps (p*M) mod L :: L against the contiguous input window
    starting at M*q + (p*M)//L, the standard rational-polyphase identity),
    same ascending-tap int32 accumulation (int32 wraps, and wrapping
    addition is order-independent), same (acc + 16384) >> 15 round and
    clamp.
    """
    n_taps = len(taps)
    cl = ((n_taps - 1) // 2) // L
    xz = np.zeros(len(x) + 2 * _PAD, np.int32)
    xz[_PAD : _PAD + len(x)] = x
    out = np.empty(n_out, np.int16)
    for p in range(L):
        tap_off = (p * M) % L
        x_base = (p * M) // L
        kp = (n_taps - 1 - tap_off) // L + 1
        nq = (n_out - p + L - 1) // L
        if nq <= 0:
            continue
        acc = np.zeros(nq, np.int32)
        for j in range(kp):
            h = np.int32(taps[L * (kp - 1 - j) + tap_off])
            a = x_base + cl - kp + 1 + j + _PAD
            acc += h * xz[a : a + (nq - 1) * M + 1 : M]
        v = (acc + 16384) >> 15
        out[p::L] = np.clip(v, -32768, 32767).astype(np.int16)
    return out


def resample_poly(
    x: np.ndarray, sr: int, pass_hz: float, L: int, M: int
) -> np.ndarray:
    """Resample int16 PCM by exactly L/M (len L*n//M), zero net delay.

    Float input in [-1, 1] is rounded to int16 first (the same rounding
    every coded wire applies). Dispatches to the C kernels when available
    (the tuned 3/4 kernel for (3, 4), the generic polyphase otherwise);
    the numpy path is bit-exact with both.
    """
    x = round_to_int16(x)
    n_out = L * x.shape[0] // M
    taps = design_taps(int(sr), float(pass_hz), L, M)
    from orcai_tpu_torch.native import resample34_native, resample_poly_native

    if (L, M) == (3, 4):
        out = resample34_native(x, taps, n_out)
    else:
        out = resample_poly_native(x, taps, L, M, n_out)
    if out is not None:
        return out
    return _resample_poly_numpy(x, taps, L, M, n_out)


def spectral_geometry(
    sr: int, n_fft: int, hop: int, freq_range, L: int = 3, M: int = 4
) -> tuple[int, int, int, float] | None:
    """(sr*L/M, n_fft*L/M, hop*L/M, pass_hz), or None if the L/M transform
    cannot hold the spectrogram grid exactly for these parameters.

    Requirements: sr/n_fft/hop divisible by M (integer scaled geometry on
    the same 93.75 Hz-class bin grid; hop % M == 0 also makes the frame
    count 1 + (L*n//M) // (L*hop//M) == 1 + n // hop for EVERY n, since
    (L*r)//M <= (L*(hop-1))//M < L*hop//M for r < hop), the retained band
    must survive under the new Nyquist, and the alias transition band must
    be wide enough for a filter inside the kernel's tap budget (>= 1% of
    sr; narrower bands mean freq_range nearly fills the output Nyquist and
    the transform buys nothing anyway).
    """
    if sr % M or n_fft % M or hop % M or n_fft % hop:
        return None
    freqs = fft_frequencies(sr, n_fft)
    try:
        _, hi_idx = freq_crop_indices(freqs, freq_range)
    except ValueError:
        return None
    pass_hz = float(freqs[hi_idx - 1])
    if (L / M) * sr - 2.0 * pass_hz < 0.01 * sr:
        return None
    return L * sr // M, L * n_fft // M, L * hop // M, pass_hz


def spectral_downsample(
    audio: np.ndarray,
    sr: int,
    n_fft: int,
    hop: int,
    freq_range,
    ratio: tuple[int, int] = (3, 4),
) -> tuple[np.ndarray, int, int, int] | None:
    """Apply the spectral transform: (audio_lm, sr', n_fft', hop') or None.

    None means the geometry cannot hold the grid — callers run the base
    codec at the native rate instead (the documented fallback of the
    spectral wires).
    """
    L, M = ratio
    geo = spectral_geometry(sr, n_fft, hop, freq_range, L, M)
    if geo is None:
        return None
    sr_lm, n_fft_lm, hop_lm, pass_hz = geo
    return resample_poly(audio, sr, pass_hz, L, M), sr_lm, n_fft_lm, hop_lm


class ResampledStream:
    """Lazy L/M-resampled int16 view over a (possibly memory-mapped) recording.

    Any contiguous slice is BIT-EXACT with the same slice of
    resample_poly(whole_recording): the polyphase kernel is
    shift-invariant under M-native-sample shifts (output phase depends on
    j mod L only, the window base scales with j//L), so a slice computed
    from a halo'd native window reproduces the global output as long as
    the halo covers the tap span — _HALO = the kernel's own padding
    budget, beyond any designed filter (design_taps enforces
    (n_taps + L - 1)//L + 8 <= _PAD). Slices that touch the true
    recording edges see the same zero padding the global resample does.

    This is how the streaming predictor (ops/streaming.py) runs the
    spectral wire's regridded geometry over recordings beyond RAM without
    materializing the resampled stream: each audio tile resamples its own
    native span on demand.
    """

    _HALO = _PAD  # native samples, made a multiple of M per instance

    def __init__(
        self, audio: np.ndarray, sr: int, pass_hz: float, L: int = 3,
        M: int = 4,
    ):
        self.audio = audio
        self.sr, self.pass_hz = int(sr), float(pass_hz)
        self.L, self.M = int(L), int(M)
        self.n_native = int(audio.shape[0])
        self.shape = (self.L * self.n_native // self.M,)
        self.dtype = np.dtype(np.int16)

    @property
    def nbytes(self) -> int:
        return self.shape[0] * 2

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, sl: slice) -> np.ndarray:
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            raise TypeError("ResampledStream supports contiguous slices only")
        a, b, _ = sl.indices(self.shape[0])
        L, M = self.L, self.M
        if b <= a:
            return np.zeros(0, np.int16)
        a0 = a - a % L  # snap to output phase 0 (native grid multiple)
        s0 = (a0 // L) * M
        halo = self._HALO - self._HALO % M
        p0 = max(0, s0 - halo)  # multiple of M: phase is preserved
        p1 = min(self.n_native, -(-b // L) * M + halo)
        y = resample_poly(
            np.ascontiguousarray(self.audio[p0:p1]),
            self.sr, self.pass_hz, L, M,
        )
        off = p0 * L // M  # exact: p0 % M == 0
        return y[a - off : b - off]


__all__ = [
    "design_taps",
    "resample_poly",
    "spectral_geometry",
    "spectral_downsample",
    "spectral_wire_base",
    "ResampledStream",
]
