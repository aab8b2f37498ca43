"""WAV decode + resample for the frontend (no librosa/soundfile).

Counterpart of orcai_tpu/io/wav.py: `load_wav`, `load_wav_for_frontend`,
`resample_audio` and `write_wav` are copied from it, int16 fast path
included. Multi-channel audio is returned as (channels, n), as librosa
returns it.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd
from pathlib import Path

import numpy as np
from scipy.io import wavfile
from scipy.signal import firwin, resample_poly


def load_wav(
    path: Path | str,
    sr: int | None = None,
    mono: bool = False,
) -> tuple[np.ndarray, int]:
    """Load a wav file as float32 in [-1, 1], optionally resampled to ``sr``.

    Returns (audio, sample_rate). Mono audio has shape (n,); multi-channel
    audio has shape (channels, n), so a caller picks channel c as
    ``audio[c - 1]``; mono=True averages the channels.
    """
    native_sr, data = wavfile.read(str(path))
    audio = _pcm_to_float(data)
    if audio.ndim == 2:  # scipy gives (n, ch)
        audio = np.ascontiguousarray(audio.T)
    if mono and audio.ndim == 2:
        audio = audio.mean(axis=0)
    if sr is not None and sr != native_sr:
        audio = resample_audio(audio, native_sr, sr)
        native_sr = sr
    return audio, native_sr


@lru_cache(maxsize=16)
def _resample_filter(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for the (up, down) polyphase pair
    (32 zero-crossings per branch, beta=12)."""
    max_rate = max(up, down)
    half_len = 32 * max_rate
    return firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 12.0))


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    """PCM/float samples -> float32 in [-1, 1]; rejects unknown formats."""
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    if data.dtype in (np.float32, np.float64):
        return data.astype(np.float32)
    raise ValueError(f"unsupported wav sample format: {data.dtype}")


def resample_audio(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase rational resampling along the time axis."""
    if orig_sr == target_sr:
        return audio
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    axis = audio.ndim - 1
    out = resample_poly(
        audio.astype(np.float64),
        up,
        down,
        axis=axis,
        window=_resample_filter(up, down),
    )
    return out.astype(np.float32)


def load_wav_for_frontend(
    path: Path | str, sr: int, channel: int = 1
) -> tuple[np.ndarray, bool]:
    """Mono audio for the device frontend -> (audio, multichannel_flag).

    A 16-bit PCM file at the target rate comes back as its raw int16
    samples (memory-mapped for mono files); the frontend scales them to
    [-1, 1] on the device, so the upload is half the bytes of float32.
    Anything else is decoded to float32 and resampled.
    """
    native_sr, data = wavfile.read(str(path), mmap=True)
    multichannel = data.ndim == 2
    if multichannel:
        if not 1 <= channel <= data.shape[1]:
            raise ValueError(
                f"channel {channel} requested but {path} has "
                f"{data.shape[1]} channels"
            )
        # copy only the wanted channel (transposing first would page in
        # the whole multichannel file)
        data = np.ascontiguousarray(data[:, channel - 1])
    if data.dtype == np.int16 and native_sr == sr:
        return data, multichannel
    audio = _pcm_to_float(data)
    if native_sr != sr:
        audio = resample_audio(audio, native_sr, sr)
    return audio, multichannel


def write_wav(path: Path | str, sr: int, audio: np.ndarray) -> None:
    """Write float32 audio ((n,) or (channels, n)) as 16-bit PCM WAV."""
    data = np.asarray(audio)
    if data.ndim == 2:
        data = data.T  # back to scipy's (n, ch)
    pcm = np.clip(data, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    wavfile.write(str(path), sr, pcm)
