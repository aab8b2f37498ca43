"""Synthetic recordings and magnitudes for smoke runs and profiling, made
from a seed."""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
from scipy.io import wavfile


def synth_recording(path: Path | str, seed: int, minutes: float, sr: int = 48000) -> int:
    """Write a mono int16 wav of noise with whistle-like tone sweeps.

    Six 2-second linear chirps between 3 and 12 kHz per minute over white
    noise at -26 dBFS; returns the number of samples written.
    """
    rng = np.random.default_rng(seed)
    n = int(minutes * 60 * sr)
    audio = (0.05 * rng.standard_normal(n)).astype(np.float32)
    t = np.arange(sr * 2, dtype=np.float32) / sr
    for start in rng.integers(0, n - 2 * sr, size=int(minutes * 6)):
        f0, f1 = rng.uniform(3000, 12000, size=2)
        phase = 2 * np.pi * (f0 * t + 0.5 * (f1 - f0) / 2.0 * t * t)
        audio[start : start + 2 * sr] += (0.3 * np.sin(phase)).astype(np.float32)
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    wavfile.write(str(path), sr, pcm)
    return n


def synth_long_recording(
    path: Path | str, source_wav: Path | str, seed: int, repeats: int
) -> int:
    """Write a long mono int16 wav: the PCM of `source_wav` `repeats` times
    over, each repeat scaled by a gain drawn uniformly from [0.5, 1] with
    `seed`, written repeat by repeat so that only one is in memory. Returns
    the number of samples written."""
    sr, pcm = wavfile.read(str(source_wav), mmap=True)
    if pcm.dtype != np.int16 or pcm.ndim != 1:
        raise ValueError(f"{source_wav} is not a mono int16 wav")
    gains = np.random.default_rng(seed).uniform(0.5, 1.0, size=repeats)
    with wave.open(str(path), "wb") as out:
        out.setnchannels(1)
        out.setsampwidth(2)
        out.setframerate(sr)
        for gain in gains:
            out.writeframes(np.rint(pcm * np.float32(gain)).astype(np.int16).tobytes())
    return repeats * pcm.shape[0]


def synth_magnitudes(n_valid: int, n_total: int, seed: int, device):
    """(n_total,) float32 magnitudes on `device`: the first n_valid are
    |normal| * exp(3 * normal), a spread over ~80 top-level radix digits,
    with every 97th set to 0.125 (heavy ties across a digit boundary); the
    rest are zero, as the frontend leaves its padding rows."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.zeros(n_total, dtype=torch.float32, device=device)
    flat[:n_valid] = torch.randn(n_valid, generator=g, device=device).abs() * torch.exp(
        3.0 * torch.randn(n_valid, generator=g, device=device)
    )
    flat[:n_valid:97] = 0.125
    return flat
