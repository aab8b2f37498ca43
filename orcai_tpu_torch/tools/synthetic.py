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


def synth_tvt(
    data_dir: Path | str,
    spectrogram: np.ndarray,
    seed: int,
    n_train: int = 512,
    n_val: int = 128,
    n_test: int = 70,
    snippet_len: int = 736,
    n_labels: int = 7,
    down: int = 16,
) -> dict:
    """Write a materialized train/val/test directory cut from one (T, bins)
    spectrogram in [0, 1]: {split}_dataset folders in the ArrayDataset
    format and dataset_shapes.json.

    Snippets start at frames drawn from `seed`. Label l of an output step is
    1 where the step's mean energy in the l-th of n_labels equal frequency
    bands lies more than one standard deviation over that band's mean over
    the whole spectrogram (a tone sweep crossing the band), so the labels
    can be learnt from the snippet. A fifth of the snippets have their last
    label masked throughout and a tenth of all steps the one before it.
    Returns the number of snippets per split and the share of ones.
    """
    from orcai_tpu_torch.io.dataset import ArrayDataset
    from orcai_tpu_torch.io.jsonio import write_json
    from orcai_tpu_torch.utils.seeds import MASK_VALUE

    data_dir = Path(data_dir)
    spec = np.asarray(spectrogram, np.float32)
    n_steps, band = snippet_len // down, spec.shape[1] // n_labels
    usable = spec.shape[0] // down * down
    energy = spec[:usable, : band * n_labels].reshape(usable // down, down, n_labels, band)
    energy = energy.mean(axis=(1, 3))  # (steps of the recording, labels)
    active = (energy > energy.mean(axis=0) + energy.std(axis=0)).astype(np.float32)
    rng = np.random.default_rng(seed)
    counts = {}
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        starts = rng.integers(0, usable // down - n_steps, size=n) * down
        labels = np.stack([active[s // down : s // down + n_steps] for s in starts])
        labels[rng.uniform(size=n) < 0.2, :, -1] = MASK_VALUE
        labels[..., -2][rng.uniform(size=(n, n_steps)) < 0.1] = MASK_VALUE

        class Snippets:
            def __len__(self):
                return n

            def __iter__(self):
                for s, y in zip(starts, labels):
                    yield spec[s : s + snippet_len, :, None], y

        ArrayDataset.save_from_loader(Snippets(), data_dir / f"{split}_dataset", overwrite=True)
        counts[split] = int(n)
    write_json({"spectrogram": [snippet_len, spec.shape[1], 1], "labels": [n_steps, n_labels]},
               data_dir / "dataset_shapes.json")
    counts["share_of_ones"] = float(active.mean())
    return counts
