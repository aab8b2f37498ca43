"""Synthetic recordings, projects and magnitudes for tests, smoke runs and
profiling, made from a seed.

`synth_call`, `synth_recording` and `make_synthetic_project` are copies of
orcai_tpu/tools/synthetic.py: wav recordings with Audacity-format
annotations of the seven orcai-v1 call types (BR, BUZZ, HERDING, PHS, SS,
TAILSLAP, WHISTLE), each with its own time-frequency signature, and a
filled recording table, drawn in the same order from the same seed.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
from scipy.io import wavfile


def synth_sweep_wav(path: Path | str, seed: int, minutes: float, sr: int = 48000) -> int:
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


SR = 48000
CALLS = ["BR", "BUZZ", "HERDING", "PHS", "SS", "TAILSLAP", "WHISTLE"]


def _env(n: int, attack: float = 0.1, release: float = 0.2) -> np.ndarray:
    """Smooth attack/release amplitude envelope."""
    t = np.linspace(0, 1, n)
    e = np.ones(n)
    a = max(int(attack * n), 1)
    r = max(int(release * n), 1)
    e[:a] = np.linspace(0, 1, a)
    e[-r:] = np.linspace(1, 0, r)
    return e


def synth_call(kind: str, rng: np.random.Generator) -> tuple[np.ndarray, float]:
    """One call instance -> (waveform, duration_s)."""
    if kind == "BR":  # broadband low-frequency breath burst
        dur = rng.uniform(0.6, 1.5)
        n = int(dur * SR)
        noise = rng.standard_normal(n)
        # low-pass via cumulative smoothing
        kernel = np.hanning(129)
        kernel /= kernel.sum()
        x = np.convolve(noise, kernel, mode="same")
        x *= _env(n, 0.3, 0.4)
        return 0.8 * x / (np.abs(x).max() + 1e-9), dur

    if kind == "BUZZ":  # rapid pulse train, mid-band
        dur = rng.uniform(0.4, 1.2)
        n = int(dur * SR)
        rate = rng.uniform(80, 200)  # pulses per second
        t = np.arange(n) / SR
        carrier = np.sin(2 * np.pi * rng.uniform(3000, 7000) * t)
        gate = (np.sin(2 * np.pi * rate * t) > 0.3).astype(float)
        x = carrier * gate * _env(n)
        return 0.5 * x, dur

    if kind == "HERDING":  # long low tone with slow AM
        dur = rng.uniform(2.0, 4.5)
        n = int(dur * SR)
        t = np.arange(n) / SR
        f0 = rng.uniform(400, 900)
        am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
        x = np.sin(2 * np.pi * f0 * t) * am * _env(n, 0.15, 0.15)
        return 0.45 * x, dur

    if kind == "PHS":  # harmonic stack
        dur = rng.uniform(0.6, 2.0)
        n = int(dur * SR)
        t = np.arange(n) / SR
        f0 = rng.uniform(900, 1800)
        x = np.zeros(n)
        for h, amp in [(1, 1.0), (2, 0.6), (3, 0.35), (4, 0.2)]:
            x += amp * np.sin(2 * np.pi * h * f0 * t)
        x *= _env(n)
        return 0.4 * x / (np.abs(x).max() + 1e-9), dur

    if kind == "SS":  # high-to-mid downsweep
        dur = rng.uniform(0.5, 1.4)
        n = int(dur * SR)
        t = np.arange(n) / SR
        f_start = rng.uniform(8000, 12000)
        f_stop = rng.uniform(2500, 4500)
        phase = 2 * np.pi * (f_start * t + (f_stop - f_start) * t**2 / (2 * dur))
        x = np.sin(phase) * _env(n)
        return 0.5 * x, dur

    if kind == "TAILSLAP":  # broadband slap + splash decay
        dur = rng.uniform(0.25, 0.6)
        n = int(dur * SR)
        x = rng.standard_normal(n) * np.exp(-np.linspace(0, 5, n))
        # secondary splash
        i1 = int(n * rng.uniform(0.2, 0.4))
        x[i1:] += 0.5 * rng.standard_normal(n - i1) * np.exp(
            -np.linspace(0, 6, n - i1)
        )
        return 0.9 * x / (np.abs(x).max() + 1e-9), dur

    if kind == "WHISTLE":  # FM contour
        dur = rng.uniform(0.6, 2.5)
        n = int(dur * SR)
        t = np.arange(n) / SR
        f_center = rng.uniform(5000, 10000)
        f_dev = rng.uniform(300, 1500)
        f_mod = rng.uniform(1, 4)
        phase = 2 * np.pi * (
            f_center * t - f_dev / (2 * np.pi * f_mod) * np.cos(2 * np.pi * f_mod * t)
        )
        x = np.sin(phase) * _env(n)
        return 0.45 * x, dur

    raise ValueError(f"unknown call kind {kind}")


def synth_recording(
    duration_s: float,
    rng: np.random.Generator,
    calls: list[str] = CALLS,
    calls_per_minute: float = 8.0,
    noise_level: float = 0.01,
) -> tuple[np.ndarray, list[tuple[float, float, str]]]:
    """One recording -> (float32 waveform, [(start, stop, label), ...])."""
    n = int(duration_s * SR)
    x = noise_level * rng.standard_normal(n).astype(np.float32)
    annotations: list[tuple[float, float, str]] = []
    n_calls = rng.poisson(calls_per_minute * duration_s / 60)
    for _ in range(n_calls):
        kind = calls[rng.integers(len(calls))]
        wave, dur = synth_call(kind, rng)
        if dur + 0.1 >= duration_s:
            continue  # drawn call longer than the recording: skip it
        start = rng.uniform(0, duration_s - dur - 0.1)
        i0 = int(start * SR)
        gain = rng.uniform(0.5, 1.0)
        x[i0 : i0 + len(wave)] += (gain * wave).astype(np.float32)
        annotations.append((start, start + dur, kind))
    annotations.sort()
    return x, annotations


def make_synthetic_project(
    root: Path | str,
    n_recordings: int = 20,
    duration_s: float = 600.0,
    seed: int = 0,
    calls: list[str] = CALLS,
    calls_per_minute: float = 8.0,
) -> Path:
    """Write wavs + annotation TSVs + a filled recording table under root.

    Returns the recording-table path.
    """
    from orcai_tpu_torch.io.tables import Table
    from orcai_tpu_torch.io.wav import write_wav

    root = Path(root)
    wav_dir = root / "recordings"
    wav_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    rows = []
    for i in range(n_recordings):
        name = f"synth{i:03d}"
        x, annotations = synth_recording(
            duration_s, rng, calls=calls, calls_per_minute=calls_per_minute
        )
        write_wav(wav_dir / f"{name}.wav", SR, x)
        lines = [f"{s:.4f}\t{e:.4f}\t{lab}" for s, e, lab in annotations]
        (wav_dir / f"{name}.txt").write_text("\n".join(lines) + "\n")
        rows.append(
            {
                "recording": name,
                "channel": 1,
                "duplicate": False,
                "base_dir_recording": str(wav_dir),
                "rel_recording_path": f"{name}.wav",
                "base_dir_annotation": str(wav_dir),
                "rel_annotation_path": f"{name}.txt",
                **{c: True for c in calls},
            }
        )
    table_path = root / "recording_table.csv"
    columns = {k: [r[k] for r in rows] for k in rows[0]}
    Table(None, {k: np.array(v, dtype=object if isinstance(v[0], str) else None)
                 for k, v in columns.items()}).to_csv(table_path, index=False)
    return table_path


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
