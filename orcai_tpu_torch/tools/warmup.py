"""Run the predict path once for every recording-length shape, ahead of use.

Counterpart of orcai_tpu/tools/warmup.py. The frontend pads recordings to
power-of-two frame buckets (ops/frontend.py) and the window predictor keys
its chunk sizes and output grids off the chunk plan (WindowPredictor.plan).
`warmup` builds the CUDA kernels and then sends one silent recording per
reachable (bucket, chunk plan) signature up to a duration through the same
code path as `predict`, so that the first real recording of a process finds
the kernels built, cuDNN's algorithms chosen and the allocator's pools
filled. `bucket_sample_counts` and `bucket_warm_counts` are host arithmetic
copied from the reference.

Usage:  python -m orcai_tpu_torch warmup [--minutes 90] [--wire_codec auto]
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR
from orcai_tpu_torch.ops import _build
from orcai_tpu_torch.ops.frontend import (
    _bucket_frames,
    make_spectrogram_from_params_device,
)
from orcai_tpu_torch.ops.overlap import WindowPredictor
from orcai_tpu_torch.utils.device import exact_f32_math
from orcai_tpu_torch.utils.messenger import Messenger


def bucket_sample_counts(max_minutes: float, sr: int, hop: int) -> list[int]:
    """One representative sample count per frame bucket up to max_minutes."""
    counts: list[int] = []
    max_n = int(max_minutes * 60 * sr)
    n = sr  # start at 1 s
    seen = set()
    while n <= max_n:
        b = _bucket_frames(1 + n // hop)
        if b not in seen:
            seen.add(b)
            counts.append(min((b - 1) * hop, max_n))
        n = b * hop + hop  # first length overflowing this bucket
    b_max = _bucket_frames(1 + max_n // hop)
    if b_max not in seen:
        counts.append(max_n)
    return counts


def bucket_warm_counts(
    max_minutes: float, sr: int, hop: int, predictor: WindowPredictor
) -> list[int]:
    """Representative sample counts covering every (frame bucket, spec buffer
    length, chunk sizes, output grid) signature reachable up to max_minutes.

    The signature is piecewise constant in the valid frame count t: the
    chunk sizes and the buffer span change only when the window count
    increments (every `shift` frames), the bucket only at powers of two, and
    the grid widens at one threshold inside each window segment. Scanning
    exactly those breakpoints enumerates every reachable signature.
    """
    snippet, shift, down = predictor.snippet_len, predictor.shift, predictor.down
    t_max = 1 + int(max_minutes * 60 * sr) // hop
    if t_max < snippet:
        return []
    seen: set[tuple] = set()
    counts: list[int] = []
    n_win_max = (t_max - snippet) // shift + 1
    for n_win in range(1, n_win_max + 1):
        t_lo = snippet + (n_win - 1) * shift
        t_hi = min(snippet + n_win * shift - 1, t_max)
        cands = {t_lo}
        # the grid widens at the smallest t with t // down above the
        # unwidened n_out_pad (t_lo itself is never widened)
        base = predictor.plan(t_lo)[3]
        t_widen = (base + 1) * down
        if t_lo < t_widen <= t_hi:
            cands.add(t_widen)
        # frame-bucket boundaries inside this window segment
        t_b = _bucket_frames(t_lo) + 1
        while t_b <= t_hi:
            cands.add(t_b)
            t_b = _bucket_frames(t_b) + 1
        for t in sorted(cands):
            bucket = _bucket_frames(t)
            sig = (bucket, *predictor.plan_signature(t, bucket))
            if sig not in seen:
                seen.add(sig)
                counts.append((t - 1) * hop)
    return sorted(counts)


def warm_predictor(
    predictor: WindowPredictor, spectrogram_parameter: dict, max_minutes: float,
    wire: str | None = None, msgr: Messenger | None = None,
) -> int:
    """Send one silent int16 recording per `bucket_warm_counts` length
    through the frontend on `wire` and `predictor`; returns the number of
    lengths. On a CUDA predictor the kernels are built first. The wire
    decides what is warmed: its host encode or resample, its device decode,
    and B1's route for the geometry it runs at (a spectral wire's n_fft 384
    or 352 takes the GEMM route). Each length's wall goes to `msgr`."""
    if msgr is None:
        msgr = Messenger(verbosity=0)
    sp = spectrogram_parameter
    if predictor.device.type == "cuda":
        _build.build()
    counts = bucket_warm_counts(
        max_minutes, sp["sampling_rate"], sp["n_overlap"], predictor
    )
    msgr.part(f"Warming {len(counts)} recording-length executables")
    for i, n in enumerate(counts):
        t0 = time.perf_counter()
        with exact_f32_math():
            spec_dev, n_frames, _, _ = make_spectrogram_from_params_device(
                np.zeros(n, dtype=np.int16), sp, device=predictor.device, wire=wire
            )
            aggregated, overlap_count = predictor.aggregate(spec_dev, n_frames=n_frames)
        predictor.binary_predictions(aggregated, overlap_count, threshold=0.5)
        msgr.info(f"[{i + 1}/{len(counts)}] {n / sp['sampling_rate'] / 60:.1f} min bucket "
                  f"ready in {time.perf_counter() - t0:.1f} s")
    return len(counts)


def warmup(
    max_minutes: float = 90.0,
    model_dir: Path | str | None = None,
    predict_batch_size: int = 128,
    device: str | torch.device = "cuda",
    wire: str | None = None,
    msgr: Messenger | None = None,
) -> int:
    """Build the kernels and run every reachable predict shape up to
    max_minutes once, on the wire production predicts use (None or "auto"
    resolves as `predict` does); returns the number of warmed lengths."""
    from orcai_tpu_torch.pipeline.predict import build_predictor

    model_dir = Path(model_dir) if model_dir is not None else DEFAULT_MODEL_DIR
    predictor, orcai_parameter, _ = build_predictor(
        model_dir, predict_batch_size, device
    )
    return warm_predictor(predictor, orcai_parameter["spectrogram"], max_minutes, wire=wire,
                          msgr=msgr)
