"""Run-length utilities for binary detection tracks.

Counterpart of orcai_tpu/utils/rle.py (copied).
"""

from __future__ import annotations

import numpy as np


def find_consecutive_ones(binary_vector: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Start/stop indices (inclusive) of each run of ones in a 0/1 vector."""
    v = np.asarray(binary_vector)
    edges = np.diff(v, prepend=0, append=0)
    starts = np.flatnonzero(edges == 1)
    stops = np.flatnonzero(edges == -1) - 1
    return starts, stops


def runs_from_binary_matrix(
    binary: np.ndarray, names: list[str]
) -> tuple[list[int], list[int], list[str]]:
    """Per-column run extraction over a (time, labels) 0/1 matrix.

    Returns flat (starts, stops, label_names) lists, column order preserved,
    matching the reference's per-call loop (predict.py:311-317).
    """
    row_starts: list[int] = []
    row_stops: list[int] = []
    label_names: list[str] = []
    for i, name in enumerate(names):
        col = binary[:, i]
        if col.sum() > 0:
            starts, stops = find_consecutive_ones(col)
            row_starts += list(starts)
            row_stops += list(stops)
            label_names += [name] * len(starts)
    return row_starts, row_stops, label_names


def filter_filepaths(filepaths, exclude_patterns, msgr=None):
    """Drop paths containing any exclude pattern (reference auxiliary.py:368)."""
    for pattern in exclude_patterns:
        filepaths = [f for f in filepaths if pattern not in str(f)]
        if msgr is not None:
            msgr.info(
                f"Remaining files after filtering files that contain "
                f"{pattern}: {len(filepaths)}"
            )
    return filepaths


def seconds_to_hms(seconds: float) -> str:
    """Format a duration in seconds as hh:mm:ss."""
    hours, rem = divmod(seconds, 3600)
    minutes, secs = divmod(rem, 60)
    return f"{int(hours):02}:{int(minutes):02}:{int(secs):02}"
