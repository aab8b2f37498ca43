"""Run-length utilities for binary detection tracks.

Counterpart of orcai_tpu/utils/rle.py (find_consecutive_ones and
runs_from_binary_matrix, copied verbatim).
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
