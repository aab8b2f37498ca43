"""Annotation TSV reading, the Audacity label-track format (counterpart of
orcai_tpu/io/annotations.py)."""

from __future__ import annotations

from pathlib import Path

from orcai_tpu_torch.io.tables import Table, object_column


def read_annotation_file(annotation_file_path: Path | str) -> Table:
    """Read a start/stop/label TSV with no header; adds the recording stem
    as the first column."""
    table = Table.read_csv(annotation_file_path, sep="\t",
                           header=["start", "stop", "origlabel"])
    if len(table) == 0:
        raise ValueError(f"No columns to parse from file {annotation_file_path}")
    stem = Path(annotation_file_path).stem
    return Table(None, {"recording": object_column([stem] * len(table)), **table.columns})
