"""Label arrays: annotation TSVs -> frame-aligned label zarr stores
(counterpart of orcai_tpu/pipeline/labels.py).

Per recording, each call of the parameter file becomes a column of a
float32 (T, n_calls) array on the spectrogram's time grid: 1 inside any
annotated interval (bounds inclusive), 0 elsewhere, MASK_VALUE for calls
the recording table marks as not possible. A blank possibility cell counts
as possible here, as the reference's NaN -> True cast does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from orcai_tpu_torch.io.annotations import read_annotation_file
from orcai_tpu_torch.io.jsonio import generate_times_from_spectrogram, read_json, write_json
from orcai_tpu_torch.io.tables import Table, isna
from orcai_tpu_torch.io.zarrlite import save_as_zarr
from orcai_tpu_torch.parallel.distributed import shard_table_for_process
from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER as DEFAULT_PARAMETER
from orcai_tpu_torch.utils.messenger import Messenger
from orcai_tpu_torch.utils.seeds import MASK_VALUE


def intervals_to_mask(t_vec: np.ndarray, starts, stops) -> np.ndarray:
    """Boolean mask of t in any [start, stop] interval (bounds inclusive),
    by difference counting over the sorted grid: +1 at the first index with
    t >= start, -1 after the last index with t <= stop."""
    diff = np.zeros(len(t_vec) + 1, dtype=np.int32)
    lo = np.searchsorted(t_vec, np.asarray(starts), side="left")
    hi = np.searchsorted(t_vec, np.asarray(stops), side="right")
    np.add.at(diff, lo, 1)
    np.add.at(diff, hi, -1)
    return np.cumsum(diff[:-1]) > 0


def convert_annotation(
    annotation_file_path: Path,
    recording_data_dir: Path,
    label_calls: list[str],
    labels_present: list[str],
    labels_masked: list[str],
    call_equivalences: dict | Path | str | None = None,
    msgr: Messenger | None = None,
) -> tuple[np.ndarray, dict]:
    """One annotation file -> (label array (T, n_calls) float64,
    {call: "present" | "masked"})."""
    if msgr is None:
        msgr = Messenger(verbosity=0)
    msgr.part("Rasterizing annotation intervals onto the frame grid")
    recording = annotation_file_path.stem
    annotations = read_annotation_file(annotation_file_path)
    origlabel = annotations["origlabel"]
    if call_equivalences is not None:
        msgr.info("Applying call equivalences")
        if isinstance(call_equivalences, (Path, str)):
            call_equivalences = read_json(call_equivalences)
        labels = np.array([call_equivalences.get(v) for v in origlabel], dtype=object)
        unmapped = set(origlabel) - set(call_equivalences)
        if unmapped:
            msgr.info(f"Annotation labels missing from the equivalence map: {unmapped}")
    else:
        labels = origlabel

    spectrogram_dir = recording_data_dir.joinpath(recording, "spectrogram")
    try:
        t_vec = generate_times_from_spectrogram(spectrogram_dir / "times.json")
    except FileNotFoundError:
        msgr.error(f"File not found: {spectrogram_dir / 'times.json'}")
        msgr.error("Did you create the spectrogram?")
        raise

    columns = {}
    for label in labels_present:
        rows = labels == label
        mask = intervals_to_mask(t_vec, annotations["start"][rows], annotations["stop"][rows])
        columns[label] = mask.astype(np.float64)
    for label in labels_masked:
        columns[label] = np.full(len(t_vec), MASK_VALUE)
    array = np.stack([columns[c] for c in label_calls], axis=1)
    label_dict = {call: ("present" if call in labels_present else "masked")
                  for call in label_calls}
    return array, label_dict


def create_label_arrays(
    recording_table_path: Path | str,
    output_dir: Path | str,
    base_dir_annotation: Path | str | None = None,
    orcai_parameter: dict | Path | str = DEFAULT_PARAMETER,
    call_equivalences: dict | Path | str | None = None,
    overwrite: bool = False,
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> None:
    """Label arrays for the annotated rows of a recording table.

    Writes <recording>/labels/labels.zarr + label_list.json; skips
    recordings that already have labels unless overwrite.
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Making label arrays")

    msgr.part("Loading the recording table")
    output_dir = Path(output_dir)
    table = Table.read_csv(recording_table_path)
    if base_dir_annotation is not None:
        table["base_dir_annotation"] = str(base_dir_annotation)

    not_annotated = isna(table["base_dir_annotation"])
    if not_annotated.any():
        msgr.info(f"{int(not_annotated.sum())} recordings have no annotation file; "
                  "skipping them.")
        table = table.take(~not_annotated)

    if isinstance(orcai_parameter, (Path, str)):
        orcai_parameter = read_json(orcai_parameter)
    label_calls = orcai_parameter["calls"]

    table = shard_table_for_process(table, msgr)

    if not overwrite:
        existing = np.array([output_dir.joinpath(str(r), "labels").exists()
                             for r in table["recording"]], dtype=bool)
        if existing.sum() > 0:
            msgr.info(f"Skipping {int(existing.sum())} recordings because they already "
                      "have labels.")
        table = table.take(~existing)

    recordings_no_labels = []
    msgr.part("Building label arrays")
    for rec in table.records():
        cells = {c: rec[c] for c in label_calls}
        blank = [c for c, v in cells.items() if isna(np.array([v], dtype=object))[0]]
        if blank:
            msgr.warning(
                f"Recording {rec['recording']!r} has blank call-possibility cells for "
                f"{blank}; treating blank as 'possible' (the reference's NaN->True "
                "cast). Fill every call column with 0/False or 1/True to silence this.")
        labels_present = [c for c, v in cells.items() if c in blank or bool(v)]
        if not labels_present:
            recordings_no_labels.append(rec["recording"])
            continue
        labels_masked = [c for c in label_calls if c not in labels_present]
        array, label_dict = convert_annotation(
            annotation_file_path=Path(rec["base_dir_annotation"]).joinpath(
                rec["rel_annotation_path"]),
            recording_data_dir=output_dir,
            label_calls=label_calls,
            labels_present=labels_present,
            labels_masked=labels_masked,
            call_equivalences=call_equivalences,
            msgr=Messenger(verbosity=0),
        )
        labels_dir = output_dir.joinpath(str(rec["recording"]), "labels")
        save_as_zarr(array, labels_dir / "labels.zarr", compress="auto")
        write_json(label_dict, labels_dir / "label_list.json")

    if recordings_no_labels:
        msgr.warning(f"Recordings without any valid label: {recordings_no_labels}")
    msgr.success("Label arrays written")
