"""Project scaffolding and the recording table (counterpart of
orcai_tpu/pipeline/helpers.py, without pandas).

`init_project` stages the packaged default JSONs as `<project>_*.json` with
a fresh 128-bit master seed; `create_recording_table` catalogs wav
recordings and their annotation files into recording_table.csv with the
columns and cell text the reference writes: a left join of annotations on
the recording stem, duplicate stems flagged, and in update mode the cells
of the previous table filled in where the new scan has none
(DataFrame.combine_first, rows in sorted order when the two tables' rows
differ).
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np
from numpy.random import SeedSequence

from orcai_tpu_torch.io.jsonio import read_json, write_json
from orcai_tpu_torch.io.tables import Table, isna, object_column
from orcai_tpu_torch.resources import DEFAULTS_DIR
from orcai_tpu_torch.utils.messenger import Messenger
from orcai_tpu_torch.utils.rle import filter_filepaths


# columns every recording table carries, in output order (per-call
# possibility columns and carried-over columns are appended)
_TABLE_COLUMNS = [
    "channel",
    "duplicate",
    "base_dir_recording",
    "rel_recording_path",
    "base_dir_annotation",
    "rel_annotation_path",
]
_PATH_COLUMNS = _TABLE_COLUMNS[2:]


def _stage_default_configs(project_dir: Path, project_name: str, msgr: Messenger) -> Path:
    """Copy each packaged default JSON as <project>_<file>.json; returns the
    path of the staged orcai parameter file."""
    param_path = None
    for source in sorted(DEFAULTS_DIR.glob("*.json")):
        target = project_dir / source.name.replace("default", project_name)
        msgr.info(f"Creating {target.name}")
        shutil.copy(source, target)
        if "orcai_parameter" in source.name:
            param_path = target
    return param_path


def _merge_overrides(base: dict, overrides: dict, msgr: Messenger) -> dict:
    """Section-wise deep merge of user overrides into the default parameter
    schema; sections unknown to the schema are dropped with a warning."""
    merged = dict(base)
    for section, value in overrides.items():
        if section not in merged:
            msgr.warning(f"{section} not found in default orcAI parameter. Ignoring.")
            continue
        if isinstance(merged[section], dict):
            merged[section] = {**merged[section], **value}
        else:
            merged[section] = value
        msgr.info(f'Updating "{section}" in default orcAI parameter with', indent=1)
        msgr.info(value, indent=-1)
    return merged


def init_project(
    project_dir: Path | str,
    project_name: str,
    verbosity: int = 2,
    msgr: Messenger | None = None,
    parameter: Path | str | dict | None = None,
) -> None:
    """Scaffold a project: staged default configs + merged parameter file.

    Every default JSON lands as `<project>_*.json`, user overrides merge
    section-wise, and the master seed is fresh 128-bit SeedSequence entropy
    unless the overrides pin one.
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Initializing project")
    msgr.part(f"Creating project directory: {project_dir}")
    project_dir = Path(project_dir)
    project_dir.mkdir(parents=True, exist_ok=True)

    param_path = _stage_default_configs(project_dir, project_name, msgr)
    orcai_parameter = read_json(param_path)

    overrides = parameter
    if isinstance(overrides, (Path, str)):
        overrides = read_json(overrides)
    if overrides:
        orcai_parameter = _merge_overrides(orcai_parameter, overrides, msgr)
    if not overrides or "seed" not in overrides:
        msgr.info("Drawing a fresh 128-bit master seed")
        orcai_parameter["seed"] = SeedSequence().entropy

    orcai_parameter["name"] = project_name
    write_json(orcai_parameter, param_path)
    msgr.success("Project ready.")


def _scan_files(root: Path, pattern: str, exclude: list[str] | None,
                msgr: Messenger) -> list[Path]:
    """Recursive scan, sorted, with substring exclusion."""
    return filter_filepaths(sorted(root.glob(pattern)), exclude or [], msgr)



def _common_kind(a: np.dtype, b: np.dtype) -> str:
    """numpy kind of pandas' find_common_type over two column types."""
    if a.kind == b.kind:
        return a.kind
    if {a.kind, b.kind} == {"i", "f"}:
        return "f"
    return "O"


def _cast(values: list, kind: str) -> np.ndarray:
    """Cells (None where missing) as a column of `kind`."""
    if kind == "i":
        return np.array(values, dtype=np.int64)
    if kind == "f":
        return np.array([np.nan if v is None else float(v) for v in values])
    if kind == "b":
        return np.array(values, dtype=bool)
    return object_column(values)


def _combine_first(table: Table, previous: Table, names: list[str]) -> Table:
    """DataFrame.combine_first on the recording stem for the columns
    `names`: a cell of `table` unless it is missing, else `previous`'s."""
    if table.index == previous.index:
        labels = list(table.index)
    else:
        labels = sorted(set(table.index) | set(previous.index))
    if len(set(labels)) != len(labels):
        raise ValueError("update_table needs unique recording names in both tables")
    pos_t = {r: i for i, r in enumerate(table.index)}
    pos_p = {r: i for i, r in enumerate(previous.index)}
    columns = {}
    for name in names:
        sources = [(t, pos) for t, pos in ((table, pos_t), (previous, pos_p))
                   if name in t.columns]
        cells = []
        for r in labels:
            value = None
            for t, pos in sources:
                if r in pos and not isna(t[name][pos[r]: pos[r] + 1])[0]:
                    value = t[name][pos[r]]
                    break
            cells.append(value)
        dtypes = [t[name].dtype for t, _ in sources]
        if len(dtypes) == 2:
            kind = _common_kind(*dtypes)
        else:
            # a column of one table only: rows the other added are missing
            kind = dtypes[0].kind
            if len(sources[0][1]) != len(labels):
                kind = {"i": "f", "b": "O"}.get(kind, kind)
        if kind in "ib" and any(v is None for v in cells):
            kind = "f" if kind == "i" else "O"
        columns[name] = _cast(cells, kind)
    return Table(labels, columns, index_name="recording")


def create_recording_table(
    base_dir_recording: Path | str,
    output_path: Path | str | None = None,
    base_dir_annotation: Path | str | None = None,
    default_channel: int = 1,
    orcai_parameter: Path | str | None = None,
    update_table: Path | str | None = None,
    update_paths: bool = True,
    exclude_patterns: Path | str | list[str] | None = None,
    remove_duplicate_filenames: bool = False,
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> Table:
    """Catalog wav recordings and their annotation files into one table.

    Writes a CSV indexed by recording stem with channel / duplicate /
    base+relative path columns, per-call possibility columns left blank for
    the user, and in update mode any extra columns of the previous table.
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Creating recording table")

    msgr.part("Resolving file paths")
    base_dir_recording = Path(base_dir_recording)
    output_path = (
        Path(output_path)
        if output_path is not None
        else base_dir_recording / "recording_table.csv"
    )
    if output_path.exists():
        msgr.error(f"Output path {output_path} already exists!")
        sys.exit(1)

    base_dir_annotation = Path(base_dir_annotation or base_dir_recording)
    exclude = exclude_patterns
    if isinstance(exclude, (Path, str)):
        exclude = read_json(exclude)
    wavs = _scan_files(base_dir_recording, "**/*.wav", exclude, msgr)
    annotations = _scan_files(base_dir_annotation, "**/*.txt", exclude, msgr)

    calls = read_json(orcai_parameter)["calls"] if orcai_parameter else []

    by_stem: dict[str, list[Path]] = {}
    for p in annotations:
        by_stem.setdefault(p.stem, []).append(p)
    orphans = set(by_stem) - {p.stem for p in wavs}
    if orphans:
        msgr.warning(
            f"{len(orphans)} annotations with missing recordings: {orphans}. "
            "These will be ignored."
        )

    # the left join on the stem: one row per (wav, matching annotation)
    rows = []
    for wav in wavs:
        for ann in by_stem.get(wav.stem, [None]):
            rows.append((wav, ann))
    index = [wav.stem for wav, _ in rows]
    counts = {s: index.count(s) for s in set(index)}
    table = Table(index, {
        "recording_type": object_column(["unknown"] * len(rows)),
        "channel": np.full(len(rows), default_channel, dtype=np.int64),
        "base_dir_recording": object_column([str(base_dir_recording)] * len(rows)),
        "rel_recording_path": object_column([str(w.relative_to(base_dir_recording)) for w, _ in rows]),
        **{call: object_column([None] * len(rows)) for call in calls},
        "base_dir_annotation": object_column(
            [None if a is None else str(base_dir_annotation) for _, a in rows]),
        "rel_annotation_path": object_column(
            [None if a is None else str(a.relative_to(base_dir_annotation)) for _, a in rows]),
        "duplicate": np.array([counts[s] > 1 for s in index], dtype=bool),
    }, index_name="recording")
    if table["duplicate"].any():
        if remove_duplicate_filenames:
            table = table.take(~table["duplicate"])
        else:
            msgr.warning("Duplicate filenames found.")
            msgr.warning("Rows sharing a file stem are marked in the 'duplicate' "
                         "column; stems must be unique for downstream steps.")

    carried_columns: list[str] = []
    if update_table is not None:
        previous = Table.read_csv(update_table, index_col="recording")
        carried_columns = sorted(set(previous.names) - set(table.names))
        if not update_paths:
            for name in _PATH_COLUMNS:
                table[name] = object_column([None] * len(table))
        table = _combine_first(table, previous, [*_TABLE_COLUMNS, *carried_columns, *calls])

    table = table.select([*_TABLE_COLUMNS, *carried_columns, *calls])

    msgr.part(f"Saving recording table to {output_path}")
    table.to_csv(output_path)
    msgr.info(f"Total recordings: {len(table)}", set_indent=1)
    msgr.info(f"Recordings with annotations: "
              f"{int((~isna(table['rel_annotation_path'])).sum())}")
    msgr.success("Recording table written.")
    return table

