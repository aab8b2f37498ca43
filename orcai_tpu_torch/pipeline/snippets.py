"""Snippet sampling, TVT split tables, and dataset materialization
(counterpart of orcai_tpu/pipeline/snippets.py, without pandas).

The random draws follow the reference one for one: the same composed seeds,
the same per-segment / per-split / per-snippet uniform draws, and pandas'
sampling calls written out (`DataFrame.sample(n, random_state=rng)` is
`rng.choice(len, n, replace=False)` and a positional take;
`rng.choice(no_label.index, ...)` draws row labels, which are positions
here). So from the same master seed the CSVs are text-equal to the JAX
package's. The table operations keep pandas' semantics: `drop_duplicates`
keeps the first copy, sums skip NaN (a masked label column gives negative
sums, written as NaN), and the per-split sums of the stats tables are
Kahan-compensated as pandas' groupby sum is.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from orcai_tpu_torch.io.dataset import ArrayDataset, SnippetDataLoader
from orcai_tpu_torch.io.jsonio import read_json, write_json
from orcai_tpu_torch.io.tables import Counts, Table, isna, object_column
from orcai_tpu_torch.io.zarrlite import open_zarr
from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER as DEFAULT_PARAMETER
from orcai_tpu_torch.utils.messenger import Messenger
from orcai_tpu_torch.utils.rle import seconds_to_hms
from orcai_tpu_torch.utils.seeds import (
    SEED_ID_CREATE_DATALOADER,
    SEED_ID_FILTER_SNIPPET_TABLE,
    SEED_ID_MAKE_SNIPPET_TABLE,
    SEED_ID_UNFILTERED_TEST_DATA,
    rng_for,
)


DATA_TYPES = ["train", "val", "test"]


def resolve_recording_data_dir(recording: str, recording_data_dir) -> Path | None:
    path = Path(recording_data_dir, recording)
    return path if path.exists() else None


def _drop_duplicates(table: Table) -> Table:
    """Rows equal in every column (NaN equal to NaN) after their first copy
    are dropped."""
    seen, keep = set(), []
    cols = list(table.columns.values())
    for i in range(len(table)):
        key = tuple("nan" if isinstance(v, float) and v != v else v
                    for v in (c[i].item() if c.dtype != object else c[i] for c in cols))
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return table.take(np.asarray(keep, dtype=np.int64))


def make_snippet_table(
    recording_dir: Path,
    orcai_parameter: dict,
    rng: np.random.Generator | None = None,
    msgr: Messenger | None = None,
) -> tuple[Table | None, float, int, str, str]:
    """Sample random snippet windows for one recording.

    Each segment is carved into contiguous train/val/test sub-ranges by the
    configured fractions, and snippets_per_sec * duration * fraction
    windows are drawn uniformly per sub-range; the snippet length is forced
    divisible by 2**n_filters. Returns (table | None, duration, n_segments,
    recording, status).
    """
    if rng is None:
        rng = np.random.default_rng()
    if msgr is None:
        msgr = Messenger(verbosity=0)
    recording = recording_dir.stem
    label_zarr_path = recording_dir / "labels" / "labels.zarr"
    label_list_path = recording_dir / "labels" / "label_list.json"
    times_path = recording_dir / "spectrogram" / "times.json"

    try:
        spectrogram_times = read_json(times_path)
    except FileNotFoundError:
        msgr.error(f"File not found: {times_path}")
        msgr.error("Did you create the spectrogram?")
        raise

    model_parameter = orcai_parameter["model"]
    snippet_parameter = orcai_parameter["snippets"]

    recording_duration = spectrogram_times["max"]
    n_segments = int(recording_duration // snippet_parameter["segment_duration"])
    if n_segments <= 0:
        msgr.warning(
            f"Duration of recording ({recording_duration}) is shorter than "
            f"segment length ({snippet_parameter['segment_duration']}). "
            "Skipping recording."
        )
        return (None, recording_duration, n_segments, recording,
                "shorter than segment_duration")

    try:
        label_store = open_zarr(label_zarr_path)
    except (FileNotFoundError, ValueError):
        msgr.warning(f"Label file not found: {label_zarr_path}")
        return None, recording_duration, n_segments, recording, "missing label files"
    try:
        label_list = read_json(label_list_path)
    except FileNotFoundError:
        msgr.warning(f"Label file not found: {label_list_path}")
        return None, recording_duration, n_segments, recording, "missing label files"

    label_names = list(label_list.keys())
    times = np.linspace(spectrogram_times["min"], spectrogram_times["max"],
                        spectrogram_times["length"])
    delta_t = times[1] - times[0]
    down = 2 ** len(model_parameter["filters"])
    n_snippet_steps = int(down * ((snippet_parameter["snippet_duration"] / delta_t) // down))
    msgr.info(f"Number of spectrogram snippet timesteps: {n_snippet_steps}")

    # one bulk read instead of a zarr window per snippet
    labels = label_store[:].astype(np.float64)
    label_cumsum = np.concatenate(
        [np.zeros((1, labels.shape[1])), np.cumsum(labels, axis=0)], axis=0)

    dtypes, starts, durations = [], [], []
    for i_segment in range(n_segments):
        span = (0.0, 0.0)
        for dtype in DATA_TYPES:
            span = (span[1], span[1] + snippet_parameter[dtype])
            t_min = (i_segment + span[0]) * snippet_parameter["segment_duration"]
            t_max = (i_segment + span[1]) * snippet_parameter[
                "segment_duration"
            ] - snippet_parameter["snippet_duration"]
            n_draws = int(snippet_parameter[dtype] * snippet_parameter["segment_duration"]
                          * snippet_parameter["snippets_per_sec"])
            for _ in range(n_draws):
                t_start = rng.uniform(low=t_min, high=t_max, size=1)[0]
                i_start = np.searchsorted(times, t_start, side="left") - 1
                seg_sum = (label_cumsum[i_start + n_snippet_steps]
                           - label_cumsum[i_start]) * delta_t
                dtypes.append(dtype)
                starts.append(i_start)
                durations.append(np.where(seg_sum < 0, np.nan, seg_sum))

    n = len(starts)
    starts = np.asarray(starts, dtype=np.int64)
    durations = np.asarray(durations, dtype=np.float64).reshape(n, len(label_names))
    table = Table(None, {
        "recording": object_column([recording] * n),
        "recording_data_dir": object_column([str(recording_dir)] * n),
        "data_type": object_column(dtypes),
        "row_start": starts,
        "row_stop": starts + n_snippet_steps,
        **{name: durations[:, j] for j, name in enumerate(label_names)},
    })
    return _drop_duplicates(table), recording_duration, n_segments, recording, "success"


def _kahan_group_sums(table: Table, key: str, columns: list[str]) -> dict[str, np.ndarray]:
    """{group: sums over `columns`} with NaN skipped, as pandas' groupby sum
    computes them (Kahan-compensated, rows in order)."""
    values = np.stack([np.asarray(table[c], dtype=np.float64) for c in columns], axis=1) \
        if len(table) else np.zeros((0, len(columns)))
    sums, comps = {}, {}
    for g, row in zip(table[key], values):
        s = sums.setdefault(g, np.zeros(len(columns)))
        c = comps.setdefault(g, np.zeros(len(columns)))
        ok = ~np.isnan(row)
        y = row[ok] - c[ok]
        t = s[ok] + y
        comp = t - s[ok] - y
        c[ok] = np.where(comp != comp, 0.0, comp)
        s[ok] = t
    return sums


def compute_snippet_stats(snippet_table: Table, for_calls: list) -> Table:
    """Per-split call-duration totals (rows: calls; columns: train, val,
    test, total) and equalizing factors (the *_ef columns). A split without
    rows is NaN, as the reference's reindex leaves it."""
    sums = _kahan_group_sums(snippet_table, "data_type", for_calls)
    columns = {d: sums.get(d, np.full(len(for_calls), np.nan)) for d in DATA_TYPES}
    total = np.zeros(len(for_calls))
    for d in DATA_TYPES:
        total = total + np.nan_to_num(columns[d], nan=0.0)
    columns["total"] = total
    with np.errstate(divide="ignore", invalid="ignore"):
        ef = {f"{k}_ef": 1 / v * np.nanmax(v) if not np.isnan(v).all() else v
              for k, v in columns.items()}
    return Table(list(for_calls), {**columns, **ef})


def _stats_duration(stats: Table) -> Table:
    """The duration columns of compute_snippet_stats as hh:mm:ss text."""
    names = [k for k in stats.names if not k.endswith("_ef")]
    return Table(stats.index, {k: object_column([seconds_to_hms(v) for v in stats[k]])
                               for k in names})


def create_snippet_table(
    recording_table_path: Path | str,
    recording_data_dir: Path | str,
    output_dir: Path | str | None = None,
    orcai_parameter: dict | Path | str = DEFAULT_PARAMETER,
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> None:
    """Sample snippets for every annotated recording with data; write
    all_snippets.csv.gz and failed_snippets.csv."""
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Making snippet table")

    msgr.part("Loading the recording table")
    if isinstance(orcai_parameter, (Path, str)):
        orcai_parameter = read_json(orcai_parameter)
    if output_dir is None:
        output_dir = Path(recording_table_path).parent / "tvt_data"
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    recording_data_dir = Path(recording_data_dir)
    table = Table.read_csv(recording_table_path)
    table = table.take(~isna(table["base_dir_annotation"]))
    data_dirs = [resolve_recording_data_dir(str(r), recording_data_dir)
                 for r in table["recording"]]
    missing = np.array([d is None for d in data_dirs], dtype=bool)
    if missing.any():
        msgr.warning(
            f"Missing recording data directories for {int(missing.sum())} recordings. "
            "Skipping these recordings."
        )
        msgr.warning("Did you create the spectrograms & labels?")
    data_dirs = [d for d in data_dirs if d is not None]

    lengths, segments, tables, failed, failed_reason = [], [], [], [], []
    msgr.part("Sampling snippet tables")
    rng = rng_for(SEED_ID_MAKE_SNIPPET_TABLE, orcai_parameter["seed"])
    for data_dir in data_dirs:
        snippets, duration, n_seg, recording, status = make_snippet_table(
            recording_dir=data_dir, orcai_parameter=orcai_parameter, rng=rng,
            msgr=Messenger(verbosity=0))
        if status == "success":
            tables.append(snippets)
            lengths.append(duration)
            segments.append(n_seg)
        else:
            failed.append(recording)
            failed_reason.append(status)
    if not tables:
        raise ValueError("No objects to concatenate: no recording gave a snippet table")

    snippet_table = Table.concat(tables)
    failed_table = Table(None, {"recording": object_column(failed),
                                "reason": object_column(failed_reason)})
    msgr.info(f"Created snippet table for {len(set(snippet_table['recording']))} recordings.")
    msgr.info(f"Total recording duration: {seconds_to_hms(np.sum(lengths))}.")
    msgr.info(f"Total number of snippets: {len(snippet_table)}.")
    msgr.info(f"Total number of segments: {int(np.sum(segments))}")
    msgr.info(f"Creating snippet table failed for {len(failed)} recordings.")

    msgr.part("Writing the combined snippet table")
    failed_table.to_csv(output_dir / "failed_snippets.csv", index=False)
    snippet_table.to_csv(output_dir / "all_snippets.csv.gz", index=False)
    msgr.success(f"Snippet table saved to {output_dir / 'all_snippets.csv.gz'}")


def _label_free(table: Table, calls: list[str]) -> np.ndarray:
    """Rows whose label durations (NaN skipped) sum to at most 1e-7."""
    total = np.zeros(len(table))
    for c in calls:
        total = total + np.nan_to_num(np.asarray(table[c], dtype=np.float64), nan=0.0)
    return total <= 0.0000001


def filter_snippet_table(
    snippet_table: Table,
    orcai_parameter: dict,
    rng: np.random.Generator | None = None,
    msgr: Messenger | None = None,
) -> Table:
    """Drop fraction_removal of the snippets that contain no label."""
    if rng is None:
        rng = np.random.default_rng()
    if msgr is None:
        msgr = Messenger(verbosity=0)
    msgr.part("Thinning label-free snippets")
    calls = orcai_parameter["calls"]
    no_label = np.flatnonzero(_label_free(snippet_table, calls))
    p_before = np.around(100 * len(no_label) / len(snippet_table), 2)
    msgr.info(f"Label-free snippets before thinning: {p_before} %")
    frac = orcai_parameter["snippets"]["fraction_removal"]
    msgr.info(f"Thinning out {np.around(frac * 100, 2)}% of the label-free snippets")
    drop = rng.choice(no_label, size=int(frac * len(no_label)), replace=False)
    keep = np.ones(len(snippet_table), dtype=bool)
    keep[np.asarray(drop, dtype=np.int64)] = False
    snippet_table = snippet_table.take(keep)
    p_after = np.around(100 * _label_free(snippet_table, calls).sum() / len(snippet_table), 2)
    msgr.info(f"Label-free snippets after thinning: {p_after} %")
    msgr.info("Number of train, val, test snippets:", indent=1)
    msgr.info(Counts(snippet_table, "data_type"), indent=-1)
    return snippet_table


def _sample(table: Table, n: int, rng: np.random.Generator) -> Table:
    """DataFrame.sample(n=n, replace=False, random_state=rng)."""
    return table.take(rng.choice(len(table), size=n, replace=False))


def create_tvt_snippet_tables(
    output_dir: Path | str,
    snippet_table: Table | Path | str | None = None,
    orcai_parameter: dict | Path | str = DEFAULT_PARAMETER,
    create_unfiltered_test_snippets: bool = False,
    n_unfiltered_test_snippets: int | None = None,
    overwrite: bool = False,
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> None:
    """Sample n_batch_<split> * batch_size snippets per split and write
    {train,val,test}.csv.gz (+ test_unfiltered.csv.gz on request) and the
    duration-stat CSVs."""
    if msgr is None:
        msgr = Messenger(verbosity=verbosity,
                         title="Creating train, validation and test snippet tables")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    msgr.part("Loading the snippet table")
    if isinstance(orcai_parameter, (Path, str)):
        orcai_parameter = read_json(orcai_parameter)
    if snippet_table is None:
        snippet_table = output_dir / "all_snippets.csv.gz"
    if isinstance(snippet_table, (Path, str)):
        snippet_table = Table.read_csv(snippet_table)
    calls = orcai_parameter["calls"]

    all_stats_duration = _stats_duration(compute_snippet_stats(snippet_table, calls))
    msgr.info("Snippet stats [HMS]:", indent=1)
    msgr.info(all_stats_duration, indent=-1)
    all_stats_duration.to_csv(output_dir / "all_snippet_stats_duration.csv")

    rng = rng_for(SEED_ID_FILTER_SNIPPET_TABLE, orcai_parameter["seed"])
    filtered = filter_snippet_table(snippet_table, orcai_parameter, rng, msgr)

    model = orcai_parameter["model"]
    selected = []
    for itype in DATA_TYPES:
        n_snippets = model[f"n_batch_{itype}"] * model["batch_size"]
        msgr.info(f"Extracting {model[f'n_batch_{itype}']} batches of "
                  f"{model['batch_size']} random {itype} snippets ({n_snippets} snippets)")
        pool = filtered.take(filtered["data_type"] == itype)
        if len(pool) < n_snippets:
            raise ValueError(f"Number of {itype} snippets ({n_snippets}) larger than "
                             f"available snippets ({len(pool)}).")
        sample = _sample(pool, n_snippets, rng)
        selected.append(sample)
        out_path = output_dir / f"{itype}.csv.gz"
        if out_path.exists() and not overwrite:
            msgr.warning(f"File {out_path} already exists. Skipping. "
                         "Set overwrite=True to overwrite.")
            continue
        sample.select(["recording_data_dir", "row_start", "row_stop"]).to_csv(
            out_path, index=False)
        msgr.info(f"{itype} snippet table written")

    selected_stats_duration = _stats_duration(
        compute_snippet_stats(Table.concat(selected), calls))
    msgr.info("Snippet stats for train, val and test datasets [HMS]:", indent=1)
    msgr.info(selected_stats_duration, indent=-1)
    selected_stats_duration.to_csv(output_dir / "selected_snippet_stats_duration.csv")

    if create_unfiltered_test_snippets:
        if n_unfiltered_test_snippets is None:
            n_unfiltered_test_snippets = model["n_batch_train"] * model["batch_size"]
        msgr.info(f"Extracting {n_unfiltered_test_snippets} unfiltered test snippets")
        pool = snippet_table.take(snippet_table["data_type"] == "test")
        if len(pool) < n_unfiltered_test_snippets:
            msgr.warning(
                f"Number of unfiltered test snippets ({n_unfiltered_test_snippets}) "
                f"larger than available snippets ({len(pool)})."
            )
            msgr.warning("Using all test snippets.")
            n_unfiltered_test_snippets = len(pool)
        rng = rng_for(SEED_ID_UNFILTERED_TEST_DATA, orcai_parameter["seed"])
        sample = _sample(pool, n_unfiltered_test_snippets, rng)
        out_path = output_dir / "test_unfiltered.csv.gz"
        if out_path.exists() and not overwrite:
            msgr.warning(f"File {out_path} already exists. Skipping. "
                         "Set overwrite=True to overwrite.")
        else:
            sample.to_csv(out_path, index=False)
            msgr.info("Unfiltered test snippet table written")
    msgr.success("All snippet tables created and saved to disk")


def get_call_weights(loader: SnippetDataLoader, call_names: list[str],
                     method: str = "balanced") -> dict:
    """Per-call weights from label frequencies."""
    n_calls = len(call_names)
    if method not in ("balanced", "max", "uniform"):
        raise ValueError(f"Method {method} not supported. Use 'balanced', 'max' or 'uniform'.")
    if method == "uniform":
        return dict(zip(call_names, np.ones(n_calls)))
    counts = np.zeros(n_calls)
    for _, y in loader:
        counts += np.sum(y, axis=0, where=y > 0)
    if method == "balanced":
        weights = counts.sum() / (n_calls * counts)
    else:  # "max"
        weights = 1 / counts * counts.max()
    return dict(zip(call_names, weights))


def create_tvt_data(
    tvt_dir: Path | str,
    orcai_parameter: dict | Path | str = DEFAULT_PARAMETER,
    overwrite: bool = False,
    data_compression: str | None = None,
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> None:
    """Materialize {train,val,test[,test_unfiltered]}_dataset directories
    from the split snippet tables, plus dataset_shapes.json and, when the
    model asks for call weights, call_weights.json."""
    if msgr is None:
        msgr = Messenger(verbosity=verbosity,
                         title="Creating train, validation and test datasets")
    tvt_dir = Path(tvt_dir)
    data_types = list(DATA_TYPES)
    if (tvt_dir / "test_unfiltered.csv.gz").exists():
        data_types.append("test_unfiltered")

    msgr.part("Reading in snippet tables and generating loaders")
    if isinstance(orcai_parameter, (Path, str)):
        orcai_parameter = read_json(orcai_parameter)

    n_filters = len(orcai_parameter["model"]["filters"])
    loaders = {
        itype: SnippetDataLoader.from_csv(
            tvt_dir / f"{itype}.csv.gz", n_filters=n_filters, shuffle=True,
            rng=rng_for(SEED_ID_CREATE_DATALOADER.get(itype, 0), orcai_parameter["seed"]))
        for itype in data_types
    }
    spec_sample, label_sample = loaders[data_types[0]][0]
    msgr.info("Data shape:", indent=1)
    msgr.info(f"Input spectrogram batch shape: {spec_sample.shape}")
    msgr.info(f"Input label batch shape: {label_sample.shape}", indent=-1)

    if orcai_parameter["model"].get("call_weights") is not None:
        msgr.part("Calculating training call weights")
        call_weights = get_call_weights(loaders["train"], call_names=orcai_parameter["calls"],
                                        method=orcai_parameter["model"]["call_weights"])
        write_json(call_weights, tvt_dir / "call_weights.json")
        msgr.info("Call weights:")
        msgr.info(call_weights)

    msgr.part("Saving datasets to disk")
    for itype in data_types:
        out = tvt_dir / f"{itype}_dataset"
        try:
            ArrayDataset.save_from_loader(loaders[itype], out, compression=data_compression,
                                          overwrite=overwrite)
        except FileExistsError:
            msgr.warning(f"File {out} already exists. Skipping. "
                         "Set overwrite=True to overwrite.")
        msgr.print_directory_size(out)

    write_json({"spectrogram": list(spec_sample.shape), "labels": list(label_sample.shape)},
               tvt_dir / "dataset_shapes.json")
    msgr.success("Train, validation and test datasets created and saved to disk")
