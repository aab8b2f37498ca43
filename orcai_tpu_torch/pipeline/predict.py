"""Prediction pipeline: wav recording(s) -> Audacity-format label files.

Counterpart of orcai_tpu/pipeline/predict.py: one .wav or every row of a
recording table (.csv). The spectrogram frontend, windowed inference and
overlap-add run on the device (ops/frontend.py, ops/overlap.py, and
ops/streaming.py for recordings beyond the spectrogram budget); run
lengths, duration filtering and the table output run on the host, without
pandas. Output contract: `<stem>_c<channel>_<model>_predicted.txt`, a TSV
of start/stop seconds rounded to 4 places and the label with its suffix,
an optional `*_probabilities.csv.gz`, both byte-equal in text to what the
reference writes. `wire` picks the upload's byte form (ops/wire_codec.py,
ops/spectral.py); None or "auto" resolves through ORCAI_TPU_WIRE, else to
exact. The windows of every batch are split over the process's local
devices (parallel/mesh.py), and in a group of several processes each
predicts its round-robin share of a table's recordings.

Three byte budgets, each an environment variable: a recording whose
spectrogram would pass ORCAI_TPU_STREAM_SPEC_BYTES (default 4e9) takes the
two-pass streaming path; that path keeps the audio on the device when it
fits ORCAI_TPU_HBM_AUDIO_BYTES (default 8e9); a table dispatches
recordings in waves of at most ORCAI_TPU_WAVE_HBM_BYTES (default 6e9) of
device-resident spectrograms before it fetches and saves them.
"""

from __future__ import annotations

import csv
import gzip
import os
from pathlib import Path

import numpy as np
import torch

from orcai_tpu_torch.io.jsonio import read_json
from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR, load_orcai_model
from orcai_tpu_torch.io.wav import load_wav_for_frontend
from orcai_tpu_torch.ops.frontend import (
    _bucket_frames,
    make_spectrogram_from_params_device,
)
from orcai_tpu_torch.ops.overlap import WindowPredictor
from orcai_tpu_torch.ops.streaming import StreamingPredictor
from orcai_tpu_torch.parallel.distributed import shard_table_for_process
from orcai_tpu_torch.parallel.mesh import local_devices
from orcai_tpu_torch.resources import DEFAULT_CALL_DURATION_LIMITS
from orcai_tpu_torch.utils.device import exact_f32_math
from orcai_tpu_torch.utils.messenger import Messenger
from orcai_tpu_torch.utils.rle import runs_from_binary_matrix


# ---------------------------------------------------------------- filtering


def _duration_bounds(label: str, limits: dict) -> tuple[float, float]:
    if label in limits:
        lo, hi = limits[label]
    elif "default" in limits:
        lo, hi = limits["default"]
    else:
        lo, hi = None, None
    return (0.0 if lo is None else lo), (np.inf if hi is None else hi)


def filter_predictions(
    predicted_labels: list[tuple],
    delta_t: float,
    call_duration_limits: dict | Path | str = DEFAULT_CALL_DURATION_LIMITS,
    label_suffix: str = "*",
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> list[tuple]:
    """Drop (start, stop, label) rows outside their per-call duration limits.

    Limits are keyed by the label with the prediction suffix stripped,
    falling back to a "default" entry; durations are compared in seconds,
    (stop - start) * delta_t. The kept rows keep their order.
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Filtering predictions")
    msgr.part("Filtering predictions")
    if isinstance(call_duration_limits, (Path, str)):
        call_duration_limits = read_json(call_duration_limits)
    msgr.part("Filtering calls based on duration")
    kept, n_short, n_long = [], 0, 0
    for row in predicted_labels:
        start, stop, label = row
        lo, hi = _duration_bounds(
            label.replace(label_suffix, ""), call_duration_limits
        )
        dur_s = (stop - start) * delta_t
        if dur_s < lo:
            n_short += 1
        elif dur_s > hi:
            n_long += 1
        else:
            kept.append(row)
    msgr.info(
        f"Discarding {n_short + n_long} calls based on duration "
        f"(too short: {n_short}, too long: {n_long})"
    )
    msgr.success("Filtering predictions finished.")
    return kept


def filter_predictions_file(
    predicted_labels: Path | str,
    output_file: Path | str = "default",
    overwrite: bool = False,
    call_duration_limits: dict | Path | str = DEFAULT_CALL_DURATION_LIMITS,
    label_suffix: str = "*",
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> Path:
    """Re-filter an existing predictions TSV (already in seconds: delta_t=1);
    returns the path written."""
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Filtering predictions")
    if output_file == "default":
        filename = Path(predicted_labels).stem + "_filtered.txt"
        output_file = Path(predicted_labels).with_name(filename)
    else:
        output_file = Path(output_file)
    msgr.info(f"Output file: {output_file}")
    if output_file.exists() and not overwrite:
        raise FileExistsError(f"Annotation file already exists: {output_file}")
    with open(predicted_labels, newline="", encoding="utf-8") as f:
        rows = [
            (float(r["start"]), float(r["stop"]), r["label"])
            for r in csv.DictReader(f, delimiter="\t")
        ]
    kept = filter_predictions(
        rows, delta_t=1, call_duration_limits=call_duration_limits,
        label_suffix=label_suffix, verbosity=verbosity, msgr=msgr,
    )
    save_predictions(kept, output_file, delta_t=1, msgr=msgr)
    return output_file


# ---------------------------------------------------------------- decoding


def compute_labels(
    row_starts,
    row_stops,
    label_names,
    time_steps_per_output_step: int,
    label_suffix: str | None,
) -> list[tuple[int, int, str]]:
    """Output-step run indices -> (start, stop, label) rows in spectrogram
    steps, sorted by start, stop, label."""
    if label_suffix:
        label_names = [name + label_suffix for name in label_names]
    rows = zip(
        (int(s) * time_steps_per_output_step for s in row_starts),
        (int(s) * time_steps_per_output_step for s in row_stops),
        label_names,
    )
    return sorted(rows)


def resolve_predict_dtype() -> torch.dtype:
    """CRNN compute dtype from ORCAI_TPU_PREDICT_DTYPE: "f32" (default) or
    "bf16"; the parameters stay float32 either way."""
    name = os.environ.get("ORCAI_TPU_PREDICT_DTYPE", "f32")
    if name not in ("f32", "bf16"):
        raise ValueError(
            f"ORCAI_TPU_PREDICT_DTYPE must be f32 or bf16, got {name!r}"
        )
    return torch.bfloat16 if name == "bf16" else torch.float32


def _is_streaming_recording(n_samples: int, sp: dict, shape: dict) -> bool:
    """Whether a recording exceeds the spectrogram budget and takes the
    two-pass streaming path (ops/streaming.py: bounded device memory, same
    outputs)."""
    n_frames_est = 1 + n_samples // sp["n_overlap"]
    spec_budget = int(os.environ.get("ORCAI_TPU_STREAM_SPEC_BYTES", 4_000_000_000))
    return 2 * n_frames_est * shape["input_shape"][1] * 4 > spec_budget


def _check_bins(n_bins: int, recording_path: Path, shape: dict) -> None:
    if n_bins != shape["input_shape"][1]:
        raise ValueError(
            f"Spectrogram shape ({n_bins}) for {recording_path.stem} not equal "
            f"to input shape ({shape['input_shape'][1]})"
        )


def _dispatch_wav(
    recording_path: Path | str,
    channel: int,
    predictor: WindowPredictor,
    orcai_parameter: dict,
    shape: dict,
    on_estimate=None,
    wire: str | None = None,
    msgr: Messenger | None = None,
) -> dict:
    """Load one wav and queue its whole device chain, without fetching.

    `on_estimate(est_bytes)` fires after the host read and before any
    device work, with this recording's device-resident estimate: a table's
    wave uses it to fetch what is pending first, so peak device memory
    stays at the wave budget and not at the budget plus one recording.

    Returns a dispatch record for _finish_wav. An in-memory recording leaves
    its output grids on the device (mode "device"); a recording beyond the
    spectrogram budget runs the two-pass streaming path at once and comes
    back fetched (mode "host").
    """
    if msgr is None:
        msgr = Messenger(verbosity=0)
    recording_path = Path(recording_path)
    sp = orcai_parameter["spectrogram"]
    audio, multichannel = load_wav_for_frontend(
        recording_path, sr=sp["sampling_rate"], channel=channel
    )
    if multichannel:
        msgr.warning(f"Multiple channels found, using channel {channel}")
    msgr.part(f"Prediction of annotations for wav_file: {recording_path.stem}")
    n_frames_est = 1 + audio.shape[-1] // sp["n_overlap"]
    n_bins_est = shape["input_shape"][1]

    if _is_streaming_recording(audio.shape[-1], sp, shape):
        msgr.info(
            f"Recording of {n_frames_est} frames exceeds the spectrogram HBM "
            "budget: two-pass streaming inference"
        )
        if on_estimate is not None:
            # the streaming path keeps the audio on the device (up to its own
            # budget) beside its tile transients: fetch the pending wave
            # first, so the peak is the larger of the two and not their sum
            on_estimate(min(
                int(audio.nbytes),
                int(os.environ.get("ORCAI_TPU_HBM_AUDIO_BYTES", 8_000_000_000)),
            ))
        streaming = StreamingPredictor(predictor, sp, wire=wire)
        _check_bins(streaming.hi_idx - streaming.lo_idx, recording_path, shape)
        aggregated, overlap_count = streaming.aggregate(audio)
        return {
            "mode": "host",
            "agg": aggregated,
            "count": overlap_count,
            "delta_t": sp["n_overlap"] / sp["sampling_rate"],
            "est_bytes": 0,
        }

    if on_estimate is not None:
        bucket = _bucket_frames(n_frames_est)
        on_estimate(
            bucket * n_bins_est * 4
            + predictor.planned_spec_bytes(n_frames_est, n_bins_est, bucket)
        )
    spec_dev, n_frames, _, times = make_spectrogram_from_params_device(
        audio, sp, device=predictor.device, wire=wire
    )
    _check_bins(spec_dev.shape[1], recording_path, shape)
    agg_dev, count_dev, n_out_total = predictor.aggregate_device(
        spec_dev, n_frames=n_frames
    )
    # what this recording leaves on the device until its fetch: the
    # frontend's magnitudes (one bucket), the spectrogram and any re-padded
    # copy the chunk plan forces, beside the small output grids
    est_bytes = _bucket_frames(n_frames) * spec_dev.shape[1] * 4
    est_bytes += predictor.planned_spec_bytes(
        n_frames, spec_dev.shape[1], spec_dev.shape[0]
    )
    return {
        "mode": "device",
        "agg_dev": agg_dev,
        "count_dev": count_dev,
        "n_out": n_out_total,
        "delta_t": float(times[1] - times[0]),
        "est_bytes": est_bytes,
    }


def _finish_wav(
    disp: dict,
    predictor: WindowPredictor,
    orcai_parameter: dict,
    label_suffix: str = "*",
    msgr: Messenger | None = None,
) -> tuple[list[tuple[int, int, str]], np.ndarray, float]:
    """Fetch a dispatch record's outputs and decode them to a label table."""
    if msgr is None:
        msgr = Messenger(verbosity=0)
    if disp["mode"] == "device":
        aggregated, overlap_count = predictor.fetch_aggregated(
            disp.pop("agg_dev"), disp.pop("count_dev"), disp["n_out"]
        )
    else:
        aggregated, overlap_count = disp["agg"], disp["count"]
    binary = predictor.binary_predictions(aggregated, overlap_count, threshold=0.5)
    msgr.info("converting binary predictions into start and stop frames")
    starts, stops, names = runs_from_binary_matrix(binary, orcai_parameter["calls"])
    time_steps_per_output_step = 2 ** len(orcai_parameter["model"]["filters"])
    labels = compute_labels(
        starts, stops, names, time_steps_per_output_step, label_suffix
    )
    msgr.info(f"found {len(labels)} acoustic signals")
    msgr.success("Prediction finished.")
    return labels, aggregated, disp["delta_t"]


# ---------------------------------------------------------------- saving


def save_predictions(
    predicted_labels: list[tuple],
    output_path: Path | str,
    delta_t: float,
    msgr: Messenger | None = None,
) -> None:
    """Write the Audacity TSV as the reference's pandas writer does: start
    and stop in seconds (steps * delta_t, float64), rounded to 4 places
    with numpy's round, floats in their shortest repr, tab separated. The
    rows hold steps as ints, or seconds as floats with delta_t = 1."""
    start_s = np.round(np.array([r[0] for r in predicted_labels]) * float(delta_t), 4)
    stop_s = np.round(np.array([r[1] for r in predicted_labels]) * float(delta_t), 4)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(["start", "stop", "label"])
        for a, b, row in zip(start_s, stop_s, predicted_labels):
            writer.writerow([repr(float(a)), repr(float(b)), row[2]])
    (msgr or Messenger(verbosity=0)).info(f"Predictions saved to {output_path}")


def save_prediction_probabilities(
    aggregated_predictions: np.ndarray,
    orcai_parameter: dict,
    delta_t: float,
    output_path: Path | str,
    msgr: Messenger | None = None,
) -> Path:
    """Write `<output stem>_probabilities.csv.gz` beside the TSV: a "time"
    column (delta_t * row, float64) and one float32 column per call, each
    number in numpy's shortest text for its type, which is what the
    reference's pandas writer puts out. Returns the path."""
    output_path = Path(output_path)
    probs_path = output_path.with_name(f"{output_path.stem}_probabilities.csv.gz")
    probs = np.asarray(aggregated_predictions)
    times = (delta_t * np.arange(len(probs))).astype(str)
    cells = probs.astype(str)
    cells[np.isnan(probs)] = ""  # the reference writes a missing value as empty
    with gzip.open(probs_path, "wt", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["time", *orcai_parameter["calls"]])
        writer.writerows([t, *row] for t, row in zip(times, cells))
    (msgr or Messenger(verbosity=0)).info(f"Prediction probabilities saved to {probs_path}")
    return probs_path


def _resolve_output_path(
    recording_path: Path,
    channel: int,
    orcai_parameter: dict,
    output_path: Path | str | None,
    overwrite: bool,
    msgr: Messenger,
) -> Path:
    if output_path is None or output_path == "default":
        filename = (
            f"{recording_path.stem}_c{channel}_"
            f"{orcai_parameter['name']}_predicted.txt"
        )
        output_path = recording_path.with_name(filename)
    else:
        output_path = Path(output_path)
    msgr.info(f"Output file: {output_path}")
    if output_path.exists():
        if not overwrite:
            raise FileExistsError(f"Annotation file already exists: {output_path}")
        msgr.warning(f"Output file {output_path} already exists. Overwriting.")
    return output_path


def _finish_and_save(
    disp: dict,
    output_path: Path,
    predictor: WindowPredictor,
    orcai_parameter: dict,
    save_probabilities: bool = False,
    call_duration_limits: dict | Path | str | None = None,
    label_suffix: str = "*",
    msgr: Messenger | None = None,
) -> None:
    if msgr is None:
        msgr = Messenger(verbosity=0)
    labels, aggregated, delta_t = _finish_wav(
        disp, predictor, orcai_parameter, label_suffix, msgr=msgr
    )
    if call_duration_limits is not None:
        labels = filter_predictions(
            labels, delta_t=delta_t, call_duration_limits=call_duration_limits,
            label_suffix=label_suffix, msgr=msgr,
        )
    save_predictions(labels, output_path, delta_t, msgr=msgr)
    if save_probabilities:
        save_prediction_probabilities(aggregated, orcai_parameter, delta_t, output_path,
                                      msgr=msgr)


def _predict_and_save(
    recording_path: Path,
    channel: int,
    predictor: WindowPredictor,
    orcai_parameter: dict,
    shape: dict,
    output_path: Path | str | None = "default",
    overwrite: bool = False,
    save_probabilities: bool = False,
    call_duration_limits: dict | Path | str | None = None,
    label_suffix: str = "*",
    wire: str | None = None,
    msgr: Messenger | None = None,
) -> Path:
    if msgr is None:
        msgr = Messenger(verbosity=0)
    output_path = _resolve_output_path(
        recording_path, channel, orcai_parameter, output_path, overwrite, msgr
    )
    with exact_f32_math():
        disp = _dispatch_wav(
            recording_path, channel, predictor, orcai_parameter, shape, wire=wire,
            msgr=msgr,
        )
    _finish_and_save(
        disp, output_path, predictor, orcai_parameter,
        save_probabilities=save_probabilities,
        call_duration_limits=call_duration_limits, label_suffix=label_suffix, msgr=msgr,
    )
    return output_path


def build_predictor(
    model_dir: Path, predict_batch_size: int, device, msgr: Messenger | None = None
) -> tuple[WindowPredictor, dict, dict]:
    """(WindowPredictor, orcai_parameter, shape) for a model directory, in
    the compute dtype ORCAI_TPU_PREDICT_DTYPE names, its windows split over
    local_devices(device): every visible card for "cuda" (in a group of
    several processes, this process's share: each process predicts other
    recordings), or a list of devices."""
    devices = local_devices(device)
    model, orcai_parameter, shape = load_orcai_model(
        model_dir, resolve_predict_dtype(), devices[0]
    )
    if len(devices) > 1:
        (msgr or Messenger(verbosity=0)).info(
            f"Sharding inference windows over {len(devices)} devices")
    predictor = WindowPredictor(
        model,
        snippet_len=shape["input_shape"][0],
        n_filters=len(orcai_parameter["model"]["filters"]),
        batch_size=predict_batch_size,
        devices=devices,
    )
    return predictor, orcai_parameter, shape


def _row_error(msgr: Messenger, recording: str, e: Exception) -> None:
    msgr.error(f"Error predicting {recording}: {e.args[0] if e.args else e}")


def _predict_table(
    table_path: Path,
    predictor: WindowPredictor,
    orcai_parameter: dict,
    shape: dict,
    model_dir: Path,
    output_path: Path | str | None,
    overwrite: bool,
    base_dir_recording: str | Path | None,
    finish_kwargs: dict,
    wire: str | None = None,
    msgr: Messenger | None = None,
) -> list[Path]:
    """Every row of a recording table (columns recording, channel,
    base_dir_recording, rel_recording_path), in waves: recordings are
    dispatched, without a fetch, while their device-resident estimate fits
    ORCAI_TPU_WAVE_HBM_BYTES, then fetched, decoded and saved in order. A
    row that fails is logged and does not stop the batch."""
    with open(table_path, newline="", encoding="utf-8") as f:
        table = list(csv.DictReader(f))
    if output_path is not None and output_path != "default":
        # in table mode output_path names a folder, made up front
        Path(output_path).mkdir(parents=True, exist_ok=True)
    # in a group of several processes each predicts its round-robin share
    # of the table's independent recordings; one process keeps them all
    if msgr is None:
        msgr = Messenger(verbosity=0)
    table = shard_table_for_process(table, msgr)
    msgr.part(f"Predicting annotations for {len(table)} wav files")

    wave_budget = int(os.environ.get("ORCAI_TPU_WAVE_HBM_BYTES", 6_000_000_000))
    pending: list[tuple[str, Path, dict]] = []
    pending_paths: set[Path] = set()
    pending_bytes = 0
    saved: list[Path] = []

    def flush_wave() -> None:
        nonlocal pending_bytes
        for recording, out_path, disp in pending:
            try:
                _finish_and_save(
                    disp, out_path, predictor, orcai_parameter, **finish_kwargs,
                    msgr=Messenger(verbosity=0),
                )
                saved.append(out_path)
            except Exception as e:  # keep the batch going on a per-file failure
                _row_error(msgr, recording, e)
        pending.clear()
        pending_paths.clear()
        pending_bytes = 0

    def flush_if_next_overflows(est: int) -> None:
        # fetch the pending wave before this recording's upload commits
        # memory, not after the overshoot has happened
        if pending_bytes and pending_bytes + est > wave_budget:
            flush_wave()

    for row in table:
        try:
            channel = int(row["channel"])  # a csv cell is text
            recording_path = Path(
                base_dir_recording
                if base_dir_recording is not None
                else row["base_dir_recording"]
            ).joinpath(row["rel_recording_path"])
            if output_path is not None and output_path != "default":
                row_output = Path(output_path).joinpath(
                    f"{row['recording']}_{model_dir.stem}_predicted.txt"
                )
            else:
                row_output = output_path
            quiet = Messenger(verbosity=0)
            out_path = _resolve_output_path(
                recording_path, channel, orcai_parameter, row_output, overwrite, quiet
            )
            # files are written when the wave is flushed, so the check on the
            # disk cannot see a duplicate output path queued earlier in the
            # same wave: without this guard the later row would overwrite it
            if not overwrite and out_path in pending_paths:
                raise FileExistsError(
                    f"Annotation file already pending in this batch: {out_path}"
                )
            with exact_f32_math():
                disp = _dispatch_wav(
                    recording_path, channel, predictor, orcai_parameter, shape,
                    on_estimate=flush_if_next_overflows, wire=wire, msgr=quiet,
                )
        except Exception as e:  # keep the batch going on a per-file failure
            _row_error(msgr, row.get("recording"), e)
            continue
        pending.append((row["recording"], out_path, disp))
        pending_paths.add(out_path)
        pending_bytes += disp["est_bytes"]
        if pending_bytes >= wave_budget:
            flush_wave()
    flush_wave()
    msgr.success("Predictions finished.")
    return saved


def predict(
    recording_path: str | Path,
    channel: int = 1,
    model_dir: str | Path | None = None,
    output_path: str | Path | None = "default",
    overwrite: bool = False,
    save_probabilities: bool = False,
    base_dir_recording: str | Path | None = None,
    call_duration_limits: dict | str | Path | None = None,
    label_suffix: str = "*",
    predict_batch_size: int = 128,
    predictor: WindowPredictor | None = None,
    device: str | torch.device = "cuda",
    wire: str | None = None,
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> Path | list[Path]:
    """Predict calls in one wav file, or in every row of a recording table
    (.csv), and write the label TSVs. Returns the path written for a wav and
    the list of paths written for a table.

    For a table `output_path` names a folder (made if missing) that takes
    `<recording>_<model folder>_predicted.txt` per row, `base_dir_recording`
    replaces the table's column of that name, and a row that fails is
    logged while the batch goes on. `call_duration_limits` (a dict or a
    JSON file) drops calls outside their duration limits; None keeps all.

    `device` "cuda" splits each batch of windows over every visible card
    (build_predictor); "cuda:<i>", "cpu" or a list of devices name them.
    Passing `predictor` reuses an already-built WindowPredictor for the same
    model (its devices decide where the work runs). ORCAI_TPU_PREDICT_DTYPE
    =bf16 runs the CRNN forward in bfloat16 with float32 parameters.

    `wire` is the upload's byte form: "exact" (the PCM as it is), "mulaw8",
    "bfp6", "bfp5", or a spectral wire ("sp-bfp6", "sp-bfp5", "sp11-bfp5":
    a host L/M resample, then the base codec); every coded wire holds the
    reference's annotation-level parity, not byte equality. None or "auto"
    resolves through ORCAI_TPU_WIRE, else to exact. The console report goes
    through `msgr` (one of `verbosity` titled "Predicting calls" if None).
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Predicting calls")
    model_dir = Path(model_dir) if model_dir is not None else DEFAULT_MODEL_DIR
    recording_path = Path(recording_path)
    if recording_path.suffix not in (".wav", ".csv"):
        raise ValueError("Recording file must be a wav or csv file")
    msgr.part(f"Loading model: {model_dir.stem}")
    if predictor is not None:
        # the predictor's dtype governs here, but an invalid
        # ORCAI_TPU_PREDICT_DTYPE still raises, as on the cold path
        resolve_predict_dtype()
        orcai_parameter = read_json(model_dir / "orcai_parameter.json")
        shape = read_json(model_dir / "model_shape.json")
        if predictor.snippet_len != shape["input_shape"][0]:
            raise ValueError(
                f"predictor was built for snippet_len {predictor.snippet_len} "
                f"but {model_dir} expects {shape['input_shape'][0]}"
            )
    else:
        predictor, orcai_parameter, shape = build_predictor(
            model_dir, predict_batch_size, device, msgr
        )
    finish_kwargs = dict(
        save_probabilities=save_probabilities,
        call_duration_limits=call_duration_limits,
        label_suffix=label_suffix,
    )
    if recording_path.suffix == ".wav":
        return _predict_and_save(
            recording_path, channel, predictor, orcai_parameter, shape,
            output_path=output_path, overwrite=overwrite, wire=wire, msgr=msgr,
            **finish_kwargs,
        )
    return _predict_table(
        recording_path, predictor, orcai_parameter, shape, model_dir,
        output_path, overwrite, base_dir_recording, finish_kwargs, wire=wire, msgr=msgr,
    )
