"""Prediction pipeline: one wav recording -> Audacity-format label file.

Counterpart of orcai_tpu/pipeline/predict.py for a single .wav on the
in-memory path: the spectrogram frontend, windowed inference and
overlap-add run on the device (ops/frontend.py, ops/overlap.py); run
lengths and the table output run on the host, without pandas. Output
contract: `<stem>_c<channel>_<model>_predicted.txt`, a TSV of start/stop
seconds rounded to 4 places and the label with its suffix, byte-equal to
what the reference writes. Recording tables (.csv), duration filtering,
probability files and the streaming path are not ported yet.
"""

from __future__ import annotations

import csv
import logging
import os
from pathlib import Path

import numpy as np
import torch

from orcai_tpu_torch.io.jsonio import read_json
from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR, load_orcai_model
from orcai_tpu_torch.io.wav import load_wav_for_frontend
from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device
from orcai_tpu_torch.ops.overlap import WindowPredictor
from orcai_tpu_torch.utils.device import exact_f32_math, resolve_device
from orcai_tpu_torch.utils.rle import runs_from_binary_matrix

log = logging.getLogger(__name__)


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


def _dispatch_wav(
    recording_path: Path | str,
    channel: int,
    predictor: WindowPredictor,
    orcai_parameter: dict,
    shape: dict,
) -> dict:
    """Load one wav and queue its whole device chain, without fetching."""
    recording_path = Path(recording_path)
    sp = orcai_parameter["spectrogram"]
    audio, multichannel = load_wav_for_frontend(
        recording_path, sr=sp["sampling_rate"], channel=channel
    )
    if multichannel:
        log.warning("Multiple channels found, using channel %d", channel)
    log.info("Prediction of annotations for wav_file: %s", recording_path.stem)
    spec_dev, n_frames, _, times = make_spectrogram_from_params_device(
        audio, sp, device=predictor.device
    )
    if spec_dev.shape[1] != shape["input_shape"][1]:
        raise ValueError(
            f"Spectrogram shape ({spec_dev.shape[1]}) for "
            f"{recording_path.stem} not equal to input shape "
            f"({shape['input_shape'][1]})"
        )
    agg_dev, count_dev, n_out_total = predictor.aggregate_device(
        spec_dev, n_frames=n_frames
    )
    return {
        "agg_dev": agg_dev,
        "count_dev": count_dev,
        "n_out": n_out_total,
        "delta_t": float(times[1] - times[0]),
    }


def _finish_wav(
    disp: dict,
    predictor: WindowPredictor,
    orcai_parameter: dict,
    label_suffix: str = "*",
) -> tuple[list[tuple[int, int, str]], np.ndarray, float]:
    """Fetch a dispatch record's outputs and decode them to a label table."""
    aggregated, overlap_count = predictor.fetch_aggregated(
        disp.pop("agg_dev"), disp.pop("count_dev"), disp["n_out"]
    )
    binary = predictor.binary_predictions(aggregated, overlap_count, threshold=0.5)
    starts, stops, names = runs_from_binary_matrix(binary, orcai_parameter["calls"])
    time_steps_per_output_step = 2 ** len(orcai_parameter["model"]["filters"])
    labels = compute_labels(
        starts, stops, names, time_steps_per_output_step, label_suffix
    )
    log.info("found %d acoustic signals", len(labels))
    return labels, aggregated, disp["delta_t"]


def save_predictions(
    predicted_labels: list[tuple[int, int, str]],
    output_path: Path | str,
    delta_t: float,
) -> None:
    """Write the Audacity TSV as the reference's pandas writer does: start
    and stop in seconds (steps * delta_t, float64), rounded to 4 places
    with numpy's round, floats in their shortest repr, tab separated."""
    starts = np.array([r[0] for r in predicted_labels], dtype=np.int64)
    stops = np.array([r[1] for r in predicted_labels], dtype=np.int64)
    start_s = np.round(starts * delta_t, 4)
    stop_s = np.round(stops * delta_t, 4)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(["start", "stop", "label"])
        for a, b, row in zip(start_s, stop_s, predicted_labels):
            writer.writerow([repr(float(a)), repr(float(b)), row[2]])
    log.info("Predictions saved to %s", output_path)


def _resolve_output_path(
    recording_path: Path,
    channel: int,
    orcai_parameter: dict,
    output_path: Path | str | None,
    overwrite: bool,
) -> Path:
    if output_path is None or output_path == "default":
        filename = (
            f"{recording_path.stem}_c{channel}_"
            f"{orcai_parameter['name']}_predicted.txt"
        )
        output_path = recording_path.with_name(filename)
    else:
        output_path = Path(output_path)
    log.info("Output file: %s", output_path)
    if output_path.exists():
        if not overwrite:
            raise FileExistsError(f"Annotation file already exists: {output_path}")
        log.warning("Output file %s already exists. Overwriting.", output_path)
    return output_path


def predict(
    recording_path: str | Path,
    channel: int = 1,
    model_dir: str | Path | None = None,
    output_path: str | Path | None = "default",
    overwrite: bool = False,
    label_suffix: str = "*",
    predict_batch_size: int = 128,
    predictor: WindowPredictor | None = None,
    device: str | torch.device = "cuda",
) -> Path:
    """Predict calls in one wav file and write the label TSV; returns its path.

    Passing `predictor` reuses an already-built WindowPredictor for the same
    model (its device decides where the work runs). ORCAI_TPU_PREDICT_DTYPE
    =bf16 runs the CRNN forward in bfloat16 with float32 parameters.
    """
    dtype = resolve_predict_dtype()
    model_dir = Path(model_dir) if model_dir is not None else DEFAULT_MODEL_DIR
    recording_path = Path(recording_path)
    if recording_path.suffix != ".wav":
        raise ValueError(
            "Recording file must be a wav file (recording tables are not "
            "supported by this package yet)"
        )
    log.info("Loading model: %s", model_dir.stem)
    if predictor is not None:
        orcai_parameter = read_json(model_dir / "orcai_parameter.json")
        shape = read_json(model_dir / "model_shape.json")
        if predictor.snippet_len != shape["input_shape"][0]:
            raise ValueError(
                f"predictor was built for snippet_len {predictor.snippet_len} "
                f"but {model_dir} expects {shape['input_shape'][0]}"
            )
    else:
        dev = resolve_device(device)
        model, orcai_parameter, shape = load_orcai_model(model_dir, dtype, dev)
        predictor = WindowPredictor(
            model,
            snippet_len=shape["input_shape"][0],
            n_filters=len(orcai_parameter["model"]["filters"]),
            batch_size=predict_batch_size,
        )
    out_path = _resolve_output_path(
        recording_path, channel, orcai_parameter, output_path, overwrite
    )
    with exact_f32_math():
        disp = _dispatch_wav(
            recording_path, channel, predictor, orcai_parameter, shape
        )
    labels, _, delta_t = _finish_wav(disp, predictor, orcai_parameter, label_suffix)
    save_predictions(labels, out_path, delta_t)
    return out_path
