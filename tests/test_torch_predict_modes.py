"""Port predict modes on the CPU (orcai_tpu_torch/pipeline/predict.py): the
recording-table batch, waves, probabilities, duration filtering,
multichannel wavs and the streaming branch, each TSV byte-equal to what the
JAX package's predict writes for the same model and wavs
(tests/test_predict_modes.py:64-180, 217-369)."""

import csv
import gzip
import json
import shutil
from functools import partial
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from orcai_tpu.io.model_store import save_orcai_model
from orcai_tpu.io.wav import write_wav
from orcai_tpu.models import build_model as jax_build_model, init_variables
from orcai_tpu.pipeline import predict as jpredict
from orcai_tpu.utils import Messenger
from orcai_tpu_torch.__main__ import main as cli_main
from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR
from orcai_tpu_torch.io.wav import load_wav_for_frontend
from orcai_tpu_torch.ops.streaming import StreamingPredictor
from orcai_tpu_torch.pipeline import predict as tpredict
from orcai_tpu_torch.pipeline.predict import (
    DEFAULT_CALL_DURATION_LIMITS,
    _dispatch_wav,
    _finish_wav,
    build_predictor,
    filter_predictions,
    filter_predictions_file,
    predict,
    save_prediction_probabilities,
    save_predictions,
)

FIXTURES = Path(__file__).parent / "fixtures"
SR = 48000
BATCH = 8
PARAM = {
    "name": "pm-test",
    "architecture": "ResNetLSTM",
    "model": {"filters": [4, 6, 8, 10], "kernel_size": 3, "dropout_rate": 0.2,
              "lstm_units": 8, "learning_rate": 1e-4},
    "spectrogram": {"sampling_rate": SR, "nfft": 512, "n_overlap": 256,
                    "freq_range": [0, 16000], "quantiles": [0.01, 0.999],
                    "duration": 4},
    "calls": ["A", "B"],
    "snippets": {"segment_duration": 60, "snippets_per_sec": 1,
                 "snippet_duration": 4, "fraction_removal": 0.2,
                 "train": 0.8, "val": 0.1, "test": 0.1},
    "seed": 7,
}
RECORDINGS = {"w0": (6.0, 10), "w1": (7.0, 11), "w2": (8.0, 12)}  # seconds, seed


def setup_module():
    torch.set_num_threads(1)


def _write_recording(path, seconds=8.0, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    x = 0.01 * rng.standard_normal((channels, n)).astype(np.float32)
    x[0, n // 4 : n // 2] += 0.3 * np.sin(
        2 * np.pi * 2000 * np.arange(n // 4) / SR
    ).astype(np.float32)
    write_wav(path, SR, x if channels > 1 else x[0])


def _jax_predict(recording, model_dir, output_path, **kw):
    jpredict.predict(recording, model_dir=model_dir, output_path=output_path,
                     msgr=Messenger(verbosity=0), verbosity=0,
                     predict_batch_size=BATCH, wire="exact", **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A small model saved by the JAX package, three wavs and a stereo one,
    and the JAX package's single-file TSV for each."""
    root = tmp_path_factory.mktemp("modes")
    model_dir = root / "pm-test"
    save_orcai_model(
        model_dir, PARAM, init_variables(jax_build_model(PARAM), (736, 171, 1), seed=3)
    )
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    for name, (seconds, seed) in RECORDINGS.items():
        _write_recording(wav_dir / f"{name}.wav", seconds=seconds, seed=seed)
    _write_recording(wav_dir / "stereo.wav", channels=2, seed=9)
    ref = {}
    for name in RECORDINGS:
        out = root / f"jax_{name}.txt"
        _jax_predict(wav_dir / f"{name}.wav", model_dir, out)
        ref[name] = out.read_bytes()
        assert len(ref[name].splitlines()) > 1  # a header and at least one call
    return {"root": root, "model_dir": model_dir, "wav_dir": wav_dir, "ref": ref}


def _table(path, wav_dir, recordings, rel=None):
    rel = rel or [f"{r}.wav" for r in recordings]
    pd.DataFrame({
        "recording": recordings,
        "channel": [1] * len(recordings),
        "base_dir_recording": str(wav_dir),
        "rel_recording_path": rel,
    }).to_csv(path, index=False)
    return path


def test_predict_recording_table_batch(world, tmp_path):
    """A missing wav must not stop the batch; the folder is created; every
    TSV is named by the recording and the model folder, and is byte-equal
    to the JAX package's."""
    table = _table(tmp_path / "table.csv", world["wav_dir"], ["w0", "w1", "missing"])
    out_dir = tmp_path / "does" / "not" / "exist"
    saved = predict(table, model_dir=world["model_dir"], output_path=out_dir,
                    predict_batch_size=BATCH, device="cpu")
    assert saved == [out_dir / f"{r}_pm-test_predicted.txt" for r in ("w0", "w1")]
    for r in ("w0", "w1"):
        assert (out_dir / f"{r}_pm-test_predicted.txt").read_bytes() == world["ref"][r]
    assert not (out_dir / "missing_pm-test_predicted.txt").exists()


def test_table_default_output_and_base_dir(world, tmp_path):
    """output_path "default" saves next to each wav under the single-file
    name (with the channel, a text cell of the csv), and base_dir_recording
    replaces the table's column."""
    moved = tmp_path / "moved"
    moved.mkdir()
    shutil.copy(world["wav_dir"] / "w0.wav", moved / "w0.wav")
    table = _table(tmp_path / "table.csv", tmp_path / "nowhere", ["w0"])
    saved = predict(table, model_dir=world["model_dir"], base_dir_recording=moved,
                    predict_batch_size=BATCH, device="cpu")
    assert saved == [moved / "w0_c1_pm-test_predicted.txt"]
    assert saved[0].read_bytes() == world["ref"]["w0"]


def test_batch_duplicate_output_path_does_not_clobber(world, tmp_path):
    """Two rows that resolve to one output file: the pending-path guard
    keeps the first row's TSV."""
    table = _table(tmp_path / "table.csv", world["wav_dir"], ["dup", "dup"],
                   rel=["w0.wav", "w1.wav"])
    out_dir = tmp_path / "out"
    saved = predict(table, model_dir=world["model_dir"], output_path=out_dir,
                    predict_batch_size=BATCH, device="cpu")
    assert saved == [out_dir / "dup_pm-test_predicted.txt"]
    assert saved[0].read_bytes() == world["ref"]["w0"]


@pytest.mark.parametrize(
    "budget",
    [
        "1",  # a flush after every file
        "4000000",  # one to two recordings: the flush before the dispatch
    ],
)
def test_batch_waves_match_single_file_predicts(world, tmp_path, monkeypatch, budget):
    flushes = []
    real = tpredict._finish_and_save

    def spy(disp, out_path, *a, **k):
        flushes.append(out_path.name)
        return real(disp, out_path, *a, **k)

    monkeypatch.setattr(tpredict, "_finish_and_save", spy)
    monkeypatch.setenv("ORCAI_TPU_WAVE_HBM_BYTES", budget)
    table = _table(tmp_path / "table.csv", world["wav_dir"], list(RECORDINGS))
    predict(table, model_dir=world["model_dir"], output_path=tmp_path / "batch",
            predict_batch_size=BATCH, device="cpu")
    assert len(flushes) == len(RECORDINGS)
    for name in RECORDINGS:
        single = predict(world["wav_dir"] / f"{name}.wav", model_dir=world["model_dir"],
                         output_path=tmp_path / f"single_{name}.txt",
                         predict_batch_size=BATCH, device="cpu")
        batch = (tmp_path / "batch" / f"{name}_pm-test_predicted.txt").read_bytes()
        assert batch == single.read_bytes() == world["ref"][name]


def test_streaming_branch_flushes_wave_first(world, tmp_path, monkeypatch):
    """A recording that streams must fire on_estimate before any streaming
    device work, with the audio's bytes (capped at the audio budget)."""
    predictor, param, shape = build_predictor(world["model_dir"], BATCH, "cpu")
    events = []

    class StubStreaming:
        def __init__(self, predictor, sp, wire):
            events.append("streaming_init")
            self.lo_idx, self.hi_idx = 0, shape["input_shape"][1]

        def aggregate(self, audio):
            events.append("streaming_aggregate")
            return np.zeros((4, 2), np.float32), np.ones(4, np.float32)

    monkeypatch.setattr(tpredict, "StreamingPredictor", StubStreaming)
    monkeypatch.setattr(tpredict, "_is_streaming_recording", lambda n, sp, shape: True)
    disp = _dispatch_wav(world["wav_dir"] / "w0.wav", 1, predictor, param, shape,
                         on_estimate=lambda est: events.append(("estimate", est)))
    n_samples = int(RECORDINGS["w0"][0] * SR)
    assert disp["mode"] == "host" and disp["est_bytes"] == 0
    assert events == [("estimate", 2 * n_samples), "streaming_init", "streaming_aggregate"]
    monkeypatch.setenv("ORCAI_TPU_HBM_AUDIO_BYTES", "1000")
    events.clear()
    _dispatch_wav(world["wav_dir"] / "w0.wav", 1, predictor, param, shape,
                  on_estimate=lambda est: events.append(("estimate", est)))
    assert events[0] == ("estimate", 1000)


@pytest.mark.parametrize("audio_budget", ["8000000000", "0"])
def test_predict_streams_past_the_spectrogram_budget(
    world, tmp_path, monkeypatch, audio_budget
):
    """ORCAI_TPU_STREAM_SPEC_BYTES routes a wav and a table row through the
    streaming branch (here with small tiles: the default ones are for the
    card); the TSVs stay byte-equal to the JAX package's."""
    built = []

    def small_tiles(predictor, sp, wire):
        built.append(1)
        return StreamingPredictor(predictor, sp, windows_per_chunk=8,
                                  stats_tile_frames=512, wire=wire)

    monkeypatch.setattr(tpredict, "StreamingPredictor", small_tiles)
    monkeypatch.setenv("ORCAI_TPU_STREAM_SPEC_BYTES", "1")
    monkeypatch.setenv("ORCAI_TPU_HBM_AUDIO_BYTES", audio_budget)
    out = predict(world["wav_dir"] / "w1.wav", model_dir=world["model_dir"],
                  output_path=tmp_path / "s.txt", predict_batch_size=BATCH, device="cpu")
    assert built == [1]
    assert out.read_bytes() == world["ref"]["w1"]
    table = _table(tmp_path / "table.csv", world["wav_dir"], ["w0"])
    saved = predict(table, model_dir=world["model_dir"], output_path=tmp_path / "t",
                    predict_batch_size=BATCH, device="cpu")
    assert built == [1, 1]
    assert saved[0].read_bytes() == world["ref"]["w0"]


def test_is_streaming_recording_budget(monkeypatch):
    sp, shape = {"n_overlap": 256}, {"input_shape": [736, 171, 1]}
    # the default 4e9 bytes: 2 * frames * 171 * 4 passes it at 2,923,977 frames
    assert not tpredict._is_streaming_recording(2_923_975 * 256, sp, shape)
    assert tpredict._is_streaming_recording(2_923_977 * 256, sp, shape)
    assert jpredict._is_streaming_recording(2_923_977 * 256, sp, shape)
    monkeypatch.setenv("ORCAI_TPU_STREAM_SPEC_BYTES", "1")
    assert tpredict._is_streaming_recording(256, sp, shape)


def test_golden_through_streaming_branch(tmp_path):
    """The golden wav through StreamingPredictor at small tiles (three stats
    tiles, two chunks) and the pipeline's own decode: byte-equal to the
    expected TSV."""
    predictor, param, shape = build_predictor(DEFAULT_MODEL_DIR, 16, "cpu")
    audio, _ = load_wav_for_frontend(FIXTURES / "golden.wav", sr=SR)
    streaming = StreamingPredictor(predictor, param["spectrogram"],
                                   stats_tile_frames=4096, windows_per_chunk=16)
    aggregated, count = streaming.aggregate(audio)
    disp = {"mode": "host", "agg": aggregated, "count": count,
            "delta_t": 256 / SR, "est_bytes": 0}
    labels, _, delta_t = _finish_wav(disp, predictor, param)
    save_predictions(labels, tmp_path / "g.txt", delta_t)
    assert (tmp_path / "g.txt").read_bytes() == (FIXTURES / "golden_expected.txt").read_bytes()


def test_output_path_none_means_default(world, tmp_path):
    wav = tmp_path / "nonedest.wav"
    shutil.copy(world["wav_dir"] / "w0.wav", wav)
    out = predict(wav, model_dir=world["model_dir"], output_path=None,
                  predict_batch_size=BATCH, device="cpu")
    assert out == tmp_path / "nonedest_c1_pm-test_predicted.txt"
    assert out.read_bytes() == world["ref"]["w0"]


def test_predict_multichannel(world, tmp_path):
    ref = tmp_path / "jax.txt"
    _jax_predict(world["wav_dir"] / "stereo.wav", world["model_dir"], ref, channel=2)
    out = predict(world["wav_dir"] / "stereo.wav", channel=2,
                  model_dir=world["model_dir"], output_path=tmp_path / "stereo.txt",
                  predict_batch_size=BATCH, device="cpu")
    assert out.read_bytes() == ref.read_bytes()
    with pytest.raises(ValueError, match="channel 3"):
        predict(world["wav_dir"] / "stereo.wav", channel=3, model_dir=world["model_dir"],
                output_path=tmp_path / "no.txt", predict_batch_size=BATCH, device="cpu")


def _gunzip(path):
    with gzip.open(path, "rt", newline="") as f:
        return f.read()


def test_predict_save_probabilities_and_filtering(world, tmp_path):
    """The filtered TSV byte-equal to the JAX package's; the probabilities
    on the output grid, the same time column and values within 1e-4."""
    limits = tmp_path / "limits.json"
    limits.write_text(json.dumps({"default": [0.05, 10.0], "A": [0.5, 3.0]}))
    wav = world["wav_dir"] / "w2.wav"
    _jax_predict(wav, world["model_dir"], tmp_path / "jax.txt",
                 save_probabilities=True, call_duration_limits=limits)
    out = predict(wav, model_dir=world["model_dir"], output_path=tmp_path / "x_pred.txt",
                  save_probabilities=True, call_duration_limits=limits,
                  predict_batch_size=BATCH, device="cpu")
    assert out.read_bytes() == (tmp_path / "jax.txt").read_bytes()
    ours = pd.read_csv(tmp_path / "x_pred_probabilities.csv.gz")
    ref = pd.read_csv(tmp_path / "jax_probabilities.csv.gz")
    assert list(ours.columns) == ["time", "A", "B"]
    assert len(ours) == (1 + int(8.0 * SR) // 256) // 16
    ours_text = _gunzip(tmp_path / "x_pred_probabilities.csv.gz").splitlines()
    ref_text = _gunzip(tmp_path / "jax_probabilities.csv.gz").splitlines()
    assert [ln.split(",")[0] for ln in ours_text] == [ln.split(",")[0] for ln in ref_text]
    np.testing.assert_allclose(ours[["A", "B"]], ref[["A", "B"]], atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_probabilities_text_equals_pandas_writer(tmp_path, seed):
    """The same float32 array through both writers: equal text once
    unpacked (the gzip header carries a time). Small values print in
    scientific form, and the float64 index in float64's own."""
    rng = np.random.default_rng(seed)
    probs = rng.random((300, 3), dtype=np.float32)
    probs[::7] *= np.float32(1e-6)
    probs[5] = [0.0, 1.0, 0.5]
    probs[6, 1] = np.nan
    param = {"calls": ["A", "B,with comma", "C"]}
    delta_t = 16 * 256 / SR
    ours = save_prediction_probabilities(probs, param, delta_t, tmp_path / "o.txt")
    jpredict.save_prediction_probabilities(probs, param, delta_t, tmp_path / "r.txt")
    assert ours == tmp_path / "o_probabilities.csv.gz"
    assert _gunzip(ours) == _gunzip(tmp_path / "r_probabilities.csv.gz")


LIMITS = {"default": [0.05, 2.0], "A": [None, 1.0], "B": [0.2, None], "C": [None, None]}


def _random_rows(seed, n, suffix):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 200_000, n) * 16
    stops = starts + rng.integers(1, 60, n) * 16
    labels = [str(x) + suffix for x in rng.choice(["A", "B", "C", "D"], n)]
    return sorted(zip(starts.tolist(), stops.tolist(), labels))


@pytest.mark.parametrize("limits", [LIMITS, {"A": [0.1, 0.5]}, "default file"])
@pytest.mark.parametrize("suffix", ["*", "_p"])
def test_filter_predictions_matches_pandas(limits, suffix):
    if limits == "default file":
        limits = DEFAULT_CALL_DURATION_LIMITS
    rows = _random_rows(3, 500, suffix)
    delta_t = 256 / SR
    kept = filter_predictions(rows, delta_t, limits, label_suffix=suffix)
    ref = jpredict.filter_predictions(
        pd.DataFrame(rows, columns=["start", "stop", "label"]), delta_t,
        call_duration_limits=limits, label_suffix=suffix,
        msgr=Messenger(verbosity=0),
    )
    assert kept == list(ref[["start", "stop", "label"]].itertuples(index=False, name=None))
    if limits is LIMITS:
        assert 0 < len(kept) < len(rows)


def test_filter_predictions_file_matches_pandas(tmp_path):
    rows = _random_rows(4, 400, "*")
    save_predictions(rows, tmp_path / "pred.txt", 256 / SR)
    shutil.copy(tmp_path / "pred.txt", tmp_path / "ref.txt")
    limits = tmp_path / "limits.json"
    limits.write_text(json.dumps(LIMITS))
    out = filter_predictions_file(tmp_path / "pred.txt", call_duration_limits=limits)
    jpredict.filter_predictions_file(tmp_path / "ref.txt", call_duration_limits=limits,
                                     msgr=Messenger(verbosity=0))
    assert out == tmp_path / "pred_filtered.txt"
    assert out.read_bytes() == (tmp_path / "ref_filtered.txt").read_bytes()
    with open(out, newline="") as f:
        assert 0 < len(list(csv.reader(f, delimiter="\t"))) - 1 < len(rows)
    with pytest.raises(FileExistsError):
        filter_predictions_file(tmp_path / "pred.txt", call_duration_limits=limits)
    # the command line, with the default limits (which keep every call)
    assert cli_main(["filter-predictions", str(tmp_path / "pred.txt"), "-ow", "-v", "0"]) == 0
    assert out.read_bytes() == (tmp_path / "pred.txt").read_bytes()


def test_cli_predict_table(world, tmp_path):
    table = _table(tmp_path / "table.csv", world["wav_dir"], ["w0"])
    assert cli_main([
        "predict", str(table), "-md", str(world["model_dir"]), "-o", str(tmp_path / "o"),
        "-bs", str(BATCH), "-sp", "-cdl", str(DEFAULT_CALL_DURATION_LIMITS),
        "--device", "cpu", "-v", "0",
    ]) == 0
    assert (tmp_path / "o" / "w0_pm-test_predicted.txt").read_bytes() == world["ref"]["w0"]
    assert (tmp_path / "o" / "w0_pm-test_predicted_probabilities.csv.gz").exists()


@pytest.mark.parametrize("command", [["predict", "t.csv"], ["serve", "."], ["warmup"]])
def test_cli_defaults_to_cuda_and_raises_without_it(command, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "t.csv").write_text(
        "recording,channel,base_dir_recording,rel_recording_path\n")
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main([*command, "-v", "0"])
