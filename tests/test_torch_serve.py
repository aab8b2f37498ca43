"""Port watch-folder service on the CPU (orcai_tpu_torch/pipeline/serve.py,
utils/device_health.py, tools/warmup.py), after tests/test_serve.py:65-306:
per-file outputs byte-equal to the port's `predict`, markers, the retry
after an out-of-memory error, and no marker for a dead CUDA context. No
test waits: the service's `sleep` is a stub."""

import numpy as np
import pytest
import torch

from orcai_tpu.io.model_store import save_orcai_model
from orcai_tpu.io.wav import write_wav
from orcai_tpu.models import build_model as jax_build_model, init_variables
from orcai_tpu.ops.overlap import WindowPredictor as JaxWindowPredictor
from orcai_tpu.tools import warmup as jwarmup
from orcai_tpu_torch.__main__ import main as cli_main
from orcai_tpu_torch.ops.overlap import WindowPredictor
from orcai_tpu_torch.pipeline import predict as predict_mod
from orcai_tpu_torch.pipeline import serve as serve_mod
from orcai_tpu_torch.pipeline.predict import build_predictor, predict
from orcai_tpu_torch.pipeline.serve import scan_ready, serve
from orcai_tpu_torch.tools import warmup as twarmup
from orcai_tpu_torch.utils.device_health import classify_error

SR = 48000
PARAM = {
    "name": "srv-test",
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
BATCH = 8


def setup_module():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("model") / "srv-test"
    save_orcai_model(
        d, PARAM, init_variables(jax_build_model(PARAM), (736, 171, 1), seed=3)
    )
    return d


def _wav(path, seconds=6.0, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    x = 0.01 * rng.standard_normal(n).astype(np.float32)
    x[n // 4 : n // 2] += 0.3 * np.sin(
        2 * np.pi * 2000 * np.arange(n // 4) / SR
    ).astype(np.float32)
    write_wav(path, SR, x)


def _serve(watch, model_dir, out, **kw):
    kw.setdefault("sleep", lambda _: None)
    kw.setdefault("max_idle_polls", 2)
    return serve(watch, model_dir=model_dir, output_dir=out, poll_seconds=0,
                 predict_batch_size=BATCH, device="cpu", **kw)


@pytest.fixture
def folders(tmp_path):
    watch = tmp_path / "incoming"
    watch.mkdir()
    return watch, tmp_path / "out"


def test_serve_processes_existing_and_arriving(model_dir, folders, tmp_path):
    watch, out = folders
    _wav(watch / "a.wav", seed=0)
    dropped = []

    def fake_sleep(_):  # b.wav arrives while the service is running
        if not dropped:
            _wav(watch / "b.wav", seed=1)
            dropped.append(True)

    n = _serve(watch, model_dir, out, max_idle_polls=3, sleep=fake_sleep,
               save_probabilities=True)
    assert n == 2
    assert not list(out.glob("*.failed"))
    for name in ("a", "b"):
        ref = predict(watch / f"{name}.wav", model_dir=model_dir,
                      output_path=tmp_path / f"ref_{name}.txt", save_probabilities=True,
                      predict_batch_size=BATCH, device="cpu")
        served = out / f"{name}_c1_srv-test_predicted.txt"
        assert served.read_bytes() == ref.read_bytes()
        assert served.with_name(served.stem + "_probabilities.csv.gz").exists()


def test_serve_skips_done_and_marks_failures(model_dir, folders):
    watch, out = folders
    out.mkdir()
    _wav(watch / "a.wav", seed=0)
    # an output that is there already: skipped, not counted
    (out / "a_c1_srv-test_predicted.txt").write_text("start\tstop\tlabel\n")
    # a corrupt wav: fails, leaves a marker, does not stop the service
    (watch / "bad.wav").write_bytes(b"RIFF" + b"\x00" * 100)
    assert _serve(watch, model_dir, out) == 1
    marker = out / "bad_c1_srv-test_predicted.txt.failed"
    assert marker.exists() and marker.read_text().strip()
    assert (out / "a_c1_srv-test_predicted.txt").read_text() == "start\tstop\tlabel\n"
    # a second run of the service: the marker keeps the file from a retry
    assert _serve(watch, model_dir, out) == 0


def test_serve_max_files_and_missing_folder(model_dir, folders, tmp_path):
    watch, out = folders
    for name in ("a", "b", "c"):
        _wav(watch / f"{name}.wav", seconds=5.0, seed=2)
    assert _serve(watch, model_dir, out, max_files=2, max_idle_polls=None) == 2
    assert len(list(out.glob("*_predicted.txt"))) == 2
    with pytest.raises(NotADirectoryError):
        _serve(tmp_path / "nowhere", model_dir, out)


def _flaky(monkeypatch, fail):
    """_predict_and_save with `fail(call_number, wav_name)` deciding which
    calls raise what; returns the list of (wav name, predictor) seen."""
    real = predict_mod._predict_and_save
    seen = []

    def wrapped(**kw):
        seen.append((kw["recording_path"].name, kw["predictor"]))
        error = fail(len(seen), kw["recording_path"].name)
        if error is not None:
            raise error
        return real(**kw)

    monkeypatch.setattr(predict_mod, "_predict_and_save", wrapped)
    return seen


def _oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity "
        "of 79.11 GiB of which 1.05 GiB is free."
    )


def test_serve_out_of_memory_rebuilds_and_retries_once(model_dir, folders, monkeypatch):
    watch, out = folders
    _wav(watch / "a.wav", seed=0)
    _wav(watch / "b.wav", seed=1)
    seen = _flaky(monkeypatch, lambda i, name: _oom() if i == 1 else None)
    assert _serve(watch, model_dir, out) == 2
    assert (out / "a_c1_srv-test_predicted.txt").exists()
    assert (out / "b_c1_srv-test_predicted.txt").exists()
    assert not list(out.glob("*.failed"))
    # the retry and every later file ran on a predictor built anew
    assert [name for name, _ in seen] == ["a.wav", "a.wav", "b.wav"]
    assert seen[1][1] is not seen[0][1] and seen[2][1] is seen[1][1]


def test_serve_second_out_of_memory_marks_failed_and_goes_on(
    model_dir, folders, monkeypatch
):
    watch, out = folders
    _wav(watch / "a.wav", seed=0)
    _wav(watch / "b.wav", seed=1)
    seen = _flaky(monkeypatch, lambda i, name: _oom() if name == "a.wav" else None)
    assert _serve(watch, model_dir, out) == 2
    assert [name for name, _ in seen].count("a.wav") == 2  # one retry, not a loop
    assert "out of memory" in (out / "a_c1_srv-test_predicted.txt.failed").read_text()
    assert (out / "b_c1_srv-test_predicted.txt").exists()


def test_serve_ordinary_error_not_retried(model_dir, folders, monkeypatch):
    watch, out = folders
    _wav(watch / "a.wav", seed=0)
    seen = _flaky(monkeypatch,
                  lambda i, name: ValueError("recording shorter than one snippet"))
    assert _serve(watch, model_dir, out) == 1
    assert len(seen) == 1
    assert (out / "a_c1_srv-test_predicted.txt.failed").exists()


@pytest.mark.parametrize("after_retry", [False, True])
def test_serve_dead_context_raises_without_marker(
    model_dir, folders, monkeypatch, after_retry
):
    """A sticky CUDA error is not the file's fault: no marker, the service
    raises, and a new service takes the file again."""
    watch, out = folders
    _wav(watch / "a.wav", seed=0)
    sticky = RuntimeError(
        "CUDA error: an illegal memory access was encountered\n"
        "CUDA kernel errors might be asynchronously reported at some other API call"
    )

    def fail(i, name):
        if after_retry and i == 1:
            return _oom()
        return sticky

    seen = _flaky(monkeypatch, fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _serve(watch, model_dir, out)
    assert len(seen) == (2 if after_retry else 1)
    assert not list(out.glob("*"))
    monkeypatch.undo()
    assert _serve(watch, model_dir, out) == 1
    assert (out / "a_c1_srv-test_predicted.txt").exists()


def _chained(inner, outer):
    try:
        try:
            raise inner
        except Exception as e:
            raise outer from e
    except Exception as e:
        return e


@pytest.mark.parametrize(
    "exc,kind",
    [
        (ValueError("Recording too short for prediction"), "input"),
        (FileNotFoundError("x.wav"), "input"),
        (RuntimeError("CUDA error 7000"), "input"),
        (RuntimeError("cuDNN error: CUDNN_STATUS_NOT_SUPPORTED"), "input"),
        (_oom(), "out_of_memory"),
        (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), "out_of_memory"),
        (_chained(_oom(), ValueError("predict failed")), "out_of_memory"),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), "device_lost"),
        (RuntimeError("CUDA error: unspecified launch failure"), "device_lost"),
        (RuntimeError("CUDA error: device-side assert triggered"), "device_lost"),
        (RuntimeError("CUDA error: uncorrectable ECC error encountered"), "device_lost"),
        (RuntimeError("dft_magnitude kernel launch failed: CUDA error 700"), "device_lost"),
        (RuntimeError("digit_histograms kernel launch failed: CUDA error 719"), "device_lost"),
        (_chained(RuntimeError("CUDA error: unspecified launch failure"),
                  ValueError("predict failed")), "device_lost"),
        # a dead context wins over an out-of-memory error beside it
        (_chained(RuntimeError("CUDA error: an illegal memory access was encountered"),
                  _oom()), "device_lost"),
    ],
)
def test_classify_error(exc, kind):
    assert classify_error(exc) == kind


def test_scan_ready_waits_for_stable_signature(tmp_path):
    watch = tmp_path / "incoming"
    watch.mkdir()
    p = watch / "grow.wav"
    p.write_bytes(b"\x00" * 100)
    ready, sigs = scan_ready(watch, {}, set())
    assert ready == []  # a first sighting is never ready
    p.write_bytes(b"\x00" * 200)  # still being written
    ready, sigs = scan_ready(watch, sigs, set())
    assert ready == []
    ready, sigs = scan_ready(watch, sigs, set())
    assert ready == [p]  # the same in two polls
    ready, _ = scan_ready(watch, sigs, {p})
    assert ready == []  # done files are not offered again
    (watch / "header.wav").write_bytes(b"\x00" * 44)  # a bare header never is
    _, sigs = scan_ready(watch, {}, set())
    assert scan_ready(watch, sigs, set())[0] == [p]


def test_cli_serve_smoke(model_dir, folders, capsys):
    watch, out = folders
    _wav(watch / "a.wav", seed=0)
    with pytest.raises(SystemExit) as e:
        cli_main(["serve", "--help"])
    assert e.value.code == 0 and "life of the process" in capsys.readouterr().out
    assert cli_main([
        "serve", str(watch), "--model_dir", str(model_dir), "--output_dir", str(out),
        "--poll_seconds", "0", "--max_files", "1", "-bs", str(BATCH),
        "--device", "cpu", "-v", "0",
    ]) == 0
    assert (out / "a_c1_srv-test_predicted.txt").exists()


# ---------------------------------------------------------------- warm-up


def _jax_predictor(batch, cap):
    param = {**PARAM, "model": {**PARAM["model"]}}
    jmodel = jax_build_model(param)
    return JaxWindowPredictor(jmodel, None, snippet_len=736, n_filters=4,
                              batch_size=batch, max_windows_per_chunk=cap,
                              dense_trunk=False)


@pytest.mark.parametrize("minutes", [0.05, 0.5, 1, 3, 10, 45, 90, 200])
def test_bucket_sample_counts_equal_the_originals(minutes):
    for sr, hop in ((48000, 256), (4800, 24), (44100, 512)):
        assert (twarmup.bucket_sample_counts(minutes, sr, hop)
                == jwarmup.bucket_sample_counts(minutes, sr, hop))


@pytest.mark.parametrize("minutes", [0.05, 0.5, 1, 3, 10, 45])
@pytest.mark.parametrize("batch,cap", [(128, 2048), (8, 64)])
def test_bucket_warm_counts_equal_the_originals(model_dir, minutes, batch, cap):
    predictor, _, _ = build_predictor(model_dir, batch, "cpu")
    ours = WindowPredictor(predictor.model, snippet_len=736, n_filters=4,
                           batch_size=batch, max_windows_per_chunk=cap)
    ref = _jax_predictor(batch, cap)
    assert (twarmup.bucket_warm_counts(minutes, SR, 256, ours)
            == jwarmup.bucket_warm_counts(minutes, SR, 256, ref))


def test_warmup_runs_the_predict_path(model_dir, monkeypatch):
    """`warmup` sends one recording per warm count through the frontend and
    the predictor, and `serve(warm_minutes=...)` warms its own predictor."""
    lengths, wires = [], []
    real = twarmup.make_spectrogram_from_params_device

    def spy(audio, sp, device, wire):
        lengths.append(audio.shape[0])
        wires.append(wire)
        return real(audio, sp, device=device, wire=wire)

    monkeypatch.setattr(twarmup, "make_spectrogram_from_params_device", spy)
    predictor, param, _ = build_predictor(model_dir, BATCH, "cpu")
    want = twarmup.bucket_warm_counts(0.25, SR, 256, predictor)
    assert len(want) >= 2
    assert twarmup.warmup(0.25, model_dir, BATCH, device="cpu") == len(want)
    assert lengths == want
    lengths.clear()
    assert set(wires) == {None}
    lengths.clear()
    wires.clear()
    assert cli_main(["warmup", "--minutes", "0.25", "-md", str(model_dir),
                     "-bs", str(BATCH), "--device", "cpu", "-v", "0", "-wc", "sp-bfp5"]) == 0
    assert lengths == want
    assert set(wires) == {"sp-bfp5"}


def test_serve_warms_its_own_predictor(model_dir, folders, monkeypatch):
    watch, out = folders
    warmed = []
    monkeypatch.setattr(
        serve_mod, "warm_predictor",
        lambda predictor, sp, minutes, wire, msgr: warmed.append((predictor, minutes, wire)) or 0,
    )
    _wav(watch / "a.wav", seed=0)
    seen = _flaky(monkeypatch, lambda i, name: None)
    assert _serve(watch, model_dir, out, warm_minutes=0.1, wire="mulaw8") == 1
    assert warmed == [(seen[0][1], 0.1, "mulaw8")]


@pytest.mark.parametrize("wire", ["mulaw8", "sp-bfp5"])
def test_serve_on_a_coded_wire_writes_what_predict_writes(model_dir, folders, tmp_path, wire):
    watch, out = folders
    _wav(watch / "a.wav", seed=2)
    assert cli_main(["serve", str(watch), "-o", str(out), "-md", str(model_dir), "-bs",
                     str(BATCH), "-mf", "1", "-ps", "0", "-wc", wire, "--device", "cpu",
                     "-v", "0"]) == 0
    ref = predict(watch / "a.wav", model_dir=model_dir, output_path=tmp_path / "ref.txt",
                  predict_batch_size=BATCH, device="cpu", wire=wire)
    assert (out / "a_c1_srv-test_predicted.txt").read_bytes() == ref.read_bytes()
