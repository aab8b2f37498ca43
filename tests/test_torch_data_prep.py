"""Data production on the port against the JAX package, run in the same
process on the CPU: recording table, init, spectrograms, label arrays,
snippet and TVT tables, TVT datasets, the CLI, and the chain as a whole
ending in one epoch of the port's `train`.

A small project (two 70 s recordings, filters 4/6/8/10, as
tests/test_pipeline_e2e.py uses) goes through both packages. Bars: the
spectrogram stores within 2e-4 (the frontend's bar, tests/test_frontend.py),
the label arrays and TVT labels bit-equal, every CSV and JSON text-equal.
"""

import gzip
import json
import shutil
import signal
import threading
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from orcai_tpu.io import open_zarr as jax_open_zarr
from orcai_tpu.io.dataset import ArrayDataset as JaxArrayDataset
from orcai_tpu.io.dataset import SnippetDataLoader as JaxLoader
from orcai_tpu.io.wav import write_wav
from orcai_tpu.ops.frontend import compute_spectrogram_host as jax_host_frontend
from orcai_tpu.pipeline import helpers as jax_helpers
from orcai_tpu.pipeline import labels as jax_labels
from orcai_tpu.pipeline import snippets as jax_snippets
from orcai_tpu.pipeline import spectrogram as jax_spectrogram
from orcai_tpu.tools import synthetic as jax_synthetic
from orcai_tpu.utils import Messenger
from orcai_tpu_torch.__main__ import main as port_main
from orcai_tpu_torch.io.dataset import ArrayDataset, SnippetDataLoader
from orcai_tpu_torch.io.tables import Table
from orcai_tpu_torch.io.zarrlite import open_zarr
from orcai_tpu_torch.ops.frontend import compute_spectrogram_host
from orcai_tpu_torch.pipeline import helpers, labels, snippets, spectrogram
from orcai_tpu_torch.tools import synthetic

SR = 48000
CALLS = ["CALL_A", "CALL_B"]
QUIET = Messenger(verbosity=0)
SPEC_ATOL = 2e-4
PARAM = {
    "name": "data-prep-test",
    "architecture": "ResNetLSTM",
    "model": {
        "epochs": 1, "batch_size": 4, "filters": [4, 6, 8, 10],
        "conv_initializer": "he_normal", "kernel_size": 3, "dropout_rate": 0.2,
        "lstm_units": 8, "lstm_initializer": "glorot_uniform",
        "n_batch_train": 4, "n_batch_val": 2, "n_batch_test": 2, "shuffle": True,
        "learning_rate": 1e-4, "EarlyStopping_patience": 10,
        "ReduceLROnPlateau_patience": 3, "ReduceLROnPlateau_factor": 0.5,
        "ReduceLROnPlateau_min_learning_rate": 1e-7, "call_weights": "balanced",
        "monitor": "val_MBA",
    },
    "spectrogram": {
        "sampling_rate": SR, "nfft": 512, "n_overlap": 256, "freq_range": [0, 16000],
        "quantiles": [0.01, 0.999], "duration": 4,
    },
    "calls": CALLS,
    "snippets": {
        "segment_duration": 60, "snippets_per_sec": 1, "snippet_duration": 4,
        "fraction_removal": 0.2, "train": 0.8, "val": 0.1, "test": 0.1,
    },
    "seed": 123456789,
}
INTERVALS = {
    "rec1": [(2.0, 3.0, 1500.0), (22.0, 23.5, 1500.0), (40.0, 41.0, 6000.0)],
    "rec2": [(5.0, 6.0, 1500.0), (30.0, 31.0, 6000.0), (55.0, 56.5, 6000.0)],
}
SNIPPET_FILES = ["all_snippets.csv.gz", "failed_snippets.csv", "train.csv.gz", "val.csv.gz",
                 "test.csv.gz", "test_unfiltered.csv.gz", "all_snippet_stats_duration.csv",
                 "selected_snippet_stats_duration.csv"]
SPLITS = ["train", "val", "test", "test_unfiltered"]


def _synth_wav(path: Path, duration_s: float, tone_intervals, seed=0):
    """Tones over white noise at 0.02 rms. (tests/test_pipeline_e2e.py uses
    0.005: there the 1 % clip lands at -77.6 dB, where float32 DFT error
    puts the JAX package itself 2.1e-4 from the float64 spectrogram.)"""
    rng = np.random.default_rng(seed)
    n = int(duration_s * SR)
    t = np.arange(n) / SR
    x = 0.02 * rng.normal(size=n)
    for start, stop, freq in tone_intervals:
        seg = (t >= start) & (t < stop)
        x[seg] += 0.4 * np.sin(2 * np.pi * freq * t[seg])
    write_wav(path, SR, x.astype(np.float32))


def _text(path: Path) -> str:
    data = path.read_bytes()
    return (gzip.decompress(data) if path.suffix == ".gz" else data).decode()


def _jax_chain(table, data_dir, tvt_dir, param):
    jax_spectrogram.create_spectrograms(table, data_dir, orcai_parameter=param, msgr=QUIET,
                                        verbosity=0)
    jax_labels.create_label_arrays(table, data_dir, orcai_parameter=param, msgr=QUIET,
                                   verbosity=0)
    jax_snippets.create_snippet_table(table, data_dir, output_dir=tvt_dir,
                                      orcai_parameter=param, msgr=QUIET, verbosity=0)
    jax_snippets.create_tvt_snippet_tables(tvt_dir, orcai_parameter=param,
                                           create_unfiltered_test_snippets=True,
                                           msgr=QUIET, verbosity=0)
    jax_snippets.create_tvt_data(tvt_dir, orcai_parameter=param, msgr=QUIET, verbosity=0)


def _port_tables(table, data_dir, tvt_dir, param):
    snippets.create_snippet_table(table, data_dir, output_dir=tvt_dir, orcai_parameter=param)
    snippets.create_tvt_snippet_tables(tvt_dir, orcai_parameter=param,
                                       create_unfiltered_test_snippets=True)
    snippets.create_tvt_data(tvt_dir, orcai_parameter=param)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Both chains over one project: the JAX package's in jax/, the port's
    spectrograms and labels in port/, and the port's snippet and TVT steps
    on the JAX package's data directory in port_tvt/ (same recording paths,
    so the tables can be compared as text)."""
    root = tmp_path_factory.mktemp("data_prep")
    wav_dir = root / "recordings"
    wav_dir.mkdir()
    for i, (name, ivs) in enumerate(INTERVALS.items()):
        _synth_wav(wav_dir / f"{name}.wav", 70.0, ivs, seed=i)
        rows = [f"{s:.4f}\t{e:.4f}\t{'CALL_A' if f < 3000 else 'CALL_B'}" for s, e, f in ivs]
        (wav_dir / f"{name}.txt").write_text("\n".join(rows) + "\n")
    param = root / "param.json"
    param.write_text(json.dumps(PARAM))
    table = root / "recording_table.csv"
    helpers.create_recording_table(wav_dir, output_path=table, orcai_parameter=param)
    frame = pd.read_csv(table)
    for call in CALLS:
        frame[call] = True
    frame.to_csv(table, index=False)

    jax_data, port_data = root / "jax" / "data", root / "port" / "data"
    _jax_chain(table, jax_data, root / "jax" / "tvt", param)
    report = spectrogram.create_spectrograms(table, port_data, orcai_parameter=param,
                                             device="cpu")
    labels.create_label_arrays(table, port_data, orcai_parameter=param)
    _port_tables(table, jax_data, root / "port_tvt", param)
    return {"root": root, "wav_dir": wav_dir, "param": param, "table": table,
            "jax_data": jax_data, "port_data": port_data, "jax_tvt": root / "jax" / "tvt",
            "port_tvt": root / "port_tvt", "report": report}


# ------------------------------------------------------------ recording table


def _table_case(root: Path, case: str) -> dict:
    """A recording folder for one create_recording_table case, and its kwargs."""
    rec = root / "rec"
    for rel in ("a.wav", "sub/c.wav", "b/d.wav", "skipme/e.wav", "z.wav"):
        (rec / rel).parent.mkdir(parents=True, exist_ok=True)
        write_wav(rec / rel, SR, np.zeros(16, np.float32))
    for rel in ("a.txt", "sub/c.txt", "orphan.txt", "skipme/e.txt"):
        (rec / rel).write_text("1.0\t2.0\tCALL_A\n")
    (root / "param.json").write_text(json.dumps(PARAM))
    kwargs = {"orcai_parameter": root / "param.json"}
    if case == "duplicates":
        write_wav(rec / "b" / "a.wav", SR, np.zeros(16, np.float32))
        (rec / "b" / "c.txt").write_text("3.0\t4.0\tCALL_B\n")
    elif case == "remove_duplicates":
        write_wav(rec / "b" / "a.wav", SR, np.zeros(16, np.float32))
        kwargs["remove_duplicate_filenames"] = True
    elif case == "exclude":
        (root / "exclude.json").write_text(json.dumps(["skipme", "z."]))
        kwargs["exclude_patterns"] = root / "exclude.json"
    elif case == "no_parameter":
        kwargs = {}
    elif case.startswith("update"):
        # a previous table the user edited: call columns filled, a column of
        # notes, one recording gone from the folder and one not yet listed
        prev = pd.DataFrame({
            "recording": ["a", "c", "gone", "z"], "channel": [1, 2, 1, 1],
            "duplicate": [False] * 4,
            "base_dir_recording": ["/old"] * 4,
            "rel_recording_path": ["a.wav", "sub/c.wav", "gone.wav", "z.wav"],
            "base_dir_annotation": ["/old", "/old", None, None],
            "rel_annotation_path": ["a.txt", "sub/c.txt", None, None],
            "CALL_A": [True, False, True, None], "CALL_B": [1, 0, None, 1],
            "notes": ["x", None, "y", "w"], "count": [3, 4, 5, 6],
        })
        prev.to_csv(root / "previous.csv", index=False)
        kwargs["update_table"] = root / "previous.csv"
        kwargs["update_paths"] = case == "update"
    return {"rec": rec, "kwargs": kwargs}


@pytest.mark.parametrize("case", ["plain", "duplicates", "remove_duplicates", "exclude",
                                  "no_parameter", "update", "update_keep_paths"])
def test_recording_table_text_equal(tmp_path, case):
    setup = _table_case(tmp_path, case)
    jax_helpers.create_recording_table(setup["rec"], output_path=tmp_path / "jax.csv",
                                       msgr=QUIET, **setup["kwargs"])
    helpers.create_recording_table(setup["rec"], output_path=tmp_path / "port.csv",
                                   **setup["kwargs"])
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_recording_table_refuses_to_overwrite(tmp_path):
    setup = _table_case(tmp_path, "plain")
    (tmp_path / "exists.csv").write_text("x\n")
    with pytest.raises(SystemExit):
        helpers.create_recording_table(setup["rec"], output_path=tmp_path / "exists.csv")


@pytest.mark.parametrize("overrides", [None, {"model": {"epochs": 3}, "bogus": 1, "seed": 7}])
def test_init_stages_the_same_files(tmp_path, overrides):
    jax_helpers.init_project(tmp_path / "jax", "proj", msgr=QUIET, parameter=overrides)
    helpers.init_project(tmp_path / "port", "proj", parameter=overrides)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names and len(names) == 3
    for name in names:
        a = json.loads((tmp_path / "jax" / name).read_text())
        b = json.loads((tmp_path / "port" / name).read_text())
        if "orcai_parameter" in name and not overrides:
            # a fresh 128-bit master seed in each
            assert b["seed"].bit_length() > 64 and a["seed"] != b["seed"]
            a.pop("seed"), b.pop("seed")
        assert a == b, name


def test_synthetic_project_equals_the_jax_package(tmp_path):
    jax_table = jax_synthetic.make_synthetic_project(tmp_path / "jax", 2, 30.0, seed=3)
    port_table = synthetic.make_synthetic_project(tmp_path / "port", 2, 30.0, seed=3)
    assert port_table.read_text().replace(str(tmp_path / "port"), "R") == \
        jax_table.read_text().replace(str(tmp_path / "jax"), "R")
    for name in ("synth000", "synth001"):
        assert ((tmp_path / "port" / "recordings" / f"{name}.wav").read_bytes()
                == (tmp_path / "jax" / "recordings" / f"{name}.wav").read_bytes())
        assert ((tmp_path / "port" / "recordings" / f"{name}.txt").read_text()
                == (tmp_path / "jax" / "recordings" / f"{name}.txt").read_text())


# ---------------------------------------------------------------- spectrograms


@pytest.mark.parametrize("rec", ["rec1", "rec2"])
def test_spectrogram_stores_within_the_frontend_bar(project, rec):
    a = jax_open_zarr(project["jax_data"] / rec / "spectrogram" / "spectrogram.zarr")[:]
    b = open_zarr(project["port_data"] / rec / "spectrogram" / "spectrogram.zarr")[:]
    assert b.shape == a.shape == (1 + 70 * SR // 256, 171) and b.dtype == np.float32
    assert float(np.abs(a - b).max()) <= SPEC_ATOL
    for name in ("times.json", "frequencies.json"):
        assert ((project["port_data"] / rec / "spectrogram" / name).read_text()
                == (project["jax_data"] / rec / "spectrogram" / name).read_text())


def test_make_spectrogram_matches_the_jax_package(project):
    ours = spectrogram.make_spectrogram(project["wav_dir"] / "rec2.wav",
                                        orcai_parameter=project["param"], device="cpu")
    theirs = jax_spectrogram.make_spectrogram(project["wav_dir"] / "rec2.wav",
                                              orcai_parameter=project["param"], msgr=QUIET)
    assert ours[0].shape == theirs[0].shape
    assert float(np.abs(ours[0] - theirs[0]).max()) <= SPEC_ATOL
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(ours[2], theirs[2])


def test_spectrogram_report(project):
    report = project["report"]
    assert report["engine"] == "device" and report["n_recordings"] == 2
    assert report["codec"] == "blosc-lz4" and report["bytes_written"] > 0
    assert all(report[k] >= 0 for k in ("load_s", "frontend_s", "fetch_s", "write_s"))


def test_existing_spectrograms_are_skipped(project, tmp_path):
    out = tmp_path / "data"
    shutil.copytree(project["port_data"] / "rec1", out / "rec1")
    report = spectrogram.create_spectrograms(project["table"], out,
                                             orcai_parameter=project["param"], device="cpu")
    assert report["n_recordings"] == 1 and (out / "rec2" / "spectrogram").is_dir()


def test_host_engine_equals_the_reference_host_engine(project, monkeypatch, tmp_path):
    audio = spectrogram.load_recording_audio(project["wav_dir"] / "rec1.wav", SR)
    sp = PARAM["spectrogram"]
    args = (SR, sp["nfft"], sp["n_overlap"], sp["freq_range"], sp["quantiles"])
    for a, b in zip(compute_spectrogram_host(audio, *args), jax_host_frontend(audio, *args)):
        np.testing.assert_array_equal(a, b)
    report = spectrogram.create_spectrograms(project["table"], tmp_path,
                                             orcai_parameter=project["param"], engine="host")
    assert report["engine"] == "host"
    stored = open_zarr(tmp_path / "rec1" / "spectrogram" / "spectrogram.zarr")[:]
    np.testing.assert_array_equal(stored, compute_spectrogram_host(audio, *args)[0])
    # the reference's engine variable does not move a run off the card
    monkeypatch.setenv("ORCAI_TPU_SPEC_ENGINE", "host")
    assert spectrogram.resolve_spectrogram_engine() == "device"
    with pytest.raises(ValueError, match="unknown spectrogram engine"):
        spectrogram.resolve_spectrogram_engine("fast")


def test_device_engine_needs_cuda_unless_told(project, tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a host without CUDA")
    monkeypatch.setenv("ORCAI_TPU_SPEC_ENGINE", "host")  # read by the reference only
    with pytest.raises(RuntimeError, match="cuda"):
        spectrogram.create_spectrograms(project["table"], tmp_path,
                                        orcai_parameter=project["param"])
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["create-spectrograms", str(project["table"]), str(tmp_path / "cli"),
                   "-p", str(project["param"])])
    assert not (tmp_path / "rec1").exists()


def test_a_table_that_filters_to_no_row_writes_nothing(project, tmp_path):
    frame = pd.read_csv(project["table"])
    frame["CALL_A"], frame["CALL_B"] = False, False
    frame.to_csv(tmp_path / "table.csv", index=False)
    report = spectrogram.create_spectrograms(tmp_path / "table.csv", tmp_path / "data",
                                             orcai_parameter=project["param"], device="cpu")
    assert report["n_recordings"] == 0 and not (tmp_path / "data").exists()


def test_coded_wires_are_refused(project, tmp_path):
    """A wire that is no codec is refused before any recording is read;
    the coded wires themselves are taken (the next test)."""
    with pytest.raises(ValueError, match="unknown wire codec"):
        spectrogram.create_spectrograms(project["table"], tmp_path,
                                        orcai_parameter=project["param"], device="cpu",
                                        wire="gzip")
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("wire", ["mulaw8", "sp-bfp5"])
def test_create_spectrograms_on_a_coded_wire(project, tmp_path, wire):
    """Each stored spectrogram of a coded wire is the frontend's on that
    wire, and its frequency vector the native one, as on the exact wire."""
    from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device

    data = tmp_path / "data"
    report = spectrogram.create_spectrograms(project["table"], data,
                                             orcai_parameter=project["param"], device="cpu",
                                             wire=wire)
    recs = sorted(p.name for p in data.iterdir())
    assert report["n_recordings"] == len(recs) > 0
    sp = PARAM["spectrogram"]
    for rec in recs:
        audio = spectrogram.load_recording_audio(project["wav_dir"] / f"{rec}.wav",
                                                 sp["sampling_rate"])
        want, n, _, _ = make_spectrogram_from_params_device(audio, sp, device="cpu", wire=wire)
        out = data / rec / "spectrogram"
        np.testing.assert_array_equal(open_zarr(out / "spectrogram.zarr")[:], want[:n].numpy())
        assert ((out / "frequencies.json").read_bytes()
                == (project["port_data"] / rec / "spectrogram" / "frequencies.json").read_bytes())


def test_a_dead_writer_with_a_full_queue_raises(project, monkeypatch, tmp_path):
    """Six recordings; the writer blocks until the queue is full, then dies.
    The run must raise the writer's error, not wait for ever."""
    frame = pd.read_csv(project["table"])
    frame = pd.concat([frame.assign(recording=[f"{r}_{i}" for r in frame["recording"]])
                       for i in range(3)], ignore_index=True)
    table = tmp_path / "table.csv"
    frame.to_csv(table, index=False)
    started = threading.Event()

    def dying_save(*args, **kwargs):
        started.set()
        import time

        time.sleep(1.0)  # the main thread fills the queue meanwhile
        raise OSError("disk full")

    monkeypatch.setattr(spectrogram, "save_spectrogram", dying_save)

    def hung(signum, frame):
        raise TimeoutError("create_spectrograms hung after the writer died")

    old = signal.signal(signal.SIGALRM, hung)
    signal.alarm(120)
    try:
        with pytest.raises(OSError, match="disk full"):
            spectrogram.create_spectrograms(table, tmp_path / "data",
                                            orcai_parameter=project["param"], device="cpu")
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    assert started.is_set()


# ---------------------------------------------------------------------- labels


@pytest.mark.parametrize("rec", ["rec1", "rec2"])
def test_label_arrays_bit_equal(project, rec):
    a = jax_open_zarr(project["jax_data"] / rec / "labels" / "labels.zarr")[:]
    b = open_zarr(project["port_data"] / rec / "labels" / "labels.zarr")[:]
    assert b.shape == (1 + 70 * SR // 256, 2) and b.sum() > 0
    np.testing.assert_array_equal(a, b)
    assert ((project["port_data"] / rec / "labels" / "label_list.json").read_text()
            == (project["jax_data"] / rec / "labels" / "label_list.json").read_text())


def test_call_equivalences_and_masked_calls(project, tmp_path):
    frame = pd.read_csv(project["table"])
    frame["CALL_B"] = [False, True]
    frame.to_csv(tmp_path / "table.csv", index=False)
    eq = tmp_path / "eq.json"
    eq.write_text(json.dumps({"CALL_A": "CALL_B", "CALL_B": "CALL_A"}))
    for name, run in (("jax", lambda t, d: jax_labels.create_label_arrays(
            t, d, orcai_parameter=project["param"], call_equivalences=eq, msgr=QUIET,
            verbosity=0)),
            ("port", lambda t, d: labels.create_label_arrays(
                t, d, orcai_parameter=project["param"], call_equivalences=eq))):
        data = tmp_path / name
        for rec in ("rec1", "rec2"):
            shutil.copytree(project["jax_data"] / rec / "spectrogram", data / rec / "spectrogram")
        run(tmp_path / "table.csv", data)
    for rec in ("rec1", "rec2"):
        a = jax_open_zarr(tmp_path / "jax" / rec / "labels" / "labels.zarr")[:]
        b = open_zarr(tmp_path / "port" / rec / "labels" / "labels.zarr")[:]
        np.testing.assert_array_equal(a, b)
    assert (open_zarr(tmp_path / "port" / "rec1" / "labels" / "labels.zarr")[:, 1] == -1).all()


def test_blank_cells_take_the_same_way_through_both(project, tmp_path):
    """Blank call cells: create_spectrograms drops a row whose cells are all
    blank, create_label_arrays counts blank as possible."""
    frame = pd.read_csv(project["table"])
    frame["CALL_A"] = [None, None]
    frame["CALL_B"] = [None, True]
    frame.to_csv(tmp_path / "table.csv", index=False)
    for name in ("jax", "port"):
        data = tmp_path / name
        if name == "jax":
            jax_spectrogram.create_spectrograms(tmp_path / "table.csv", data,
                                                orcai_parameter=project["param"],
                                                msgr=QUIET, verbosity=0)
        else:
            spectrogram.create_spectrograms(tmp_path / "table.csv", data,
                                            orcai_parameter=project["param"], device="cpu")
        # rec1's cells are all blank: no spectrogram
        assert sorted(p.name for p in data.iterdir()) == ["rec2"]
        for rec in ("rec1",):
            shutil.copytree(project["jax_data"] / rec / "spectrogram", data / rec / "spectrogram")
        if name == "jax":
            jax_labels.create_label_arrays(tmp_path / "table.csv", data,
                                           orcai_parameter=project["param"], msgr=QUIET,
                                           verbosity=0)
        else:
            labels.create_label_arrays(tmp_path / "table.csv", data,
                                       orcai_parameter=project["param"])
    for rec in ("rec1", "rec2"):
        a = jax_open_zarr(tmp_path / "jax" / rec / "labels" / "labels.zarr")[:]
        b = open_zarr(tmp_path / "port" / rec / "labels" / "labels.zarr")[:]
        np.testing.assert_array_equal(a, b)
        assert b[:, 0].max() == 1  # blank CALL_A counts as possible


# -------------------------------------------------------------- snippet tables


@pytest.mark.parametrize("name", SNIPPET_FILES)
def test_snippet_tables_text_equal(project, name):
    text = _text(project["port_tvt"] / name)
    assert text == _text(project["jax_tvt"] / name)
    assert len(text.splitlines()) >= 1


def test_split_sizes(project):
    for split, n in (("train", 16), ("val", 8), ("test", 8)):
        assert len(_text(project["port_tvt"] / f"{split}.csv.gz").splitlines()) == n + 1


def test_compute_snippet_stats_matches_pandas(project):
    table = Table.read_csv(project["port_tvt"] / "all_snippets.csv.gz")
    frame = pd.read_csv(project["port_tvt"] / "all_snippets.csv.gz")
    ours = snippets.compute_snippet_stats(table, CALLS)
    theirs = jax_snippets.compute_snippet_stats(frame, CALLS)
    for col in theirs.columns:
        np.testing.assert_array_equal(ours[col], theirs[col].to_numpy(), err_msg=col)


def test_a_split_without_rows_fails_as_in_the_reference(project):
    frame = pd.read_csv(project["port_tvt"] / "all_snippets.csv.gz")
    frame = frame[frame["data_type"] != "val"]
    with pytest.raises(ValueError):
        jax_snippets.create_tvt_snippet_tables(project["root"] / "x_jax", frame,
                                               orcai_parameter=project["param"], msgr=QUIET)
    table = Table.read_csv(project["port_tvt"] / "all_snippets.csv.gz")
    table = table.take(table["data_type"] != "val")
    with pytest.raises(ValueError):
        snippets.create_tvt_snippet_tables(project["root"] / "x_port", table,
                                           orcai_parameter=project["param"])


def test_drop_duplicates_keeps_the_first_copy():
    table = Table(None, {"a": np.array([1, 1, 2, 1]), "b": np.array([np.nan, np.nan, 1.0, 2.0])})
    kept = snippets._drop_duplicates(table)
    frame = pd.DataFrame(table.columns).drop_duplicates()
    np.testing.assert_array_equal(kept["a"], frame["a"].to_numpy())
    np.testing.assert_array_equal(kept["b"], frame["b"].to_numpy())


# ------------------------------------------------------------------ TVT data


@pytest.mark.parametrize("split", SPLITS)
def test_tvt_datasets_bit_equal(project, split):
    a = JaxArrayDataset.load(project["jax_tvt"] / f"{split}_dataset")
    b = ArrayDataset.load(project["port_tvt"] / f"{split}_dataset")
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(np.asarray(a.y), np.asarray(b.y))
    assert ((project["port_tvt"] / f"{split}_dataset" / "meta.json").read_text()
            == (project["jax_tvt"] / f"{split}_dataset" / "meta.json").read_text())


@pytest.mark.parametrize("name", ["dataset_shapes.json", "call_weights.json"])
def test_tvt_jsons_text_equal(project, name):
    assert (project["port_tvt"] / name).read_text() == (project["jax_tvt"] / name).read_text()


@pytest.mark.parametrize("method", ["balanced", "max", "uniform"])
def test_call_weights(project, method):
    rng = lambda: np.random.default_rng([3, PARAM["seed"]])  # noqa: E731
    ours = snippets.get_call_weights(
        SnippetDataLoader.from_csv(project["port_tvt"] / "train.csv.gz", 4, rng=rng()),
        CALLS, method)
    theirs = jax_snippets.get_call_weights(
        JaxLoader.from_csv(project["jax_tvt"] / "train.csv.gz", 4, rng=rng()), CALLS, method)
    assert json.dumps(ours, default=float) == json.dumps(theirs, default=float)


def test_snippet_loader_order_and_items(project):
    ours = SnippetDataLoader.from_csv(project["port_tvt"] / "val.csv.gz", 4,
                                      rng=np.random.default_rng(9))
    theirs = JaxLoader.from_csv(project["jax_tvt"] / "val.csv.gz", 4,
                                rng=np.random.default_rng(9))
    assert len(ours) == len(theirs) == 8
    for i in range(len(ours)):
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the whole slice


def test_the_slice_as_a_whole_and_one_epoch_of_train(project):
    """The port's own chain (its spectrograms and labels): TVT labels
    bit-equal to the JAX package's, spectrogram snippets within 2e-4, and
    the port's train takes one epoch on them."""
    import torch

    from orcai_tpu_torch.train.trainer import train

    tvt = project["root"] / "port_own_tvt"
    _port_tables(project["table"], project["port_data"], tvt, project["param"])
    for split in SPLITS:
        a = JaxArrayDataset.load(project["jax_tvt"] / f"{split}_dataset")
        b = ArrayDataset.load(tvt / f"{split}_dataset")
        np.testing.assert_array_equal(np.asarray(a.y), np.asarray(b.y))
        assert float(np.abs(np.asarray(a.x) - np.asarray(b.x)).max()) <= SPEC_ATOL
    # oneDNN's CPU convolution backward corrupts the heap at these widths
    # (filters 4/6/8/10, 171 bins, batch 4) in torch 2.13+cpu: ROADMAP.md C
    with torch.backends.mkldnn.flags(enabled=False):
        train(tvt, project["root"] / "models", orcai_parameter=project["param"], device="cpu")
    history = json.loads(
        (project["root"] / "models" / PARAM["name"] / "training_history.json").read_text())
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"][0])


def test_cli_runs_each_data_prep_command(project, tmp_path):
    root = tmp_path
    shutil.copytree(project["wav_dir"], root / "rec")
    param = str(project["param"])
    assert port_main(["init", str(root / "proj"), "cliproj", "-v", "0"]) == 0
    assert (root / "proj" / "cliproj_orcai_parameter.json").exists()
    assert port_main(["create-recording-table", str(root / "rec"), "-p", param,
                      "-o", str(root / "table.csv"), "-v", "0"]) == 0
    frame = pd.read_csv(root / "table.csv")
    for call in CALLS:
        frame[call] = True
    frame.to_csv(root / "table.csv", index=False)
    steps = [
        ["create-spectrograms", str(root / "table.csv"), str(root / "data"), "-p", param,
         "--device", "cpu"],
        ["create-label-arrays", str(root / "table.csv"), str(root / "data"), "-p", param],
        ["create-snippet-table", str(root / "table.csv"), str(root / "data"), "-p", param,
         "-o", str(root / "tvt")],
        ["create-tvt-snippet-tables", str(root / "tvt"), "-p", param, "-uts"],
        ["create-tvt-data", str(root / "tvt"), "-p", param, "-dc", "gzip"],
    ]
    for argv in steps:
        assert port_main(argv + ["-v", "0"]) == 0, argv
    meta = json.loads((root / "tvt" / "train_dataset" / "meta.json").read_text())
    assert meta["n"] == 16 and meta["compression"] == "GZIP"
    for split in SPLITS:
        np.testing.assert_array_equal(
            np.asarray(ArrayDataset.load(root / "tvt" / f"{split}_dataset").y),
            np.asarray(JaxArrayDataset.load(project["jax_tvt"] / f"{split}_dataset").y))
