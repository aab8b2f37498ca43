"""The port's console report (orcai_tpu_torch/utils/messenger.py) against
the JAX package's Messenger on the CPU.

The same commands through both command lines: `predict` on golden,
`create-recording-table` and `create-tvt-data` on a synthetic project (two
70 s recordings), one epoch of a narrow `train --load_model` from the same
weights and `test` on the model the JAX package trained. Their stdout is held line for line. Masked, each by name in
MASKS: the times ([started @ ...], a section's [H:MM:SS, 𝚫 H:MM:SS], an
epoch's [s]) and the lines that describe the runtime, which is another by
design (platform, framework version, backend and devices, the process's
resident memory, and the clause after the resident datasets' size). A
number the two frameworks compute in float32 (a loss, a table's ratios)
is held at the trainer's parity bar, rtol 1e-5, or at one unit of its last
printed digit; every other character is held exactly.

Beside them: the levels, marks and indentation of each method, ANSI styles
only on a terminal, humanize's decimal sizes, and the two pandas layouts
the reports print (a DataFrame, and a groupby size) against pandas.
"""

import contextlib
import io
import json
import re
import shutil

import humanize
import numpy as np
import pandas as pd
import pytest
import click
import torch
from click.testing import CliRunner

from orcai_tpu.cli import cli as jax_cli
from orcai_tpu.utils.messenger import Messenger as JaxMessenger
from orcai_tpu_torch.__main__ import main as port_main
from orcai_tpu_torch.io.model_store import save_orcai_model
from orcai_tpu_torch.io.tables import Counts, Table, object_column
from orcai_tpu_torch.io.wav import write_wav
from orcai_tpu_torch.pipeline import labels, snippets, spectrogram
from orcai_tpu_torch.models import build_model, init_variables
from orcai_tpu_torch.utils.messenger import Messenger, naturalsize

GOLDEN = "tests/fixtures/golden.wav"
SR = 48000
CALLS = ["CALL_A", "CALL_B"]
INTERVALS = {  # tests/test_torch_data_prep.py's project
    "rec1": [(2.0, 3.0, 1500.0), (22.0, 23.5, 1500.0), (40.0, 41.0, 6000.0)],
    "rec2": [(5.0, 6.0, 1500.0), (30.0, 31.0, 6000.0), (55.0, 56.5, 6000.0)],
}
PARAM = {  # narrow, dropout 0: the two packages draw different masks
    "name": "messenger-test",
    "architecture": "ResNetLSTM",
    "model": {
        "epochs": 1, "batch_size": 4, "filters": [2, 3, 4, 5], "kernel_size": 3,
        "dropout_rate": 0.0, "lstm_units": 4, "n_batch_train": 4, "n_batch_val": 2,
        "n_batch_test": 2, "learning_rate": 1e-4, "EarlyStopping_patience": 10,
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
RTOL = 1e-5  # tests/test_torch_trainer.py's step-metrics bar
TIME = r"\d+:\d\d:\d\d"
# (name, pattern, replacement): what is masked before two lines are compared
MASKS = [
    ("start time", r"\[started @ [^\]]*\]", "[started @ <time>]"),
    ("section times", rf"\[{TIME}(, 𝚫 {TIME})?\]$", "[<times>]"),
    ("epoch time", r"^(\s*epoch \d+/\d+ )\[[0-9.]+s\]", r"\1[<s>]"),
    ("platform", r"^(\s*)Platform: .*", r"\1<platform>"),
    ("python version", r"^(\s*)Python version: .*", r"\1<python>"),
    ("framework version", r"^(\s*)(JAX|PyTorch) version: .*", r"\1<framework>"),
    ("backend and devices", r"^(\s*)(JAX|PyTorch) backend: .*", r"\1<devices>"),
    ("resident memory", r"^(\s*)memory usage: .*", r"\1<memory>"),
    ("dataset residency", r"^(\s*Datasets HBM-resident \([0-9.]+ GB\)): .*", r"\1: <runtime>"),
]
# a line only one package prints: JAX's predictor splits its windows over
# the test session's 8 virtual CPU devices, the port's runs on one
DROPPED = [("window split over the devices", r"^\s*Sharding inference windows over \d+ devices$")]
NUMBER = re.compile(r"-?\d+\.\d+(?:e[+-]\d+)?|-?\d+")


def setup_module():
    torch.set_num_threads(1)


def _masked(line: str) -> str:
    for _, pattern, replacement in MASKS:
        line = re.sub(pattern, replacement, line)
    return line


def _lines(text: str) -> list[str]:
    return [line for line in text.splitlines()
            if not any(re.match(pattern, line) for _, pattern in DROPPED)]


def _synth_wav(path, duration_s: float, tone_intervals, seed: int):
    """Tones over white noise at 0.02 rms (tests/test_torch_data_prep.py's)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * SR)) / SR
    x = 0.02 * rng.normal(size=t.size)
    for start, stop, freq in tone_intervals:
        seg = (t >= start) & (t < stop)
        x[seg] += 0.4 * np.sin(2 * np.pi * freq * t[seg])
    write_wav(path, SR, x.astype(np.float32))


def _assert_same_report(got: str, want: str):
    got_lines, want_lines = _lines(got), _lines(want)
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(map(_masked, got_lines), map(_masked, want_lines)):
        assert NUMBER.split(g) == NUMBER.split(w), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            last = 10.0 ** -len(b.split("e")[0].split(".")[1]) if "." in b else 0.0
            # (one unit of the last digit, and the float's own rounding of it)
            bar = max(RTOL * abs(float(b)), last) * (1 + 1e-9)
            assert abs(float(a) - float(b)) <= bar, (g, w)


def _jax(args: list[str]) -> str:
    result = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result.stdout


def _port(args: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(args) == 0
    return out.getvalue()


# ---------------------------------------------------------------- commands


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """{command: (port stdout, JAX stdout)} for the five commands."""
    root = tmp_path_factory.mktemp("messenger")
    wav_dir = root / "recordings"
    wav_dir.mkdir()
    for i, (name, ivs) in enumerate(INTERVALS.items()):
        _synth_wav(wav_dir / f"{name}.wav", 70.0, ivs, seed=i)
        rows = [f"{s:.4f}\t{e:.4f}\t{'CALL_A' if f < 3000 else 'CALL_B'}" for s, e, f in ivs]
        (wav_dir / f"{name}.txt").write_text("\n".join(rows) + "\n")
    param = root / "param.json"
    param.write_text(json.dumps(PARAM))
    out = {}

    table = root / "recording_table.csv"
    args = ["create-recording-table", str(wav_dir), "-o", str(table), "-p", str(param)]
    want = _jax(args)
    table.unlink()
    out["create-recording-table"] = (_port(args), want)

    # the chain up to the TVT snippet tables, once, quietly
    quiet = Messenger(verbosity=0)
    frame = pd.read_csv(table)
    for call in CALLS:
        frame[call] = True
    frame.to_csv(table, index=False)
    spectrogram.create_spectrograms(table, root / "data", orcai_parameter=param, device="cpu",
                                    msgr=quiet)
    labels.create_label_arrays(table, root / "data", orcai_parameter=param, msgr=quiet)
    snippets.create_snippet_table(table, root / "data", output_dir=root / "tvt",
                                  orcai_parameter=param, msgr=quiet)
    snippets.create_tvt_snippet_tables(root / "tvt", orcai_parameter=param, msgr=quiet)
    shutil.copytree(root / "tvt", root / "tvt_jax")
    want = _jax(["create-tvt-data", str(root / "tvt_jax"), "-p", str(param)])
    got = _port(["create-tvt-data", str(root / "tvt"), "-p", str(param)])
    out["create-tvt-data"] = (got, want)

    # one epoch on from the same weights (the packages initialise differently)
    start = init_variables(build_model(PARAM, (736, 171, 1)), seed=3)
    for name in ("jax", "port"):
        save_orcai_model(root / f"models_{name}" / PARAM["name"], PARAM, start.state_dict(),
                         input_shape=(736, 171, 1))
    with torch.backends.mkldnn.flags(enabled=False):  # ROADMAP C: oneDNN at small widths
        want = _jax(["train", str(root / "tvt"), str(root / "models_jax"), "-p", str(param),
                     "-lm"])
        got = _port(["train", str(root / "tvt"), str(root / "models_port"), "-p", str(param),
                     "-lm", "--device", "cpu"])
        out["train"] = (got, want)
        model_dir = root / "models_jax" / PARAM["name"]
        want = _jax(["test", str(model_dir), str(root / "tvt")])
        got = _port(["test", str(model_dir), str(root / "tvt"), "--device", "cpu"])
        out["test"] = (got, want)

    predicted = root / "golden_predicted.txt"
    want = _jax(["predict", GOLDEN, "-o", str(predicted)])
    predicted.unlink()
    out["predict"] = (_port(["predict", GOLDEN, "-o", str(predicted), "--device", "cpu"]), want)
    return out


@pytest.mark.parametrize("command", ["predict", "create-recording-table", "create-tvt-data",
                                     "train", "test"])
def test_a_command_prints_the_jax_package_s_report(reports, command):
    got, want = reports[command]
    assert "🐳" in want and "[started @" in want
    _assert_same_report(got, want)


def test_the_reports_carry_the_sizes_and_the_runtime_lines(reports):
    tvt = reports["create-tvt-data"][0]
    assert re.search(r"^    Size on disk of train_dataset: [0-9.]+ [kM]B$", tvt, re.M)
    train = reports["train"][0]
    assert re.search(r"^    PyTorch backend: ", train, re.M)
    assert re.search(r"^    memory usage: [0-9.]+ [kMG]B$", train, re.M)
    assert train.index("Trainable parameter") < train.index("memory usage")


def test_the_masks_leave_a_wrong_line_visible():
    want = "🐳 Loading model: orcai-v1 [0:00:01]\n    found 16 acoustic signals"
    _assert_same_report("🐳 Loading model: orcai-v1 [0:00:09]\n    found 16 acoustic signals",
                        want)
    for wrong in ("🐳 Loading model: orcai-v2 [0:00:01]\n    found 16 acoustic signals",
                  "🐳 Loading model: orcai-v1 [0:00:01]\n        found 16 acoustic signals",
                  "🐳 Loading model: orcai-v1 [0:00:01]\n    found 17 acoustic signals",
                  "🐳 Loading model: orcai-v1 [0:00:01]"):
        with pytest.raises(AssertionError):
            _assert_same_report(wrong, want)


# ---------------------------------------------------------------- the class


def _both(calls, verbosity=2):
    """stdout of the same method calls on both packages' Messengers."""
    texts = []
    for cls in (Messenger, JaxMessenger):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            msgr = cls(verbosity=verbosity, show_part_times=False)
            for name, args, kwargs in calls:
                getattr(msgr, name)(*args, **kwargs)
        texts.append(out.getvalue())
    return texts


CALLS_ = [
    ("part", ("Loading",), {}),
    ("info", ("Data shape:",), {"indent": 1}),
    ("info", ("(736, 171, 1)",), {}),
    ("info", ({"a": np.float32(0.5), "b": [1, 2]},), {"indent": -1}),
    ("warning", ("careful",), {}),
    ("error", ("failed",), {}),
    ("debug", ("details",), {}),
    ("info", (["x", "y"],), {"set_indent": 2}),
    ("warning", ({"k": 1},), {}),
    ("success", ("Done.",), {}),
]


@pytest.mark.parametrize("verbosity", [0, 1, 2, 3])
def test_levels_marks_and_indentation_match_the_jax_messenger(verbosity):
    got, want = _both(CALLS_, verbosity)
    assert got == want


def test_styles_only_on_a_terminal():
    class Terminal(io.StringIO):
        def isatty(self):
            return True

    tty, pipe = Terminal(), io.StringIO()
    for stream in (tty, pipe):
        msgr = Messenger(file=stream, show_part_times=False)
        msgr.part("Loading")
        msgr.warning("careful")
        msgr.success("Done.")
    assert "\033" not in pipe.getvalue()
    assert tty.getvalue().splitlines() == [  # the JAX package's click.style codes
        click.style("🐳 Loading", bold=True), click.style("    ‼️ careful", fg="yellow"),
        click.style("🐳 Done.", fg="green", bold=True)]


@pytest.mark.parametrize("size", [0, 1, 2, 999, 1000, 1234, 999_999, 10**6, 8_060_000,
                                  123_456_789, 10**9 - 1, 10**12, 3 * 10**16, -4096])
def test_sizes_read_as_humanize_writes_them(size):
    assert naturalsize(size) == humanize.naturalsize(size, format="%.2f")


def test_tables_print_in_pandas_layout():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 6))
        columns = {}
        for j in range(int(rng.integers(1, 5))):
            kind = int(rng.integers(0, 5))
            if kind == 0:
                v = rng.uniform(-1, 1, n) * 10.0 ** int(rng.integers(-9, 9))
                v[rng.uniform(size=n) < 0.2] = np.nan
            elif kind == 1:
                v = rng.integers(-500, 5000, n)
            elif kind == 2:
                v = object_column([f"{k}:0{k % 6}:{k % 60:02d}" for k in rng.integers(0, 99, n)])
            elif kind == 3:
                v = rng.uniform(size=n) < 0.5
            else:
                v = rng.integers(0, 3, n) / 4.0
            columns["c" * int(rng.integers(1, 9)) + str(j)] = v
        index = [f"row{'x' * int(k)}" for k in rng.integers(0, 5, n)]
        name = None if rng.uniform() < 0.5 else "Label"
        frame = pd.DataFrame({k: list(v) if v.dtype == object else v
                              for k, v in columns.items()}, index=pd.Index(index, name=name))
        assert Table(index, columns, index_name=name).to_string() == frame.to_string()
    kinds = ["train"] * 12 + ["val"] * 2 + ["test"] * 3
    assert (Counts(Table(None, {"data_type": object_column(kinds)}), "data_type").to_string()
            == pd.DataFrame({"data_type": kinds}).groupby("data_type").size().to_string())


def test_device_and_memory_reports_on_the_cpu():
    out = io.StringIO()
    msgr = Messenger(file=out)
    msgr.print_device_info(set_indent=1)
    msgr.print_memory_usage()
    lines = out.getvalue().splitlines()
    assert lines[0] == "    PyTorch backend: cpu (no CUDA device)"
    assert re.fullmatch(r"    memory usage: [0-9.]+ [kMG]B", lines[1])


def test_a_directory_size_counts_every_file(tmp_path):
    (tmp_path / "d" / "e").mkdir(parents=True)
    (tmp_path / "d" / "a.bin").write_bytes(b"x" * 1500)
    (tmp_path / "d" / "e" / "b.bin").write_bytes(b"x" * 2500)
    write_wav(tmp_path / "d" / "w.wav", 48000, np.zeros(10, np.float32))
    for cls in (Messenger, JaxMessenger):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            msgr = cls(show_part_times=False)
            msgr.print_directory_size(tmp_path / "d")
            msgr.print_file_size(tmp_path / "d" / "a.bin")
        assert out.getvalue().splitlines() == [
            f"Size on disk of d: {humanize.naturalsize(4000 + (tmp_path / 'd' / 'w.wav').stat().st_size, format='%.2f')}",
            "Size on disk of a.bin: 1.50 kB"]
