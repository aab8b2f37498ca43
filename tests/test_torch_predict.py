"""Port predict end to end on the CPU (orcai_tpu_torch/pipeline/predict.py):
the golden TSV byte-equal in f32 and bf16 (tests/test_golden_predict.py),
the TSV writer against the reference's pandas writer, and the device and
dtype contracts."""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from orcai_tpu.pipeline.predict import (
    compute_labels as jax_compute_labels,
    save_predictions as jax_save_predictions,
)
from orcai_tpu_torch.__main__ import main as cli_main
from orcai_tpu_torch.pipeline import predict as tpredict
from orcai_tpu_torch.pipeline.predict import compute_labels, predict, save_predictions

FIXTURES = Path(__file__).parent / "fixtures"
GOLDEN = (FIXTURES / "golden_expected.txt").read_bytes()


def setup_module():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_golden_tsv_byte_equal(tmp_path, monkeypatch, dtype):
    monkeypatch.setenv("ORCAI_TPU_PREDICT_DTYPE", dtype)
    out = predict(
        FIXTURES / "golden.wav", output_path=tmp_path / "pred.txt",
        predict_batch_size=16, device="cpu",
    )
    assert out.read_bytes() == GOLDEN


def test_cli_default_output_name(tmp_path):
    wav = tmp_path / "rec.wav"
    wav.write_bytes((FIXTURES / "golden.wav").read_bytes())
    assert cli_main(["predict", str(wav), "--device", "cpu", "-bs", "32"]) == 0
    out = tmp_path / "rec_c1_orcai-v1_predicted.txt"
    assert out.read_bytes() == GOLDEN
    with pytest.raises(FileExistsError):
        cli_main(["predict", str(wav), "--device", "cpu"])


def test_invalid_predict_dtype_rejected(tmp_path, monkeypatch):
    monkeypatch.setenv("ORCAI_TPU_PREDICT_DTYPE", "fp8")
    with pytest.raises(ValueError, match="ORCAI_TPU_PREDICT_DTYPE"):
        predict(FIXTURES / "golden.wav", output_path=tmp_path / "x.txt", device="cpu")


def test_cuda_without_cuda_raises_and_runs_nothing(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")

    def no_work(*args, **kwargs):
        raise AssertionError("the frontend ran although CUDA is missing")

    monkeypatch.setattr(tpredict, "make_spectrogram_from_params_device", no_work)
    out = tmp_path / "x.txt"
    with pytest.raises(RuntimeError, match="cuda"):
        predict(FIXTURES / "golden.wav", output_path=out)
    assert not out.exists()


def test_predict_restores_tf32_flags(tmp_path, monkeypatch):
    """predict turns TF32 off for its own launches only, not for the process."""
    seen = []

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        raise RuntimeError("stop after the flags are read")

    monkeypatch.setattr(tpredict, "make_spectrogram_from_params_device", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="stop after"):
        predict(FIXTURES / "golden.wav", output_path=tmp_path / "x.txt", device="cpu")
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_non_wav_rejected(tmp_path):
    with pytest.raises(ValueError, match="wav or csv"):
        predict(tmp_path / "table.txt", device="cpu")


def test_tsv_writer_matches_pandas_writer(tmp_path):
    """compute_labels + save_predictions vs the reference's pandas pair on
    random run tables: same sort order, rounding and float text."""
    rng = np.random.default_rng(0)
    names = ["BR", "BUZZ", "HERDING", "PHS", "SS", "TAILSLAP", "WHISTLE"]
    for trial, n in enumerate((0, 1, 50, 400)):
        starts = rng.integers(0, 20_000, n)
        stops = starts + rng.integers(0, 300, n)
        starts[: n // 4] = starts[0] if n else 0  # ties on start and stop
        labels = list(rng.choice(names, n))
        delta_t = 256 / 48000 if trial % 2 == 0 else 0.01
        ours, ref = tmp_path / f"o{trial}.txt", tmp_path / f"r{trial}.txt"
        save_predictions(compute_labels(starts, stops, labels, 16, "*"), ours, delta_t)
        jax_save_predictions(
            jax_compute_labels(starts, stops, labels, 16, "*"), ref, delta_t
        )
        assert ours.read_bytes() == ref.read_bytes()
    assert pd.read_csv(ours, sep="\t").shape == (400, 3)


def test_cli_options_match_the_reference_command_by_command():
    """Every command of `python -m orcai_tpu_torch` takes the options and
    arguments of its namesake in orcai_tpu/cli.py, `--device` aside, and
    the top level takes `--version`."""
    import argparse

    import click

    from orcai_tpu.cli import cli
    from orcai_tpu_torch.__main__ import _parser

    parser = _parser()
    assert "--version" in {o for a in parser._actions for o in a.option_strings}
    assert "--version" in {o for p in cli.params for o in p.opts}
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == set(cli.commands)
    for name, port in sub.choices.items():
        ref_cmd = cli.commands[name]
        ref_opts = {o for p in ref_cmd.params if isinstance(p, click.Option)
                    for o in (*p.opts, *p.secondary_opts)}
        port_opts = {o for a in port._actions for o in a.option_strings}
        assert port_opts - {"-h", "--help", "--device"} == ref_opts, name
        assert ([a.dest for a in port._actions if not a.option_strings]
                == [p.name for p in ref_cmd.params if isinstance(p, click.Argument)]), name
    for name in ("predict", "serve", "warmup"):
        wire = next(p for p in cli.commands[name].params if p.name == "wire")
        ours = next(a for a in sub.choices[name]._actions if a.dest == "wire")
        assert list(ours.choices) == list(wire.type.choices) and ours.default == wire.default


def test_cli_wire_and_model_reach_predict(tmp_path, monkeypatch):
    seen = {}

    def fake_predict(**kwargs):
        seen.update(kwargs)
        return tmp_path / "x.txt"

    monkeypatch.setattr(tpredict, "predict", fake_predict)
    wav = str(FIXTURES / "golden.wav")
    assert cli_main(["predict", wav, "-wc", "sp-bfp5", "-m", "orcai-v1", "--device", "cpu"]) == 0
    assert seen["wire"] == "sp-bfp5" and Path(seen["model_dir"]).name == "orcai-v1"
    assert "model" not in seen
    cli_main(["predict", wav, "--device", "cpu", "-md", str(tmp_path)])
    assert seen["wire"] == "auto" and seen["model_dir"] == str(tmp_path)
    with pytest.raises(SystemExit):
        cli_main(["predict", wav, "-wc", "gzip"])
    with pytest.raises(SystemExit):
        cli_main(["predict", wav, "-m", "no-such-model"])


@pytest.mark.parametrize("wire", ["exact", "auto"])
def test_golden_tsv_byte_equal_on_the_exact_and_the_auto_wire(tmp_path, monkeypatch, wire):
    """With no ORCAI_TPU_WIRE, auto is the exact wire: the golden TSV stays
    byte-equal."""
    monkeypatch.delenv("ORCAI_TPU_WIRE", raising=False)
    out = predict(FIXTURES / "golden.wav", output_path=tmp_path / "pred.txt",
                  predict_batch_size=16, device="cpu", wire=wire)
    assert out.read_bytes() == GOLDEN
