"""The port's evaluation (orcai_tpu_torch/train/evaluate.py) against the JAX
package's on the CPU: confusion and misclassification tables equal on random
labels with masks, the CSV text equal to pandas', `test_model` with a
remainder batch and with a split smaller than one batch, slab sizes that
change nothing, and the slab sizing fault C2 not inherited."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from orcai_tpu.io.dataset import ArrayDataset as JaxArrayDataset
from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.train import evaluate as jax_evaluate
from orcai_tpu.train import trainer as jax_trainer
from orcai_tpu.utils import Messenger
from orcai_tpu_torch.io.dataset import ArrayDataset
from orcai_tpu_torch.io.model_store import convert_flax_variables, save_orcai_model
from orcai_tpu_torch.models import build_model, init_variables
from orcai_tpu_torch.train import evaluate
from orcai_tpu_torch.train.evaluate import (
    Table,
    _attribution_matrix,
    _save_test_results,
    _test_model_on_dataset,
    batches_per_slab,
    compute_confusion_table,
    compute_misclassification_tables,
    quantize_eval_upload,
    resolve_eval_upload,
)
from orcai_tpu_torch.train.trainer import Trainer
from orcai_tpu_torch.utils.seeds import MASK_VALUE

PARAM = {
    "name": "eval-test",
    "architecture": "ResNetLSTM",
    "model": {"filters": [2, 3], "kernel_size": 3, "dropout_rate": 0.1, "lstm_units": 4,
              "batch_size": 64, "learning_rate": 1e-3},
    "calls": ["A", "B", "C"],
    "seed": 5,
}
INPUT_SHAPE = (16, 9, 1)
OUT = 4


def setup_module():
    torch.set_num_threads(1)


def _csv_text(table, tmp_path, name="t.csv"):
    table.to_csv(tmp_path / name, index_label="Label")
    return (tmp_path / name).read_text()


def _random_label_matrices(seed, n=500, labels=4):
    rng = np.random.default_rng(seed)
    m1 = rng.choice([0, 1], size=(n, labels), p=[0.8, 0.2])
    m2 = rng.choice([0, 1, -1], size=(n, labels), p=[0.7, 0.2, 0.1])
    m1 = np.where(rng.uniform(size=m1.shape) < 0.05, -1, m1)
    return m1, m2


def _assert_table_equals_frame(table: Table, frame: pd.DataFrame):
    assert table.index == list(frame.index)
    assert list(table.columns) == list(frame.columns)
    for name in frame.columns:
        assert table[name].dtype == frame[name].dtype, name
        np.testing.assert_array_equal(table[name], frame[name].to_numpy(), err_msg=name)


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("seed", range(3))
def test_misclassification_tables_equal_the_reference(seed, tmp_path):
    m1, m2 = _random_label_matrices(seed)
    names = ["A", "B", "C", "D"]
    want = jax_evaluate.compute_misclassification_tables(m1, m2, "true", "pred", names)
    got = compute_misclassification_tables(m1, m2, "true", "pred", names)
    assert sorted(got) == sorted(want) == ["pred_true", "true_pred"]
    for key, frame in want.items():
        _assert_table_equals_frame(got[key], frame)
        frame.to_csv(tmp_path / "want.csv", index_label="Label")
        assert _csv_text(got[key], tmp_path) == (tmp_path / "want.csv").read_text()
    np.testing.assert_array_equal(
        _attribution_matrix(m1, m2, 4), jax_evaluate._attribution_matrix(m1, m2, 4))


def test_misclassification_table_with_an_empty_row_writes_nan_as_empty(tmp_path):
    """A label no row carries: its row is 0 / 0, NaN in the table, an empty
    field in the CSV, as pandas writes it."""
    m1 = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 0], [1, 0, 0]])
    m2 = np.array([[1, 0, 0], [1, 1, 0], [0, 0, 0], [-1, 0, 0]])
    names = ["A", "B", "C"]
    want = jax_evaluate.compute_misclassification_tables(m1, m2, "true", "pred", names)
    got = compute_misclassification_tables(m1, m2, "true", "pred", names)
    assert np.isnan(got["true_pred"].row("true_C")["pred_A"])
    for key, frame in want.items():
        frame.to_csv(tmp_path / "want.csv", index_label="Label")
        text = _csv_text(got[key], tmp_path)
        assert text == (tmp_path / "want.csv").read_text()
    assert "true_C,,,,,0.0\n" in _csv_text(got["true_pred"], tmp_path)


@pytest.mark.parametrize("seed", range(3))
def test_confusion_table_equals_the_reference(seed, tmp_path):
    rng = np.random.default_rng(seed)
    names = list("ABCDEFG")
    y_true = rng.integers(0, 2, (20, 46, 7)).astype(np.float32)
    # masks of different sizes, so that the rows sort; label E fully masked
    for i, share in enumerate([0.0, 0.5, 0.1, 0.3, 1.0, 0.2, 0.4]):
        y_true[..., i][rng.uniform(size=y_true.shape[:2]) < share] = MASK_VALUE
    y_pred = rng.uniform(size=y_true.shape).astype(np.float32)
    y_pred[..., 5] = 0.1  # no positive prediction: precision is NaN
    want = jax_evaluate.compute_confusion_table(y_true, y_pred, names)
    got = compute_confusion_table(y_true, y_pred, names)
    _assert_table_equals_frame(got, want)
    assert got.index[0] == "A" and got.index[-1] == "E"
    assert np.isnan(got.row("E")["TP"]) and got.row("E")["Total"] == 0
    assert np.isnan(got.row("F")["PR"])
    want.to_csv(tmp_path / "want.csv", index_label="Label")
    assert _csv_text(got, tmp_path) == (tmp_path / "want.csv").read_text()


def test_confusion_table_ties_keep_their_order(tmp_path):
    """Labels with equal totals come out in pandas' order. sort_values is
    not a stable sort: where numpy's small-array path is an insertion sort
    the ties stay in the parameter file's order, where it is a vectorized
    sort they need not, so the port takes pandas' own steps (the reversed
    column through numpy's default argsort) and is held against pandas on
    the machine the test runs on."""
    rng = np.random.default_rng(0)
    names = list("ABCDEFG")
    y_true = rng.integers(0, 2, (6, 4, 7)).astype(np.float32)
    y_true[0, :, 0] = MASK_VALUE  # A: 20 cells; the rest tie at 24 but for F
    y_true[:2, :, 5] = MASK_VALUE  # F: 16
    y_pred = rng.uniform(size=y_true.shape).astype(np.float32)
    want = jax_evaluate.compute_confusion_table(y_true, y_pred, names)
    got = compute_confusion_table(y_true, y_pred, names)
    assert got.index == list(want.index)
    assert sorted(got.index[:5]) == ["B", "C", "D", "E", "G"] and got.index[5:] == ["A", "F"]
    for n_labels in (2, 3, 5, 7, 12, 20, 40):  # only ties, at several sizes
        totals = np.full(n_labels, 24, np.int64)
        frame = pd.DataFrame({"Total": totals}, index=[f"L{i}" for i in range(n_labels)])
        want_order = list(frame.sort_values(by="Total", ascending=False).index)
        assert [f"L{i}" for i in evaluate._descending_order(totals)] == want_order
    want.to_csv(tmp_path / "want.csv", index_label="Label")
    assert _csv_text(got, tmp_path) == (tmp_path / "want.csv").read_text()


def test_confusion_table():
    y_true = np.array([[[1, 0], [0, MASK_VALUE]], [[0, 1], [1, MASK_VALUE]]], dtype=np.float32)
    y_pred = np.array([[[0.9, 0.2], [0.3, 0.99]], [[0.6, 0.8], [0.2, 0.99]]], dtype=np.float32)
    table = compute_confusion_table(y_true, y_pred, ["A", "B"])
    # label A: true [1,0,0,1], pred [1,0,1,0] -> tp=1 fp=1 fn=1 tn=1
    row = table.row("A")
    assert row["Total"] == 4
    assert row["TP"] == 0.25 and row["FP"] == 0.25
    assert row["PR"] == 0.5 and row["RE"] == 0.5
    # label B: masked positions dropped -> true [0,1], pred [0,1]
    row = table.row("B")
    assert row["Total"] == 2
    assert row["F1"] == 1.0


def test_csv_cells_are_the_shortest_float64_text(tmp_path):
    values = np.array([1 / 3, 0.1 + 0.2, 1e-05, 123456789.125, 1e16, 0.0, np.nan, -2.5])
    index = [f"r{i}" for i in range(len(values))]
    table = Table(index, {"x": values, "n": np.arange(len(values), dtype=np.int64),
                          "with,comma": values[::-1]})
    frame = pd.DataFrame({"x": values, "n": np.arange(len(values), dtype=np.int64),
                          "with,comma": values[::-1]}, index=index)
    frame.to_csv(tmp_path / "want.csv", index_label="Label")
    assert _csv_text(table, tmp_path) == (tmp_path / "want.csv").read_text()
    with pytest.raises(ValueError, match="shape"):
        Table(["a"], {"x": np.zeros(2)})


# --------------------------------------------------------------- uploads


def test_eval_upload_policy_and_quantizer(monkeypatch):
    monkeypatch.delenv("ORCAI_TPU_EVAL_UPLOAD", raising=False)
    assert resolve_eval_upload() == resolve_eval_upload("auto") == "f32"  # off a TPU: exact
    assert jax_evaluate.resolve_eval_upload(None, backend="cpu") == "f32"
    assert resolve_eval_upload("u16") == "u16"
    monkeypatch.setenv("ORCAI_TPU_EVAL_UPLOAD", "u8")
    assert resolve_eval_upload() == "u8"
    assert resolve_eval_upload("f32") == "f32"
    monkeypatch.setenv("ORCAI_TPU_EVAL_UPLOAD", "bogus")
    with pytest.raises(ValueError, match="unknown eval upload"):
        resolve_eval_upload()
    x = np.random.default_rng(0).uniform(-0.1, 1.1, (5, 7, 3)).astype(np.float32)
    assert quantize_eval_upload(x, "f32") is x
    for upload, dtype, scale in (("u8", np.uint8, 255.0), ("u16", np.uint16, 65535.0)):
        q = quantize_eval_upload(x, upload)
        assert q.dtype == dtype
        # the reference's numpy chain (evaluate.py:198-202)
        buf = np.multiply(x, scale, dtype=np.float32)
        np.rint(buf, out=buf)
        np.clip(buf, 0.0, scale, out=buf)
        np.testing.assert_array_equal(q, buf.astype(dtype))


def _quantizer_inputs() -> np.ndarray:
    """tests/test_native_codec.py:272's inputs: uniform [0, 1], the clipping
    range, exact ties at both scales and the edges, in a non-flat shape."""
    rng = np.random.default_rng(21)
    return np.concatenate([
        rng.uniform(0, 1, 100_000).astype(np.float32),
        np.linspace(-0.1, 1.1, 4096, dtype=np.float32),
        (np.arange(0, 512, dtype=np.float32) + 0.5) / 255.0,
        (np.arange(0, 512, dtype=np.float32) + 0.5) / 65535.0,
        np.array([0.0, 0.5, 1.0, np.float32(1.0) - np.float32(1e-7)], np.float32),
    ]).reshape(-1, 4)


@pytest.mark.parametrize("upload, dtype, scale",
                         [("u8", np.uint8, 255.0), ("u16", np.uint16, 65535.0)])
def test_native_quantizer_is_bit_equal_to_numpy_and_to_the_jax_package(upload, dtype, scale):
    from orcai_tpu.native import quantize_linear_native as jax_quantize_native
    from orcai_tpu_torch.native import native_available, quantize_linear_native

    assert native_available()  # quant.c builds beside the LZ4 codec here
    x = _quantizer_inputs()
    ref = np.clip(np.rint(np.multiply(x, scale, dtype=np.float32)), 0.0, scale).astype(dtype)
    got = quantize_linear_native(x, dtype)
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_quantize_native(x, dtype))
    np.testing.assert_array_equal(quantize_eval_upload(x, upload), ref)
    # the ties round to even, and the out-of-range values clip
    assert got[x <= 0].max() == 0 and got[x >= 1].min() == scale


@pytest.mark.parametrize("upload, dtype", [("u8", np.uint8), ("u16", np.uint16)])
def test_quantize_eval_upload_without_the_native_library(upload, dtype, monkeypatch):
    from orcai_tpu_torch import native

    x = _quantizer_inputs()
    with_c = quantize_eval_upload(x, upload)
    monkeypatch.setenv("ORCAI_TPU_DISABLE_NATIVE", "1")
    native._load.cache_clear()
    try:
        assert native.quantize_linear_native(x, dtype) is None
        without = quantize_eval_upload(x, upload)
    finally:
        monkeypatch.delenv("ORCAI_TPU_DISABLE_NATIVE")
        native._load.cache_clear()
    assert without.dtype == with_c.dtype == dtype
    np.testing.assert_array_equal(without, with_c)


def test_slabs_are_sized_by_the_float32_bytes_staged_on_the_host():
    """ROADMAP C2 (orcai_tpu/train/evaluate.py:239-246): the reference caps
    a slab by its coded bytes, but gathers it on the host as float32 first,
    so a u8 upload stages four times the cap. The port sizes by float32
    whatever the upload: the two differ by the code's width."""
    batch_size, snippet_elems = 64, 736 * 171
    f32_batch = batch_size * snippet_elems * 4
    slab_bytes = 4 * f32_batch
    assert batches_per_slab(batch_size, snippet_elems, slab_bytes) == 4
    reference_u8 = max(1, slab_bytes // max(batch_size * snippet_elems * 1, 1))
    assert reference_u8 == 16  # 16 batches = 4x the cap in host float32
    assert batches_per_slab(batch_size, snippet_elems, 1) == 1
    assert batches_per_slab(batch_size, snippet_elems, f32_batch - 1) == 1


# ------------------------------------------------------------ evaluation


def _setup(n, batch_size=8, seed=0, arch="ResNetLSTM", masked=True):
    param = {**PARAM, "architecture": arch, "model": {**PARAM["model"], "batch_size": batch_size}}
    model = init_variables(build_model(param, INPUT_SHAPE), seed=1)
    trainer = Trainer(model, 1e-3, device="cpu")
    state = None  # evaluation reads the trainer's model only
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, *INPUT_SHAPE)).astype(np.float32)
    y = rng.integers(0, 2, (n, OUT, 3)).astype(np.float32)
    if masked:
        y[:, :, 1][rng.uniform(size=(n, OUT)) < 0.2] = MASK_VALUE
    return param, trainer, state, x, y


def _assert_results_equal(a, b):
    assert a["data_metrics"] == b["data_metrics"]
    assert a["confusion_table"].index == b["confusion_table"].index
    for name, col in a["confusion_table"].columns.items():
        np.testing.assert_array_equal(col, b["confusion_table"][name])
    for key, tbl in a["misclassification_tables"].items():
        for name, col in tbl.columns.items():
            np.testing.assert_array_equal(col, b["misclassification_tables"][key][name])


@pytest.mark.parametrize("n,batch_size", [(70, 64), (5, 8), (13, 8), (16, 8)],
                         ids=["70_at_64", "smaller_than_a_batch", "remainder", "whole_batches"])
def test_every_snippet_counts_and_the_loss_is_weighted_by_valid_snippets(n, batch_size):
    param, trainer, state, x, y = _setup(n, batch_size, masked=False)
    ds = ArrayDataset(x, y)
    result = _test_model_on_dataset(trainer, ds, batch_size, [3, 7], param["calls"], "t")
    conf = result["confusion_table"]
    assert result["n_snippets"] == n
    assert list(conf["Total"]) == [n * OUT] * 3
    assert not np.isnan(np.stack([conf[k] for k in ("TP", "FN", "FP", "TN")])).any()
    assert np.isfinite(result["data_metrics"]["MBA"])
    # one padded batch holding the whole split gives the per-snippet mean
    single = _test_model_on_dataset(trainer, ds, 128, [3, 7], param["calls"], "s")
    assert result["data_metrics"]["loss"] == pytest.approx(
        single["data_metrics"]["loss"], rel=1e-5)
    assert result["data_metrics"]["MBA"] == single["data_metrics"]["MBA"]


@pytest.mark.parametrize("n,batch_size", [(70, 64), (21, 8)])
def test_slab_size_changes_nothing(n, batch_size, monkeypatch, tmp_path):
    param, trainer, state, x, y = _setup(n, batch_size)
    ds = ArrayDataset(x, y)
    args = (trainer, ds, batch_size, [9, 4], param["calls"])
    monkeypatch.delenv("ORCAI_TPU_EVAL_SLAB_BYTES", raising=False)
    single = _test_model_on_dataset(*args, "one_slab")
    monkeypatch.setenv("ORCAI_TPU_EVAL_SLAB_BYTES", "1")  # one batch a slab
    slabbed = _test_model_on_dataset(*args, "one_slab")
    _assert_results_equal(slabbed, single)
    _save_test_results(single, tmp_path / "a")
    _save_test_results(slabbed, tmp_path / "b")
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert names == ["one_slab_confusion_table.csv", "one_slab_metrics.json",
                     "one_slab_misclassification_table_pred_true.csv",
                     "one_slab_misclassification_table_true_pred.csv"]
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()


@pytest.mark.parametrize("arch", ["ResNetLSTM", "ResNet1DConv", "ResNetTCN"])
def test_evaluation_matches_the_jax_package(arch, tmp_path):
    """The same weights and split through both packages' evaluations: the
    same batches (seeded), loss and accuracy to float32 differences, and
    the tables' CSV text equal."""
    param, trainer, state, x, y = _setup(21, 8, arch=arch)
    got = _test_model_on_dataset(trainer, ArrayDataset(x, y), 8, [9, 4],
                                 param["calls"], "t")
    from orcai_tpu_torch.io.model_store import to_flax_variables

    variables = jax.tree.map(jnp.asarray, to_flax_variables(trainer.model.state_dict()))
    jt = jax_trainer.Trainer(jax_build_model(param), jax_trainer.make_optimizer(1e-3))
    jstate = (variables["params"], variables["batch_stats"], None, None)
    want = jax_evaluate._test_model_on_dataset(
        jt, jstate, JaxArrayDataset(x, y), 8, [9, 4], param["calls"], "t",
        Messenger(verbosity=0), upload="f32")
    assert got["data_metrics"]["loss"] == pytest.approx(want["data_metrics"]["loss"], rel=1e-5)
    assert got["data_metrics"]["MBA"] == want["data_metrics"]["MBA"]
    _save_test_results(got, tmp_path / "port")
    jax_evaluate._save_test_results(want, tmp_path / "jax", Messenger(verbosity=0))
    for path in (tmp_path / "jax").glob("*.csv"):
        assert (tmp_path / "port" / path.name).read_text() == path.read_text(), path.name


@pytest.mark.parametrize("upload,atol", [("u16", 2e-4), ("u8", 2e-3)])
def test_quantized_uploads_stay_close_to_the_exact_evaluation(upload, atol):
    param, trainer, state, x, y = _setup(16, 8)
    ds = ArrayDataset(x, y)
    exact = _test_model_on_dataset(trainer, ds, 8, [1, 2], param["calls"], "e", "f32")
    coded = _test_model_on_dataset(trainer, ds, 8, [1, 2], param["calls"], "c", upload)
    assert coded["data_metrics"]["loss"] == pytest.approx(exact["data_metrics"]["loss"], abs=atol)
    for k in ("TP", "FN", "FP", "TN"):
        np.testing.assert_allclose(coded["confusion_table"][k], exact["confusion_table"][k],
                                   atol=0.02)


def test_test_model_e2e(tmp_path, monkeypatch):
    """70 snippets at batch 64 through the entry point, with the unfiltered
    split; a second run with a slab of one batch writes the same bytes."""
    param, trainer, state, x, y = _setup(70, 64)

    class L:
        def __len__(self):
            return len(x)

        def __iter__(self):
            return iter(zip(x, y))

    for split in ["test", "test_unfiltered"]:
        ArrayDataset.save_from_loader(L(), tmp_path / f"{split}_dataset")
    (tmp_path / "dataset_shapes.json").write_text(
        json.dumps({"spectrogram": list(INPUT_SHAPE), "labels": [OUT, 3]}))
    model_dir = tmp_path / param["name"]
    save_orcai_model(model_dir, param, trainer.model.state_dict(), input_shape=INPUT_SHAPE)

    monkeypatch.delenv("ORCAI_TPU_EVAL_SLAB_BYTES", raising=False)
    out = evaluate.test_model(model_dir, tmp_path, test_unfiltered=True, device="cpu")
    assert out == model_dir / "test"
    metrics = json.loads((out / "test_data_metrics.json").read_text())
    assert sorted(metrics) == ["MBA", "loss"]
    assert 0.0 <= metrics["MBA"] <= 1.0 and np.isfinite(metrics["loss"])
    ct = pd.read_csv(out / "test_data_confusion_table.csv", index_col=0)
    assert set(ct.index) == {"A", "B", "C"}
    assert list(ct.columns) == ["TP", "FN", "FP", "TN", "PR", "RE", "F1", "Total"]
    assert ct.loc["A", "Total"] == 70 * OUT  # every snippet, the remainder batch too
    assert ct.loc["B", "Total"] < ct.loc["A", "Total"]  # masked positions excluded
    for key in ["true_pred", "pred_true"]:
        t = pd.read_csv(out / f"test_data_misclassification_table_{key}.csv", index_col=0)
        assert "fraction_time" in t.columns
    assert (out / "test_unfiltered_dataset_metrics.json").exists()
    assert len(list(out.iterdir())) == 8

    monkeypatch.setenv("ORCAI_TPU_EVAL_SLAB_BYTES", "1")
    again = evaluate.test_model(model_dir, tmp_path, test_unfiltered=False,
                                output_dir=tmp_path / "again", device="cpu")
    assert len(list(again.iterdir())) == 4
    for path in again.iterdir():
        assert path.read_bytes() == (out / path.name).read_bytes(), path.name
