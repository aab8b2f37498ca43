"""Reference-format model dirs on the port against the JAX package: `.keras`
archives, Keras 3 weight files under the bare name `model_weights.h5`, and
Keras 2 legacy weight and whole-model files, all written here by Keras from
models the JAX package's `build_keras_model` builds at
tests/test_model_parity.py's small widths. The port reads them without
Keras or h5py (io/keras_convert.py, io/hdf5.py); its trees must be
bit-equal to the JAX package's loaders', its forward within 2e-5 of
`keras_model.predict`, and `load_orcai_model` must try msgpack, `.keras`
and `model_weights.h5` in that order.

Also the committed fixtures under tests/fixtures/reference_formats/, which
the card reads (it has no TensorFlow to write them): `python
tests/test_torch_reference_formats.py --write-fixtures` writes them.
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile
import zipfile
from pathlib import Path

if __name__ == "__main__":  # as a script: the repo root and JAX on the CPU, as conftest.py
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
from keras.src.legacy.saving import legacy_h5_format  # noqa: E402

from orcai_tpu.io import keras_convert as jax_keras  # noqa: E402
from orcai_tpu.io import tfdata_convert as jax_tfdata  # noqa: E402
from orcai_tpu.io.model_store import load_orcai_model as jax_load_orcai_model  # noqa: E402
from orcai_tpu.resources import MODELS_DATA_DIR  # noqa: E402
from orcai_tpu.utils import Messenger  # noqa: E402
from orcai_tpu_torch.__main__ import main as port_main  # noqa: E402
from orcai_tpu_torch.io import keras_convert  # noqa: E402
from orcai_tpu_torch.io.model_store import (  # noqa: E402
    convert_flax_variables,
    load_orcai_model,
    load_variables,
    save_variables,
)
from orcai_tpu_torch.models import build_model  # noqa: E402
from orcai_tpu_torch.pipeline.predict import predict  # noqa: E402

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "fixtures"
REFERENCE_FORMATS = FIXTURES / "reference_formats"
BUNDLED = MODELS_DATA_DIR / "orcai-v1"
SMALL_PARAM = {
    "name": "tiny",
    "architecture": "ResNetLSTM",
    "model": {"filters": [4, 6, 8, 10], "kernel_size": 3, "dropout_rate": 0.5,
              "lstm_units": 16},
    "calls": ["A", "B", "C"],
}
INPUT_SHAPE = (64, 21, 1)
FORWARD_ATOL = 2e-5  # the CRNN bar, tests/test_model_parity.py
TVT_SAMPLES = {"train_dataset": 8, "val_dataset": 4}
QUIET = Messenger(verbosity=0)


def setup_module():
    torch.set_num_threads(1)


def _param(arch, **model):
    param = json.loads(json.dumps(SMALL_PARAM))
    param["architecture"] = arch
    param["model"].update(model)
    return param


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_bit_equal(ours, theirs):
    ours, theirs = _flat(ours), _flat(theirs)
    assert ours.keys() == theirs.keys()
    for key, leaf in theirs.items():
        assert ours[key].dtype == np.float32 == leaf.dtype, key
        assert ours[key].shape == leaf.shape and ours[key].tobytes() == leaf.tobytes(), key


def _write(model, fmt: str, path: Path) -> Path:
    """`model` in one reference format at `path`."""
    if fmt == "keras":
        model.save(path)
    elif fmt == "weights_h5":  # Keras 3 layout under the bare legacy name
        model.save_weights(path.with_name("w.weights.h5"))
        path.with_name("w.weights.h5").rename(path)
    elif fmt == "legacy_h5":
        with h5py.File(path, "w") as f:
            legacy_h5_format.save_weights_to_hdf5_group(f, model)
    else:  # a Keras 2 whole-model file: the weights under model_weights/
        legacy_h5_format.save_model_to_hdf5(model, str(path))
    return path


def _port_load(fmt, path, param):
    if fmt == "keras":
        return keras_convert.load_keras_checkpoint(path, param, INPUT_SHAPE)
    return keras_convert.load_keras_weights_h5(path, param, INPUT_SHAPE)


def _torch_forward(tree, param, x):
    model = build_model(param, INPUT_SHAPE)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in convert_flax_variables(tree).items()})
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("after_other_models", [False, True],
                         ids=["fresh_names", "suffixed_names"])
@pytest.mark.parametrize("fmt", ["keras", "weights_h5", "legacy_h5", "legacy_model_h5"])
@pytest.mark.parametrize("arch", ["ResNetLSTM", "ResNet1DConv"])
def test_reference_checkpoints_load_bit_equal_to_the_jax_package(tmp_path, arch, fmt,
                                                                  after_other_models):
    param = _param(arch)
    if after_other_models:
        # other models first: every layer name of the next one has a suffix
        jax_keras.build_keras_model(_param("ResNet1DConv"), INPUT_SHAPE)
        keras.Sequential([keras.Input((3,)), keras.layers.Dense(2), keras.layers.Dense(2)])
    keras.utils.set_random_seed(1234 + len(fmt))
    model = jax_keras.build_keras_model(param, INPUT_SHAPE)
    # moving statistics away from 0 / 1, so that the BN vectors are told apart
    for layer in model.layers:
        if isinstance(layer, keras.layers.BatchNormalization):
            g, b, m, v = layer.get_weights()
            rng = np.random.default_rng(len(g))
            layer.set_weights([g + rng.normal(0, .1, g.shape), b + rng.normal(0, .1, b.shape),
                               rng.normal(0, .1, m.shape), rng.uniform(.5, 1.5, v.shape)])
    if after_other_models:
        assert all(not layer.name.endswith(("conv2d", "dense")) for layer in model.layers)
    path = _write(model, fmt, tmp_path / ("tiny.keras" if fmt == "keras" else "model_weights.h5"))

    ours = _port_load(fmt, path, param)
    if fmt != "keras":
        theirs = jax_keras.load_keras_weights_h5(path, param, INPUT_SHAPE)
    elif arch == "ResNetLSTM":
        theirs = jax_keras.load_keras_checkpoint(path, param)
    else:
        # the JAX package cannot deserialize this archive: its Keras graph
        # holds a layer class defined inside build_keras_model; the weights
        # it would load are those of the model that was saved
        with pytest.raises(TypeError, match="could not be deserialized"):
            jax_keras.load_keras_checkpoint(path, param)
        theirs = jax_keras.keras_to_flax_variables(model, param)
    _assert_bit_equal(ours, jax.tree.map(np.asarray, theirs))

    x = np.random.default_rng(7).normal(size=(2, *INPUT_SHAPE)).astype(np.float32)
    want = model.predict(x, verbose=0)
    got = _torch_forward(ours, param, x)
    assert got.shape == want.shape == (2, 4, 3)
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


def test_suffixed_layer_names_are_matched_by_class_and_position(tmp_path):
    """A Keras 3 file names its groups by class counters and a legacy file
    lists the model's own (suffixed) layer names: both load the same tree."""
    param = _param("ResNetLSTM")
    jax_keras.build_keras_model(param, INPUT_SHAPE)  # shift every name's suffix
    keras.utils.set_random_seed(5)
    model = jax_keras.build_keras_model(param, INPUT_SHAPE)
    assert all(layer.name != "conv2d" for layer in model.layers)
    keras3 = _write(model, "weights_h5", tmp_path / "model_weights.h5")
    legacy = _write(model, "legacy_h5", tmp_path / "legacy.h5")
    with h5py.File(keras3) as f:
        assert "layers/conv2d" in f and "layers/bidirectional_1/forward_layer" in f
    with h5py.File(legacy) as f:
        assert "conv2d" not in list(f.attrs["layer_names"])
    _assert_bit_equal(_port_load("weights_h5", keras3, param),
                      _port_load("legacy_h5", legacy, param))


def test_resnet_tcn_and_mismatched_files_raise(tmp_path):
    tcn = _param("ResNetTCN")
    with pytest.raises(ValueError) as ours:
        keras_convert.keras_weighted_layers(tcn, INPUT_SHAPE)
    with pytest.raises(ValueError) as theirs:
        jax_keras.build_keras_model(tcn, INPUT_SHAPE)
    assert str(ours.value) == str(theirs.value)
    keras.utils.set_random_seed(2)
    model = jax_keras.build_keras_model(_param("ResNetLSTM"), INPUT_SHAPE)
    for fmt in ("keras", "weights_h5", "legacy_h5"):
        path = _write(model, fmt, tmp_path / ("m.keras" if fmt == "keras" else f"{fmt}.h5"))
        with pytest.raises(ValueError, match="no reference Keras equivalent"):
            _port_load(fmt, path, tcn)
        # a parameter file that disagrees with the weights
        with pytest.raises(ValueError, match="bilstm1.*the reference graph has"):
            _port_load(fmt, path, _param("ResNetLSTM", lstm_units=8))
        with pytest.raises(ValueError, match=str(path.name)):
            _port_load(fmt, path, _param("ResNetLSTM", filters=[4, 6, 8]))


def _model_dir(path: Path, param: dict) -> Path:
    path.mkdir(parents=True)
    (path / "orcai_parameter.json").write_text(json.dumps(param))
    (path / "model_shape.json").write_text(json.dumps(
        {"input_shape": list(INPUT_SHAPE), "num_labels": len(param["calls"])}))
    return path


def test_load_orcai_model_tries_msgpack_then_keras_then_h5(tmp_path):
    param = _param("ResNetLSTM")
    model_dir = _model_dir(tmp_path / "tiny", param)
    trees = {}
    for seed, fmt in ((11, "msgpack"), (12, "keras"), (13, "h5")):
        keras.utils.set_random_seed(seed)
        kmodel = jax_keras.build_keras_model(param, INPUT_SHAPE)
        trees[fmt] = jax.tree.map(np.asarray, jax_keras.keras_to_flax_variables(kmodel, param))
        if fmt == "msgpack":
            save_variables(trees[fmt], model_dir / "tiny.msgpack")
        elif fmt == "keras":
            kmodel.save(model_dir / "tiny.keras")
        else:
            _write(kmodel, "legacy_h5", model_dir / "model_weights.h5")
    for fmt, remove in (("msgpack", "tiny.msgpack"), ("keras", "tiny.keras"),
                        ("h5", "model_weights.h5")):
        model, got_param, shape = load_orcai_model(model_dir, device="cpu")
        assert got_param == param and shape["input_shape"] == list(INPUT_SHAPE)
        want = convert_flax_variables(trees[fmt])
        state = model.state_dict()
        assert all(state[k].numpy().tobytes() == v.tobytes() for k, v in want.items()), fmt
        _, jax_vars, _, _ = jax_load_orcai_model(model_dir)
        _assert_bit_equal(jax.tree.map(np.asarray, jax_vars), trees[fmt])
        (model_dir / remove).unlink()
    with pytest.raises(ValueError) as ours:
        load_orcai_model(model_dir, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_load_orcai_model(model_dir)
    assert str(ours.value) == str(theirs.value)
    assert "Couldn't find model weights (tiny.msgpack, tiny.keras or model_weights.h5)" in str(
        ours.value)


# -- the committed fixtures ----------------------------------------------------------

def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _hashes(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): _sha256(p) for p in sorted(root.rglob("*")) if p.is_file()}


def _written(before: dict, root: Path) -> dict[str, str]:
    """sha256 of every file under `root` that is new or changed against `before`."""
    return {k: v for k, v in _hashes(root).items() if before.get(k) != v}


def write_fixtures(out: Path = REFERENCE_FORMATS) -> None:
    """Write tests/fixtures/reference_formats/ with Keras and TensorFlow:
    orcai-v1/ (the bundled weights as a `.keras` archive, through the JAX
    package's flax_to_keras_model, and the two JSONs; no msgpack) and tvt/
    (GZIP snapshots of 8 and 4 samples at orcai-v1's shapes, values on a
    1/255 grid, dataset_shapes.json, and expected.json: the sha256 of every
    file the JAX package's convert_tvt_datasets writes from it)."""
    if out.exists():
        shutil.rmtree(out)
    model_dir = out / "orcai-v1"
    model_dir.mkdir(parents=True)
    _, variables, param, shape = jax_load_orcai_model(BUNDLED)
    kmodel = jax_keras.flax_to_keras_model(variables, param, tuple(shape["input_shape"]))
    kmodel.save(model_dir / "orcai-v1.keras")
    for name in ("orcai_parameter.json", "model_shape.json"):
        shutil.copy2(BUNDLED / name, model_dir / name)

    tvt = out / "tvt"
    tvt.mkdir()
    rng = np.random.default_rng(20261017)
    spec, labels = tuple(shape["input_shape"]), (46, len(param["calls"]))
    for name, n in TVT_SAMPLES.items():
        x = (rng.integers(0, 256, (n, *spec)) / 255).astype(np.float32)
        y = rng.integers(0, 2, (n, *labels)).astype(np.float32)
        tf.data.Dataset.from_tensor_slices((x, y)).save(str(tvt / name), compression="GZIP")
    (tvt / "dataset_shapes.json").write_text(
        json.dumps({"spectrogram": list(spec), "labels": list(labels)}))
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "tvt"
        shutil.copytree(tvt, copy)
        before = _hashes(copy)
        jax_tfdata.convert_tvt_datasets(copy, msgr=QUIET)
        expected = _written(before, copy)
    (tvt / "expected.json").write_text(json.dumps(expected, indent=1, sort_keys=True) + "\n")


def test_fixture_sizes_and_readers():
    tvt = REFERENCE_FORMATS / "tvt"
    assert sum(p.stat().st_size for p in tvt.rglob("*") if p.is_file()) < 3 * 2**20
    for name, n in TVT_SAMPLES.items():
        ds = tf.data.Dataset.load(str(tvt / name), compression="GZIP")
        elements = list(ds.as_numpy_iterator())
        assert len(elements) == n
        for x, y in elements:
            assert x.shape == (736, 171, 1) and y.shape == (46, 7)
            grid = (np.round(x.astype(np.float64) * 255) / 255).astype(np.float32)
            assert np.array_equal(grid, x)
    archive = REFERENCE_FORMATS / "orcai-v1" / "orcai-v1.keras"
    assert not (REFERENCE_FORMATS / "orcai-v1" / "orcai-v1.msgpack").exists()
    with zipfile.ZipFile(archive) as z:  # a zip of stored members
        assert sorted(z.namelist()) == ["config.json", "metadata.json", "model.weights.h5"]
        assert {m.compress_type for m in z.infolist()} == {zipfile.ZIP_STORED}
    kmodel = keras.saving.load_model(archive, compile=False)
    assert kmodel.output_shape == (None, 46, 7)


def test_fixture_expected_json_is_the_jax_converter_s_output(tmp_path):
    src = REFERENCE_FORMATS / "tvt"
    expected = json.loads((src / "expected.json").read_text())
    assert sorted(expected) == sorted(
        f"{name}/{f}" for name in TVT_SAMPLES
        for f in ("labels_00000.npy", "meta.json", "spectrogram_00000.npy"))
    for side in ("jax", "port"):
        copy = tmp_path / side
        shutil.copytree(src, copy)
        before = _hashes(copy)
        if side == "jax":
            jax_tfdata.convert_tvt_datasets(copy, msgr=QUIET)
        else:
            assert port_main(["convert-dataset", str(copy), "-v", "0"]) == 0
        assert _written(before, copy) == expected, side


def test_fixture_model_loads_bit_equal_and_predicts_golden(tmp_path):
    bundled = convert_flax_variables(load_variables(BUNDLED / "orcai-v1.msgpack"))
    fixture = REFERENCE_FORMATS / "orcai-v1"
    model, _, _ = load_orcai_model(fixture, device="cpu")
    state = model.state_dict()
    for key, value in bundled.items():
        assert state[key].numpy().tobytes() == value.tobytes(), key
    # the archive's weight file alone, as a legacy model dir's model_weights.h5
    h5_dir = tmp_path / "h5_dir"
    h5_dir.mkdir()
    for name in ("orcai_parameter.json", "model_shape.json"):
        shutil.copy2(fixture / name, h5_dir / name)
    with zipfile.ZipFile(fixture / "orcai-v1.keras") as archive:
        (h5_dir / "model_weights.h5").write_bytes(archive.read("model.weights.h5"))
    model_h5, _, _ = load_orcai_model(h5_dir, device="cpu")
    for key, value in model_h5.state_dict().items():
        assert value.numpy().tobytes() == state[key].numpy().tobytes(), key
    out = predict(FIXTURES / "golden.wav", model_dir=fixture, output_path=tmp_path / "p.txt",
                  predict_batch_size=16, device="cpu")
    assert out.read_bytes() == (FIXTURES / "golden_expected.txt").read_bytes()


if __name__ == "__main__":
    if "--write-fixtures" not in sys.argv:
        sys.exit("usage: python tests/test_torch_reference_formats.py --write-fixtures")
    write_fixtures()
    print(f"wrote {REFERENCE_FORMATS}")
