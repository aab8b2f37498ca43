"""The port's HDF5 reader (orcai_tpu_torch/io/hdf5.py) against h5py on
files that h5py and Keras write here: every group, dataset and attribute
read equal (values, dtypes, shapes, variable-length strings from the global
heap), and the layouts it does not read (chunked, filtered, the newer file
format) raise and name the object."""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
keras = pytest.importorskip("keras")

from keras.src.legacy.saving import legacy_h5_format  # noqa: E402

from orcai_tpu.io.keras_convert import build_keras_model  # noqa: E402
from orcai_tpu_torch.io.hdf5 import H5Dataset, H5Error, H5File, H5Group  # noqa: E402

PARAM = {
    "name": "tiny",
    "architecture": "ResNetLSTM",
    "model": {"filters": [4, 6], "kernel_size": 3, "dropout_rate": 0.5, "lstm_units": 8},
    "calls": ["A", "B", "C"],
}
INPUT_SHAPE = (32, 21, 1)


def _same(ours, theirs, where):
    if isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray), where
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype, where
        if theirs.dtype == object:  # h5py: str for variable-length strings
            assert [o for o in ours.ravel()] == [t for t in theirs.ravel()], where
        else:
            assert ours.tobytes() == theirs.tobytes(), where
    else:
        assert type(ours) is type(theirs) and ours == theirs, where


def _walk(group, ours, count):
    assert sorted(group.keys()) == sorted(ours.keys()), group.name
    assert set(group.attrs) == set(ours.attrs), group.name
    for name, value in group.attrs.items():
        _same(ours.attrs[name], value, f"{group.name} attrs {name}")
    for name, item in group.items():
        mine = ours[name]
        if isinstance(item, h5py.Group):
            assert isinstance(mine, H5Group)
            _walk(item, mine, count)
        else:
            assert isinstance(mine, H5Dataset)
            assert mine.shape == item.shape and mine.dtype == item.dtype, item.name
            # the reader gives str for variable-length strings: h5py's attrs
            # do too, its datasets through asstr()
            value = item.asstr()[()] if item.dtype == object else item[()]
            _same(mine.read(), value, item.name)
            for attr, v in item.attrs.items():
                _same(mine.attrs[attr], v, f"{item.name} attrs {attr}")
            count.append(item.name)


def _compare(path) -> int:
    count: list = []
    with h5py.File(path, "r") as f:
        _walk(f, H5File(path).root, count)
    return len(count)


def test_h5py_types_layouts_and_large_groups(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "types.h5"
    with h5py.File(path, "w") as f:
        f.attrs["f32"] = np.float32(1.5)
        f.attrs["f64_array"] = rng.normal(size=(2, 3))
        f.attrs["i64"] = np.int64(-7)
        f.attrs["u8_array"] = np.arange(5, dtype=np.uint8)
        f.attrs["fixed"] = np.bytes_(b"fixed-length")
        f.attrs["fixed_array"] = np.array([b"a", b"bcd", b""], dtype="S3")
        f.attrs["vlen"] = "variable length"
        f.attrs["vlen_array"] = np.array(["conv2d", "batch_normalization", "ünïcode", ""],
                                         dtype=h5py.string_dtype())
        f.attrs["empty"] = np.zeros((0,), np.float64)
        g = f.create_group("nested/deeper")
        g.create_dataset("f32", data=rng.normal(size=(3, 3, 4, 5)).astype(np.float32))
        g.create_dataset("f64", data=rng.normal(size=(7,)))
        g.create_dataset("scalar", data=np.float32(3.25))
        g.create_dataset("empty", data=np.zeros((0, 4), np.float32))
        g.create_dataset("ints", data=np.arange(-3, 9, dtype=np.int32).reshape(3, 4))
        g.create_dataset("vlen", data=np.array(["x", "yz"], dtype=h5py.string_dtype()))
        space = h5py.h5s.create_simple((4, 2))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        compact = h5py.h5d.create(g.id, b"compact", h5py.h5t.IEEE_F32LE, space, dcpl=dcpl)
        compact.write(h5py.h5s.ALL, h5py.h5s.ALL,
                      np.arange(8, dtype=np.float32).reshape(4, 2))
        g["f32"].attrs["unit"] = "dB"
        # enough links for a multi-level B-tree of many symbol nodes
        many = f.create_group("many")
        for i in range(400):
            many.create_dataset(f"d{i:03d}", data=np.full((2,), i, np.float32))
        # attributes added late overflow the header into continuation blocks
        for i in range(60):
            many.attrs[f"late_{i}"] = np.arange(i + 1, dtype=np.float64)
    assert _compare(path) == 7 + 400
    with h5py.File(path, "r") as f:
        assert f["nested/deeper/compact"].id.get_create_plist().get_layout() == h5py.h5d.COMPACT
    ours = H5File(path).root
    assert "nested/deeper/f32" in ours and "nested/missing" not in ours
    with pytest.raises(KeyError, match="missing"):
        ours["nested/missing"]


def test_keras_weight_files_read_as_h5py_reads_them(tmp_path):
    keras.utils.set_random_seed(3)
    model = build_keras_model(PARAM, INPUT_SHAPE)
    model.save_weights(tmp_path / "m.weights.h5")
    with h5py.File(tmp_path / "legacy.h5", "w") as f:
        legacy_h5_format.save_weights_to_hdf5_group(f, model)
    legacy_h5_format.save_model_to_hdf5(model, str(tmp_path / "whole.h5"))
    counts = {name: _compare(tmp_path / name) for name in ("m.weights.h5", "legacy.h5",
                                                           "whole.h5")}
    n_weights = len(model.weights)
    assert counts == {"m.weights.h5": n_weights, "legacy.h5": n_weights,
                      "whole.h5": n_weights}
    legacy = H5File(tmp_path / "legacy.h5").root
    assert legacy.attrs["layer_names"].dtype == object  # variable-length, global heap
    assert all(isinstance(name, str) for name in legacy.attrs["layer_names"])


@pytest.mark.parametrize("kind", ["chunked", "gzip"])
def test_chunked_and_filtered_datasets_raise_and_name_the_path(tmp_path, kind):
    path = tmp_path / f"{kind}.h5"
    with h5py.File(path, "w") as f:
        kw = {"chunks": (2, 2)} if kind == "chunked" else {"compression": "gzip"}
        f.create_group("layers").create_dataset("w", data=np.ones((4, 4), np.float32), **kw)
        f.create_dataset("fine", data=np.ones(3, np.float32))
    ours = H5File(path).root
    assert ours["fine"].read().tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(H5Error, match="/layers/w") as err:
        ours["layers/w"].read()
    assert str(path) in str(err.value)
    assert ("chunked" if kind == "chunked" else "filtered") in str(err.value)


def test_the_newer_file_format_and_other_files_raise(tmp_path):
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("w", data=np.ones(3, np.float32))
    with pytest.raises(H5Error, match="superblock version"):
        H5File(path)
    (tmp_path / "not.h5").write_bytes(b"PK\x03\x04 not an hdf5 file")
    with pytest.raises(H5Error, match="no HDF5 signature"):
        H5File(tmp_path / "not.h5")
    with h5py.File(tmp_path / "big.h5", "w") as f:
        f.create_dataset("w", data=np.ones(3, np.float32))
        f.create_dataset("b", data=np.ones(3, ">f4"))
        f.create_dataset("h", data=np.ones(3, np.float16))
    ours = H5File(tmp_path / "big.h5").root
    with pytest.raises(H5Error, match="/b: float type"):
        ours["b"]
    with pytest.raises(H5Error, match="/h: float type"):
        ours["h"]
