"""`convert-dataset` on the port against the JAX package: tf.data snapshots
written here by `tf.data.Dataset.save` from numpy arrays drawn from a seed,
converted by orcai_tpu.io.tfdata_convert (through TensorFlow) and by
orcai_tpu_torch.io.tfdata_convert (from the files, no TensorFlow). Every
file either writes must be byte-equal. Also the CRC-32C of native/crc32c.c
against a bytewise table, and the reader's refusals: corrupted framing,
another dtype, another snapshot version, a tensor without content.
"""

import multiprocessing
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from orcai_tpu.io import tfdata_convert as jax_convert  # noqa: E402
from orcai_tpu.utils import Messenger  # noqa: E402
from orcai_tpu_torch.__main__ import main as port_main  # noqa: E402
from orcai_tpu_torch.io import tfdata_convert as port_convert  # noqa: E402
from orcai_tpu_torch.io import tfrecord  # noqa: E402
from orcai_tpu_torch.native import crc32c_native  # noqa: E402
from orcai_tpu_torch.utils.messenger import Messenger as PortMessenger  # noqa: E402

QUIET = Messenger(verbosity=0)
SPEC, LABELS = (16, 5, 1), (2, 3)


def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


CRC_TABLE = _crc_table()


def crc32c_py(data: bytes, crc: int = 0) -> int:
    """Bytewise CRC-32C, the reference for native/crc32c.c."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_py(data: bytes) -> int:
    crc = crc32c_py(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord frame, made with the Python crc."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_py(length)) + data
            + struct.pack("<I", masked_py(data)))


def _arrays(n, seed, spec=SPEC):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, *spec)).astype(np.float32)
    y = rng.integers(-1, 2, size=(n, *LABELS)).astype(np.float32)
    return x, y


def _save(path, x, y, compression="GZIP"):
    tf.data.Dataset.from_tensor_slices((x, y)).save(str(path), compression=compression)


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _both(tmp_path, tvt, output=False, **kwargs):
    """The JAX package's and the port's convert_tvt_datasets on two copies
    of `tvt`; returns (jax result, port result, jax tree, port tree)."""
    copies = {}
    for side in ("jax", "port"):
        copies[side] = tmp_path / f"{side}_tvt"
        shutil.copytree(tvt, copies[side])
    outs = {side: (tmp_path / f"{side}_out" if output else None) for side in copies}
    got_jax = jax_convert.convert_tvt_datasets(copies["jax"], outs["jax"], msgr=QUIET, **kwargs)
    got_port = port_convert.convert_tvt_datasets(copies["port"], outs["port"], **kwargs)
    tree = {side: _tree(outs[side] or copies[side]) for side in copies}
    return got_jax, got_port, tree["jax"], tree["port"]


def _tvt(tmp_path, compression="GZIP", spec=SPEC, seed=0):
    tvt = tmp_path / "tvt"
    tvt.mkdir()
    for i, (name, n) in enumerate((("train_dataset", 11), ("val_dataset", 5))):
        x, y = _arrays(n, seed + i, spec)
        _save(tvt / name, x, y, compression)
    (tvt / "dataset_shapes.json").write_text(
        f'{{"spectrogram": {list(SPEC)}, "labels": {list(LABELS)}}}')
    (tvt / "call_weights.json").write_text('{"A": 1.0, "B": 2.0, "C": 0.5}')
    return tvt


def test_crc32c_native_matches_the_bytewise_table():
    assert crc32c_py(b"123456789") == 0xE3069283  # the CRC-32C check value
    rng = np.random.default_rng(0)
    for n in [0, 1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 1000, 4099]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c_native(data) == crc32c_py(data), n
    data = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    assert tfrecord.masked_crc32c(data) == masked_py(data)


def test_reader_raises_without_the_c_library(tmp_path, monkeypatch):
    tvt = _tvt(tmp_path)
    monkeypatch.setattr(tfrecord, "crc32c_native", lambda data: None)
    with pytest.raises(RuntimeError, match="crc32c"):
        port_convert.convert_tvt_datasets(tvt)


@pytest.mark.parametrize("saved,flag", [("GZIP", "GZIP"), ("GZIP", "auto"), (None, None),
                                        (None, "auto")])
@pytest.mark.parametrize("output", [False, True], ids=["in_place", "output_dir"])
def test_snapshots_convert_byte_equal_to_the_jax_package(tmp_path, saved, flag, output):
    tvt = _tvt(tmp_path, saved)
    got_jax, got_port, tree_jax, tree_port = _both(tmp_path, tvt, output, compression=flag,
                                                   shard_size=4)
    assert got_jax == got_port == {"train_dataset": 11, "val_dataset": 5}
    assert tree_jax.keys() == tree_port.keys()
    assert "train_dataset/spectrogram_00002.npy" in tree_port
    for name in tree_jax:
        assert tree_jax[name] == tree_port[name], name
    if output:
        assert tree_port["dataset_shapes.json"] == (tvt / "dataset_shapes.json").read_bytes()
        assert tree_port["call_weights.json"] == (tvt / "call_weights.json").read_bytes()


def test_a_wrong_compression_flag_raises_as_in_the_reference(tmp_path):
    tvt = _tvt(tmp_path, "GZIP")
    with pytest.raises(ValueError, match="Could not read tf.data snapshot") as err:
        port_convert.convert_tvt_datasets(tvt, compression=None)
    assert "00000000.snapshot record 0" in str(err.value)
    with pytest.raises(Exception, match="Could not read tf.data snapshot"):
        jax_convert.convert_tvt_datasets(tvt, compression=None, msgr=QUIET)


def test_two_dimensional_spectrograms_get_a_trailing_axis(tmp_path):
    tvt = _tvt(tmp_path, spec=SPEC[:2])
    (tvt / "dataset_shapes.json").unlink()
    got_jax, got_port, tree_jax, tree_port = _both(tmp_path, tvt)
    assert got_jax == got_port
    assert tree_jax == tree_port
    assert b'"spectrogram": [16, 5, 1]' in tree_port["dataset_shapes.json"]
    x = np.load(tmp_path / "port_tvt" / "train_dataset" / "spectrogram_00000.npy")
    assert x.shape == (11, *SPEC)


@pytest.mark.parametrize("n_shards", [3, multiprocessing.cpu_count() + 1])
def test_sharded_snapshots_come_in_dataset_load_order(tmp_path, n_shards):
    """Shards of unequal length through interleave(cycle_length=cpu_count):
    the port's order is tf.data's, also with more shards than CPUs."""
    n = 3 * n_shards + 4
    x, y = _arrays(n, seed=5)
    index = np.arange(n, dtype=np.float32)

    def by_index(i, a, b):  # the first three to shard 0: shards of unequal length
        i = tf.cast(i, tf.int64)
        return tf.where(i < 3, tf.constant(0, tf.int64), (i * 7) % n_shards)

    src = tmp_path / "indexed"
    tf.data.Dataset.from_tensor_slices((index, x, y)).save(
        str(src), compression="GZIP", shard_func=by_index)
    assert len(list(src.rglob("*.shard"))) == n_shards
    order = [int(e[0]) for e in tf.data.Dataset.load(str(src), compression="GZIP")]
    assert order != sorted(order)
    got = list(tfrecord.TFSnapshot(src, "GZIP"))
    assert [int(e[0]) for e in got] == order
    for i, xi, yi in got:
        assert np.array_equal(xi, x[int(i)]) and np.array_equal(yi, y[int(i)])

    tvt = tmp_path / "tvt"
    tf.data.Dataset.from_tensor_slices((x, y)).save(
        str(tvt / "train_dataset"), compression="GZIP",
        shard_func=lambda a, b: tf.cast(a[0, 0, 0] * 1000, tf.int64) % n_shards)
    assert len(list(tvt.rglob("*.shard"))) > 1
    got_jax, got_port, tree_jax, tree_port = _both(tmp_path, tvt)
    assert got_jax == got_port == {"train_dataset": n}
    assert tree_jax == tree_port


def test_resume_after_a_partial_run_and_overwrite(tmp_path, capsys):
    tvt = _tvt(tmp_path)
    copies = {}
    for side in ("jax", "port"):
        copies[side] = tmp_path / side
        shutil.copytree(tvt, copies[side])
    # a run cut after the first split
    jax_convert.convert_tf_dataset(copies["jax"] / "train_dataset", msgr=QUIET)
    port_convert.convert_tf_dataset(copies["port"] / "train_dataset")
    capsys.readouterr()
    got_port = port_convert.convert_tvt_datasets(copies["port"], msgr=PortMessenger(verbosity=1))
    assert "‼️ train_dataset already converted" in capsys.readouterr().out
    got_jax = jax_convert.convert_tvt_datasets(copies["jax"], msgr=QUIET)
    assert got_jax == got_port == {"val_dataset": 5}
    assert _tree(copies["jax"]) == _tree(copies["port"])
    assert port_convert.convert_tvt_datasets(copies["port"]) == {}
    with pytest.raises(FileExistsError):
        port_convert.convert_tf_dataset(copies["port"] / "val_dataset")
    # overwrite redoes both, byte-equal to the first run
    before = _tree(copies["port"])
    got = port_convert.convert_tvt_datasets(copies["port"], overwrite=True)
    assert got == {"train_dataset": 11, "val_dataset": 5}
    assert _tree(copies["port"]) == before


def test_refusals_match_the_reference(tmp_path):
    zero = tmp_path / "zero_tvt"
    zero.mkdir()
    x, y = _arrays(0, seed=1)
    _save(zero / "train_dataset", x, y)
    assert not list((zero / "train_dataset").rglob("*.shard"))  # no run dir at all
    assert len(tfrecord.TFSnapshot(zero / "train_dataset", "GZIP")) == 0
    for convert, kw in ((jax_convert.convert_tvt_datasets, {"msgr": QUIET}),
                        (port_convert.convert_tvt_datasets, {})):
        with pytest.raises(ValueError, match="Refusing to write an empty dataset"):
            convert(zero, **kw)
        assert not (zero / "train_dataset" / "meta.json").exists()
    not_snapshot = tmp_path / "plain"
    not_snapshot.mkdir()
    for convert_one in (lambda p: jax_convert.convert_tf_dataset(p, msgr=QUIET),
                        port_convert.convert_tf_dataset):
        with pytest.raises(FileNotFoundError, match="not a tf.data snapshot"):
            convert_one(not_snapshot)
    no_snapshots = tmp_path / "no_snapshots"
    (no_snapshots / "train_dataset").mkdir(parents=True)
    for convert, kw in ((jax_convert.convert_tvt_datasets, {"msgr": QUIET}),
                        (port_convert.convert_tvt_datasets, {})):
        with pytest.raises(FileNotFoundError, match="No tf.data snapshot dataset dirs"):
            convert(no_snapshots, **kw)
        with pytest.raises(NotADirectoryError):
            convert(tmp_path / "missing", **kw)


def _raw_shard(tvt: Path) -> Path:
    (shard,) = (tvt / "train_dataset").rglob("*.snapshot")
    return shard


@pytest.mark.parametrize("where", ["length", "length_crc", "data", "data_crc", "truncated"])
def test_a_flipped_byte_names_the_file_and_the_record(tmp_path, where):
    tvt = _tvt(tmp_path, None)
    shard = _raw_shard(tvt)
    raw = bytearray(shard.read_bytes())
    (first_len,) = struct.unpack_from("<Q", raw, 0)
    second = 16 + first_len  # the second record (element 0's labels)
    offsets = {"length": second + 1, "length_crc": second + 9, "data": second + 12 + 5,
               "data_crc": second + 12 + struct.unpack_from("<Q", raw, second)[0] + 1}
    if where == "truncated":
        raw = raw[:-3]
    else:
        raw[offsets[where]] ^= 0x10
    shard.write_bytes(bytes(raw))
    with pytest.raises(ValueError) as err:  # the probe's error wraps the DataLossError
        port_convert.convert_tvt_datasets(tvt, compression=None)
    assert str(shard) in str(err.value)
    if where != "truncated":
        assert "record 1" in str(err.value)
    # TensorFlow sees the same file as corrupt
    with pytest.raises(tf.errors.DataLossError):
        list(tf.data.Dataset.load(str(tvt / "train_dataset")).as_numpy_iterator())


def test_a_corrupted_gzip_stream_names_the_file(tmp_path):
    tvt = _tvt(tmp_path, "GZIP")
    shard = _raw_shard(tvt)
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=str(shard)):
        port_convert.convert_tvt_datasets(tvt, compression="GZIP")


def test_other_dtypes_versions_and_contents_raise(tmp_path):
    tvt = tmp_path / "tvt"
    tvt.mkdir()
    x, y = _arrays(4, seed=2)
    _save(tvt / "train_dataset", x, y.astype(np.int32))
    with pytest.raises(ValueError, match="only DT_FLOAT"):
        port_convert.convert_tvt_datasets(tvt)
    shutil.rmtree(tvt / "train_dataset")
    _save(tvt / "train_dataset", x, y, None)
    meta = tvt / "train_dataset" / "snapshot.metadata"
    data = meta.read_bytes()
    assert data.count(b" \x02") == 1  # field 4 (version), varint 2
    meta.write_bytes(data.replace(b" \x02", b" \x01"))
    with pytest.raises(ValueError, match="snapshot version 1"):
        port_convert.convert_tvt_datasets(tvt)
    meta.write_bytes(data)
    # element 0's spectrogram as a TensorProto with a shape and no content
    shard = _raw_shard(tvt)
    raw = shard.read_bytes()
    (n,) = struct.unpack_from("<Q", raw, 0)
    proto = bytes([0x08, 0x01, 0x12, 0x04, 0x12, 0x02, 0x08, 0x03])  # DT_FLOAT, shape [3]
    shard.write_bytes(record(proto) + raw[16 + n:])
    with pytest.raises(ValueError, match="record 0: tensor without tensor_content") as err:
        port_convert.convert_tvt_datasets(tvt)
    assert str(shard) in str(err.value)
    with pytest.raises(ValueError, match="TensorProto field 5"):
        tfrecord.parse_tensor(proto + bytes([0x2A, 0x04, 0, 0, 0x80, 0x3F]))


def test_cli_convert_dataset(tmp_path, capsys):
    tvt = _tvt(tmp_path)
    ref = tmp_path / "ref"
    shutil.copytree(tvt, ref)
    jax_convert.convert_tvt_datasets(ref, msgr=QUIET)
    assert port_main(["convert-dataset", str(tvt), "-dc", "gzip"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "🐳 Converted train_dataset (11 samples), val_dataset (5 samples) [")
    assert _tree(tvt) == _tree(ref)
    assert port_main(["convert-dataset", str(tvt)]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "🐳 Nothing to convert (all splits already converted) [")
    out = tmp_path / "out"
    assert port_main(["convert-dataset", str(tvt), "-o", str(out), "-ow", "-dc", "auto",
                      "-v", "0"]) == 0
    capsys.readouterr()
    assert _tree(out) == {k: v for k, v in _tree(ref).items() if k.endswith((".npy", ".json"))}
    with pytest.raises(SystemExit):
        port_main(["convert-dataset", str(tvt), "-dc", "zlib"])
