"""The port's zarr stores, blosc codec and CSV tables against the JAX
package's: each reads the other's stores, zarr.json is text-equal and the
chunk files byte-equal for gzip and blosc-lz4, and the tables' text is what
pandas writes."""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from orcai_tpu.io import blosc as jax_blosc
from orcai_tpu.io import jsonio as jax_jsonio
from orcai_tpu.io import zarrlite as jax_zarr
from orcai_tpu_torch import native
from orcai_tpu_torch.io import blosc, jsonio, zarrlite
from orcai_tpu_torch.io.tables import Table, isna

FIXTURES = Path(__file__).resolve().parent / "fixtures"
CODECS = ["gzip", "blosc-lz4", None]


def _array(seed=0, shape=(4501, 171)):
    """Spectrogram-like float32: smooth rows in [0, 1] with repeats, so the
    codecs find matches, and an edge chunk of 501 rows."""
    rng = np.random.default_rng(seed)
    base = np.round(rng.uniform(size=shape), 3).astype(np.float32)
    base[::7] = base[0]
    return base


def _files(path: Path) -> dict[str, bytes]:
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("codec", CODECS, ids=str)
def test_port_reads_jax_stores(tmp_path, codec):
    arr = _array(1)
    jax_zarr.save_as_zarr(arr, tmp_path / "z", compress=codec)
    z = zarrlite.open_zarr(tmp_path / "z")
    np.testing.assert_array_equal(z[:], arr)
    np.testing.assert_array_equal(z[1990:2010, 5:9], arr[1990:2010, 5:9])


@pytest.mark.parametrize("codec", CODECS, ids=str)
def test_jax_reads_port_stores(tmp_path, codec):
    arr = _array(2)
    zarrlite.save_as_zarr(arr, tmp_path / "z", compress=codec)
    np.testing.assert_array_equal(jax_zarr.open_zarr(tmp_path / "z")[:], arr)


@pytest.mark.parametrize("codec", CODECS, ids=str)
def test_store_files_byte_equal(tmp_path, codec):
    arr = _array(3)
    jax_zarr.save_as_zarr(arr, tmp_path / "jax", compress=codec)
    zarrlite.save_as_zarr(arr, tmp_path / "port", compress=codec)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(a) == sorted(b) and len(a) == 4  # zarr.json + 3 chunks
    assert a["zarr.json"].decode() == b["zarr.json"].decode()
    for name in a:
        assert a[name] == b[name], name


def test_label_store_byte_equal(tmp_path):
    labels = np.zeros((3001, 7))
    labels[100:400, 2] = 1
    labels[:, 5] = -1.0
    jax_zarr.save_as_zarr(labels, tmp_path / "jax", compress="auto")
    zarrlite.save_as_zarr(labels, tmp_path / "port", compress="auto")
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")


def test_port_reads_committed_blosc_fixture():
    z = zarrlite.open_zarr(FIXTURES / "blosc_store")
    np.testing.assert_array_equal(z[:], np.load(FIXTURES / "blosc_store_expected.npy"))


def test_native_lz4_builds_and_matches_the_python_codec():
    assert native.native_available()
    assert native.library_path().parent.name == "_build"
    data = _array(4, (300, 171)).tobytes()
    fast = blosc.lz4_compress_block(data)
    assert fast == jax_blosc.lz4_compress_block(data)
    for enc in (fast, jax_blosc.lz4_compress_block(data, native=False)):
        assert blosc.lz4_decompress_block(enc, len(data)) == data
        assert blosc.lz4_decompress_block(enc, len(data), native=False) == data
    with pytest.raises(ValueError):
        blosc.lz4_decompress_block(b"\x1f\x00\x00\x05\x00", 64)


def test_blosc_lz4_refuses_to_write_without_the_c_encoder(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "lz4_compress_native", lambda src: None)
    with pytest.raises(RuntimeError, match="C LZ4 encoder"):
        zarrlite.save_as_zarr(_array(7, (50, 9)), tmp_path / "z", compress="blosc-lz4")
    frame = blosc.blosc_compress(_array(7, (50, 9)).tobytes(), typesize=4, cname="zlib")
    assert blosc.blosc_decompress(frame) == _array(7, (50, 9)).tobytes()


@pytest.mark.parametrize("cname", ["lz4", "zlib"])
@pytest.mark.parametrize("typesize", [1, 4, 8])
def test_blosc_frames_equal_the_jax_package(cname, typesize):
    data = _array(5, (700, 33)).tobytes()[: 700 * 33 * 4 // typesize * typesize]
    frame = blosc.blosc_compress(data, typesize=typesize, cname=cname)
    assert frame == jax_blosc.blosc_compress(data, typesize=typesize, cname=cname)
    assert blosc.blosc_decompress(frame) == data
    assert blosc.blosc_decompress(jax_blosc.blosc_compress(data, typesize, cname)) == data


def test_codec_policy_and_env_override(monkeypatch):
    monkeypatch.delenv("ORCAI_TPU_ZARR_CODEC", raising=False)
    assert zarrlite.resolve_zarr_codec("auto") == "blosc-lz4"  # the C encoder loads
    assert zarrlite.resolve_zarr_codec(True) == "gzip"
    assert zarrlite.resolve_zarr_codec(None) is None
    for env, want in (("gzip", "gzip"), ("none", None), ("blosc-lz4", "blosc-lz4")):
        monkeypatch.setenv("ORCAI_TPU_ZARR_CODEC", env)
        assert zarrlite.resolve_zarr_codec("auto") == want
        assert jax_zarr.resolve_zarr_codec("auto") == want
    with pytest.raises(ValueError, match="unsupported zarr codec"):
        zarrlite.resolve_zarr_codec("lz4")


def test_auto_codec_falls_back_to_gzip_without_the_encoder(monkeypatch):
    monkeypatch.delenv("ORCAI_TPU_ZARR_CODEC", raising=False)
    monkeypatch.setattr(native, "native_available", lambda: False)
    assert zarrlite.resolve_zarr_codec("auto") == "gzip"


@pytest.mark.parametrize("n", [1, 2, 225001])
def test_vector_json_text_equal(tmp_path, n):
    times = np.arange(n) * (256 / 48000)
    freqs = np.linspace(0.0, 24000.0, 257)
    for name, vec in (("times", times), ("freqs", freqs)):
        jax_jsonio.write_vector_to_json(vec, tmp_path / f"j_{name}.json")
        jsonio.write_vector_to_json(vec, tmp_path / f"p_{name}.json")
        assert (tmp_path / f"j_{name}.json").read_text() == (tmp_path / f"p_{name}.json").read_text()
        np.testing.assert_array_equal(
            jsonio.generate_times_from_spectrogram(tmp_path / f"p_{name}.json"),
            jax_jsonio.generate_times_from_spectrogram(tmp_path / f"j_{name}.json"))


CSV_TEXT = (
    "recording,channel,duplicate,base_dir,note,A,B,C,x\n"
    "r1,1,False,/d,\"a,b\",True,1,,0.1\n"
    "r2,2,True,/d,,False,,,1e-05\n"
    "NA,1,False,,n,,0,,2\n"
)


@pytest.mark.parametrize("gz", [False, True])
def test_table_read_and_write_as_pandas(tmp_path, gz):
    src = tmp_path / "in.csv"
    src.write_text(CSV_TEXT)
    frame = pd.read_csv(src)
    table = Table.read_csv(src)
    assert table.names == list(frame.columns)
    for name in frame.columns:
        np.testing.assert_array_equal(isna(table[name]), frame[name].isna().to_numpy(),
                                      err_msg=name)
        if frame[name].dtype.kind in "ifb":
            assert table[name].dtype == frame[name].dtype, name
    suffix = ".csv.gz" if gz else ".csv"
    frame.to_csv(tmp_path / f"pandas{suffix}", index=False)
    table.to_csv(tmp_path / f"port{suffix}", index=False)
    assert (pd.read_csv(tmp_path / f"port{suffix}").to_csv(index=False)
            == pd.read_csv(tmp_path / f"pandas{suffix}").to_csv(index=False))
    if not gz:
        assert (tmp_path / "port.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    indexed = Table.read_csv(src, index_col="recording")
    indexed.to_csv(tmp_path / "indexed.csv")
    pd.read_csv(src, index_col="recording").to_csv(tmp_path / "indexed_pd.csv")
    assert (tmp_path / "indexed.csv").read_text() == (tmp_path / "indexed_pd.csv").read_text()


def test_zarr_json_is_the_reference_layout(tmp_path):
    zarrlite.save_as_zarr(_array(6, (10, 3)), tmp_path / "z", compress="gzip")
    meta = json.loads((tmp_path / "z" / "zarr.json").read_text())
    assert meta["chunk_grid"]["configuration"]["chunk_shape"] == [10, 3]
    assert [c["name"] for c in meta["codecs"]] == ["bytes", "gzip"]
