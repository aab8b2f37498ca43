"""The port's wire codecs (orcai_tpu_torch/ops/wire_codec.py, the C encoders
of orcai_tpu_torch/native and tools/parity.py) against the JAX package's on
the CPU, and the coded wires' golden predict through both packages.

Bars: bit-equal for the tables, the encoders (C and numpy), the device
decoders and the wire arithmetic (tests/test_wire_codec.py); the golden
TSV of each coded wire byte-equal to the JAX package's TSV for the same
wire, and inside the reference's own bar against golden_expected.txt
(tests/test_wire_codec.py:197-225, 405-440).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from orcai_tpu.ops import wire_codec as ref
from orcai_tpu.tools import parity as ref_parity
from orcai_tpu_torch import native
from orcai_tpu_torch.ops import wire_codec as port
from orcai_tpu_torch.ops.wire_names import WIRE_CODECS
from orcai_tpu_torch.tools import parity

FIXTURES = Path(__file__).parent / "fixtures"
ROW_S = 16 * 256 / 48000  # one aggregation row of orcai-v1


def setup_module():
    torch.set_num_threads(1)


def _signal(n=200_000, seed=5):
    """Mixed levels: a tone, noise and a loud second half (the reference's
    bfp test signal), so block shifts vary along the recording."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (9000 * np.sin(2 * np.pi * 0.06 * t) + 1500 * rng.standard_normal(n)
         + 20000 * np.sin(2 * np.pi * 0.2 * t) * (t > n // 2))
    return np.clip(x, -32768, 32767).astype(np.int16)


def test_registry_and_arithmetic_match_reference():
    assert WIRE_CODECS == ref.WIRE_CODECS == port.WIRE_CODECS
    for wire in WIRE_CODECS:
        assert port.wire_bytes_per_sample(wire) == ref.wire_bytes_per_sample(wire)
        assert port.wire_bfp_bits(wire) == ref.wire_bfp_bits(wire)
        assert port.spectral_wire_base(wire) == ref.spectral_wire_base(wire)
        if ref.spectral_wire_base(wire) is not None:
            assert port.spectral_wire_ratio(wire) == ref.spectral_wire_ratio(wire)
        else:
            with pytest.raises(ValueError):
                port.spectral_wire_ratio(wire)
    for bits in (6, 5):
        assert port.bfp_bytes_per_sample(bits) == ref.bfp_bytes_per_sample(bits)
        assert port.bfp_block_bytes(bits) == ref.bfp_block_bytes(bits)
    for n_fft, hop in ((512, 256), (512, 100), (400, 256), (384, 192)):
        assert port.bfp_streaming_aligned(n_fft, hop) == ref.bfp_streaming_aligned(n_fft, hop)


def test_mulaw_tables_match_reference():
    np.testing.assert_array_equal(port.decode_table_int16(), ref.decode_table_int16())
    np.testing.assert_array_equal(port.encode_table(), ref.encode_table())


@pytest.mark.parametrize("native_path", [True, False])
def test_mulaw_encode_matches_reference(native_path):
    rng = np.random.default_rng(0)
    x = rng.integers(-32768, 32768, 100_001).astype(np.int16)
    x[:3] = (-32768, 0, 32767)
    want = ref.mulaw_encode(x, native=False)
    np.testing.assert_array_equal(port.mulaw_encode(x, native=native_path), want)
    f = rng.uniform(-1, 1, 4097).astype(np.float32)
    np.testing.assert_array_equal(port.mulaw_encode(f, native=native_path),
                                  ref.mulaw_encode(f, native=False))
    # every int16 value: the LUT is total
    every = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)
    np.testing.assert_array_equal(port.mulaw_encode(every, native=native_path),
                                  ref.mulaw_encode(every, native=False))


def test_mulaw_decode_f32_bit_equal_to_jnp_over_all_codes():
    codes = np.arange(256, dtype=np.uint8)
    got = port.mulaw_decode_f32(torch.from_numpy(codes))
    assert got.dtype == torch.float32
    want = np.asarray(ref.mulaw_decode_f32(jnp.asarray(codes)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), port.decode_table_int16().astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(port.mulaw_decode_host(codes), ref.mulaw_decode_host(codes))


@pytest.mark.parametrize("bits", [6, 5])
@pytest.mark.parametrize("native_path", [True, False])
def test_bfp_encode_and_decode_match_reference(bits, native_path):
    x = _signal()[: 100_000 + 37]  # a partial last block
    pk, sh = port.bfp_encode(x, bits, native=native_path)
    pk_r, sh_r = ref.bfp_encode(x, bits, native=False)
    np.testing.assert_array_equal(pk, pk_r)
    np.testing.assert_array_equal(sh, sh_r)
    host = port.bfp_decode_host(pk, sh, bits)
    np.testing.assert_array_equal(host, ref.bfp_decode_host(pk_r, sh_r, bits))
    dev = port.bfp_decode_i16(torch.from_numpy(pk), torch.from_numpy(sh), bits)
    assert dev.dtype == torch.int16
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_array_equal(
        dev.numpy(), np.asarray(ref.bfp_decode_i16(jnp.asarray(pk), jnp.asarray(sh), bits)))
    # float input is rounded to int16 first, as every wire does
    f = x[:4 * 128].astype(np.float32) / 32768.0
    np.testing.assert_array_equal(port.bfp_encode(f, bits, native=native_path)[0],
                                  ref.bfp_encode(f, bits, native=False)[0])


@pytest.mark.parametrize("bits", [6, 5])
@pytest.mark.parametrize("native_path", [True, False])
def test_bfp_wire_buffer_matches_reference(bits, native_path):
    x = _signal(seed=7)[: 50_000 + 5]
    buf = port.bfp_encode_wire(x, bits, native=native_path)
    np.testing.assert_array_equal(buf, ref.bfp_encode_wire(x, bits, native=False))
    pk, sh = port.bfp_wire_split(buf, bits)
    np.testing.assert_array_equal(np.concatenate([pk, sh]), buf)
    dec = port.bfp_decode_wire_i16(torch.from_numpy(buf), bits)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(ref.bfp_decode_wire_i16(jnp.asarray(buf), bits)))


@pytest.mark.parametrize("bits", [6, 5])
def test_bfp_zero_bytes_decode_to_silence(bits):
    z = torch.zeros(3 * port.bfp_block_bytes(bits), dtype=torch.uint8)
    assert not port.bfp_decode_i16(z, torch.zeros(3, dtype=torch.uint8), bits).any()
    pk, sh = port.bfp_encode(np.zeros(3 * 128, np.int16), bits)
    assert not pk.any() and not sh.any()


def test_resolve_wire_matches_reference_off_the_tpu(monkeypatch):
    monkeypatch.delenv("ORCAI_TPU_WIRE", raising=False)
    for wire in (None, "auto", *WIRE_CODECS):
        for backend in ("cpu", "gpu"):
            assert port.resolve_wire(wire) == ref.resolve_wire(wire, backend=backend)
    assert port.resolve_wire("auto") == "exact"
    with pytest.raises(ValueError, match="unknown wire codec"):
        port.resolve_wire("gzip")
    monkeypatch.setenv("ORCAI_TPU_WIRE", "mulaw8")
    assert port.resolve_wire(None) == ref.resolve_wire(None, backend="cpu") == "mulaw8"
    assert port.resolve_wire("bfp5") == "bfp5"  # an explicit request beats the variable


def test_native_library_is_loaded_and_agrees():
    assert native.native_available()
    x = _signal(seed=3)[:10_000]
    assert native.mulaw_encode_native(x, port.encode_table()) is not None
    assert native.bfp_encode_native(x, 5, 128, 80) is not None
    with pytest.raises(ValueError, match="native bfp encoder"):
        native.bfp_encode_native(x, 4, 128, 64)
    pk, sh = np.empty(10, np.uint8), np.empty(79, np.uint8)
    with pytest.raises(ValueError, match="packed_out"):
        native.bfp_encode_into(x, 5, 128, pk, sh)


def test_without_the_native_library_the_numpy_paths_run(monkeypatch):
    x = _signal(seed=4)[:5_000]
    want = port.bfp_encode_wire(x, 6), port.mulaw_encode(x)
    monkeypatch.setenv("ORCAI_TPU_DISABLE_NATIVE", "1")
    native._load.cache_clear()
    try:
        assert not native.native_available()
        assert native.mulaw_encode_native(x, port.encode_table()) is None
        assert not native.bfp_encode_into(x, 6, 128, np.empty(0, np.uint8),
                                          np.empty(0, np.uint8))
        np.testing.assert_array_equal(port.bfp_encode_wire(x, 6), want[0])
        np.testing.assert_array_equal(port.mulaw_encode(x), want[1])
    finally:
        monkeypatch.delenv("ORCAI_TPU_DISABLE_NATIVE")
        native._load.cache_clear()
    assert native.native_available()


def _tsv(tmp_path, name, rows):
    path = tmp_path / name
    path.write_text("start\tstop\tlabel\n" + "".join(f"{a}\t{b}\t{c}\n" for a, b, c in rows))
    return path


def test_parity_tool_matches_reference(tmp_path):
    exact = _tsv(tmp_path, "e.txt", [(0.5, 3.0, "SS*"), (4.0, 4.1, "BR*"), (5.0, 9.0, "BR*"),
                                     (5.0, 9.0, "BR*"), (10.0, 10.7495, "PHS*")])
    coded = _tsv(tmp_path, "c.txt", [(0.5, 3.0, "SS*"), (5.1, 9.1, "BR*"), (5.0, 9.0, "BR*"),
                                     (11.0, 12.0, "HERDING*")])
    for a, b in ((coded, exact), (exact, coded), (exact, exact)):
        got = parity.compare_annotations(a, b)
        want = ref_parity.compare_annotations(a, b)
        assert got == want
        for minutes in (1.0, 60.0):
            assert parity.check_wire_parity(got, minutes) == ref_parity.check_wire_parity(
                want, minutes)
    assert parity.read_annotations(exact) == ref_parity.read_annotations(exact)
    param = {"spectrogram": {"n_overlap": 256, "sampling_rate": 48000},
             "model": {"filters": [1, 2, 3, 4]}}
    assert parity.row_seconds_for(param) == ref_parity.row_seconds_for(param) == ROW_S


def _golden_frames(path):
    frame = pd.read_csv(path, sep="\t")
    return frame[frame["stop"] > frame["start"]].reset_index(drop=True)


@pytest.fixture(scope="module")
def golden_predicts(tmp_path_factory):
    """The golden wav through both packages' predict on mulaw8 and bfp5 (the
    other coded wires are held at the spectrogram level in
    tests/test_torch_frontend.py); {wire: (port TSV, JAX TSV)}."""
    from orcai_tpu.pipeline.predict import predict as jax_predict
    from orcai_tpu.resources import MODELS_DATA_DIR
    from orcai_tpu.utils import Messenger
    from orcai_tpu_torch.pipeline.predict import predict

    tmp = tmp_path_factory.mktemp("wire_golden")
    out = {}
    for wire in ("mulaw8", "bfp5"):
        ours = predict(FIXTURES / "golden.wav", output_path=tmp / f"port_{wire}.txt",
                       predict_batch_size=16, device="cpu", wire=wire)
        theirs = tmp / f"jax_{wire}.txt"
        jax_predict(FIXTURES / "golden.wav", model_dir=MODELS_DATA_DIR / "orcai-v1",
                    output_path=theirs, overwrite=True, msgr=Messenger(verbosity=0),
                    verbosity=0, predict_batch_size=16, wire=wire)
        out[wire] = ours, theirs
    return out


@pytest.mark.parametrize("wire", ["mulaw8", "bfp5"])
def test_golden_tsv_byte_equal_to_the_jax_package(golden_predicts, wire):
    ours, theirs = golden_predicts[wire]
    assert ours.read_bytes() == theirs.read_bytes()


def test_golden_mulaw8_inside_the_reference_bar(golden_predicts):
    """tests/test_wire_codec.py:197-225: equal to golden_expected.txt once
    zero-length rows are dropped."""
    got = _golden_frames(golden_predicts["mulaw8"][0])
    pd.testing.assert_frame_equal(got, _golden_frames(FIXTURES / "golden_expected.txt"))


# where bfp5 at the native rate departs from the golden annotations, in both
# packages alike (its TSV is byte-equal to the JAX package's): the HERDING
# call splits around a dip at 3.16-3.33 s, and the zero-length WHISTLE at
# 54.784 s becomes one aggregation row long. The reference sets its golden
# bar for bfp6 only (tests/test_wire_codec.py:405-440); ROADMAP C records it.
BFP5_SPLIT = [(0.9387, 3.1573, "HERDING*"), (3.328, 6.0587, "HERDING*")]
BFP5_GROWN = [(54.6987, 54.784, "WHISTLE*")]
GOLDEN_SPLIT = [(0.9387, 6.0587, "HERDING*")]


def test_golden_bfp5_departs_from_the_bfp6_bar_only_at_named_rows(golden_predicts):
    """Outside the named rows, tests/test_wire_codec.py:405-440's bar: the
    same labels, every boundary within two aggregation rows."""
    got = _golden_frames(golden_predicts["bfp5"][0])
    expected = _golden_frames(FIXTURES / "golden_expected.txt")

    def without(frame, rows):
        keep = [tuple(r) not in rows for r in frame[["start", "stop", "label"]].itertuples(
            index=False)]
        assert len(keep) - sum(keep) == len(rows), f"{rows} not all in {frame}"
        return frame[keep].reset_index(drop=True)

    got = without(got, BFP5_SPLIT + BFP5_GROWN)
    expected = without(expected, GOLDEN_SPLIT)
    assert list(got["label"]) == list(expected["label"])
    for col in ("start", "stop"):
        np.testing.assert_allclose(got[col], expected[col], atol=2 * ROW_S)
