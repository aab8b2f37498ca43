"""The port's spectral wires (orcai_tpu_torch/ops/spectral.py, the C
resamplers of orcai_tpu_torch/native) against the JAX package's on the CPU,
and the sp-bfp5 golden predict through both packages.

Bars: bit-equal for the tap design, the resamplers (C and numpy), the lazy
ResampledStream, the geometry gates and the streaming predictor's regrid
(tests/test_spectral.py:206-245, 336-365); the golden TSV byte-equal to the
JAX package's and inside the reference's sp-bfp5 bar
(tests/test_spectral.py:369-466).
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from orcai_tpu.ops import spectral as ref
from orcai_tpu.ops.streaming import StreamingPredictor as JaxStreamingPredictor
from orcai_tpu_torch import native
from orcai_tpu_torch.ops import spectral as port
from orcai_tpu_torch.ops.streaming import StreamingPredictor, resolve_streaming_wire

FIXTURES = Path(__file__).parent / "fixtures"
SR, NFFT, HOP = 48000, 512, 256
PASS_HZ = 15937.5  # the highest retained bin for freq_range [0, 16000]
ROW_S = 16 * 256 / 48000
RATIOS = [(3, 4, PASS_HZ), (11, 16, PASS_HZ), (2, 3, 12000.0)]


def setup_module():
    torch.set_num_threads(1)


@pytest.mark.parametrize("L,M,pass_hz", RATIOS)
def test_design_taps_bit_equal_to_reference(L, M, pass_hz):
    got = port.design_taps(SR, pass_hz, L, M)
    np.testing.assert_array_equal(got, ref.design_taps(SR, pass_hz, L, M))
    assert got.dtype == np.int16 and not got.flags.writeable
    with pytest.raises(ValueError, match="no transition band"):
        port.design_taps(SR, 20000.0, 3, 4)


@pytest.mark.parametrize("L,M,pass_hz", RATIOS)
def test_resample_c_and_numpy_bit_equal_to_reference(L, M, pass_hz):
    assert native.native_available()
    taps = port.design_taps(SR, pass_hz, L, M)
    rng = np.random.default_rng(3)
    for n in (0, 1, M - 1, M, 12345, 100_001):
        x = rng.integers(-32768, 32768, n).astype(np.int16)
        if n > 4:  # the extremes reach the rounding clamp
            x[:4] = [-32768, 32767, -32768, 32767]
        n_out = L * n // M
        want = ref._resample_poly_numpy(x, taps, L, M, n_out)
        np.testing.assert_array_equal(port._resample_poly_numpy(x, taps, L, M, n_out), want)
        c = (native.resample34_native(x, taps, n_out) if (L, M) == (3, 4)
             else native.resample_poly_native(x, taps, L, M, n_out))
        assert c is not None
        np.testing.assert_array_equal(c, want)
        np.testing.assert_array_equal(port.resample_poly(x, SR, pass_hz, L, M),
                                      ref.resample_poly(x, SR, pass_hz, L, M))
    f = rng.uniform(-1, 1, 4001).astype(np.float32)  # float input: rounded first
    np.testing.assert_array_equal(port.resample_poly(f, SR, pass_hz, L, M),
                                  ref.resample_poly(f, SR, pass_hz, L, M))


def test_resample_without_the_native_library(monkeypatch):
    x = np.random.default_rng(4).integers(-32768, 32768, 5000).astype(np.int16)
    want = ref.resample_poly(x, SR, PASS_HZ, 3, 4)
    monkeypatch.setenv("ORCAI_TPU_DISABLE_NATIVE", "1")
    native._load.cache_clear()
    try:
        assert native.resample34_native(x, port.design_taps(SR, PASS_HZ), 3750) is None
        np.testing.assert_array_equal(port.resample_poly(x, SR, PASS_HZ, 3, 4), want)
    finally:
        monkeypatch.delenv("ORCAI_TPU_DISABLE_NATIVE")
        native._load.cache_clear()


@pytest.mark.parametrize("sr,n_fft,hop,freq_range,L,M", [
    (SR, NFFT, HOP, [0, 16000], 3, 4),
    (SR, NFFT, HOP, [0, 16000], 11, 16),
    (44102, NFFT, HOP, [0, 16000], 3, 4),
    (44100, NFFT, HOP, [0, 16000], 3, 4),
    (44100, NFFT, HOP, [0, 16000], 11, 16),
    (SR, NFFT, HOP, [0, 17900], 3, 4),
    (SR, NFFT, HOP, [0, 99000], 3, 4),
    (SR, 400, 100, [0, 16000], 3, 4),
    (SR, 512, 100, [0, 16000], 3, 4),
])
def test_spectral_geometry_matches_reference(sr, n_fft, hop, freq_range, L, M):
    assert (port.spectral_geometry(sr, n_fft, hop, freq_range, L, M)
            == ref.spectral_geometry(sr, n_fft, hop, freq_range, L, M))
    x = np.random.default_rng(5).integers(-20000, 20000, sr // 2).astype(np.int16)
    got = port.spectral_downsample(x, sr, n_fft, hop, freq_range, ratio=(L, M))
    want = ref.spectral_downsample(x, sr, n_fft, hop, freq_range, ratio=(L, M))
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("L,M", [(3, 4), (11, 16)])
def test_resampled_stream_slices_match_reference_and_whole(L, M):
    rng = np.random.default_rng(6)
    x = rng.integers(-30000, 30000, 60_001).astype(np.int16)
    ours = port.ResampledStream(x, SR, PASS_HZ, L, M)
    theirs = ref.ResampledStream(x, SR, PASS_HZ, L, M)
    whole = port.resample_poly(x, SR, PASS_HZ, L, M)
    assert ours.shape == theirs.shape == whole.shape and len(ours) == len(whole)
    assert ours.nbytes == theirs.nbytes and ours.dtype == np.int16
    for a, b in ((0, 1), (0, 5000), (1, 4097), (777, 21_000), (len(whole) - 300, len(whole)),
                 (len(whole) - 5, len(whole) + 50), (10, 10)):
        got = ours[a:b]
        np.testing.assert_array_equal(got, theirs[a:b])
        np.testing.assert_array_equal(got, whole[a:b])
    with pytest.raises(TypeError):
        ours[::2]


class _WP:  # geometry-only stand-in, as the reference's tests use
    batch_size = 8
    snippet_len = 16
    shift = 4
    down = 16


@pytest.mark.parametrize("freq_range", [[0, 16000], [0, 20000]])
@pytest.mark.parametrize("wire", [None, "exact", "mulaw8", "bfp6", "bfp5", "sp-bfp6",
                                  "sp-bfp5", "sp11-bfp5"])
def test_streaming_wire_resolution_matches_reference(wire, freq_range, monkeypatch):
    """tests/test_spectral.py:336-365 and :606-620: the regrid where the
    grid holds, the base codec at the native rate where it does not."""
    monkeypatch.delenv("ORCAI_TPU_WIRE", raising=False)
    sp = dict(sampling_rate=SR, nfft=NFFT, n_overlap=HOP, freq_range=freq_range,
              quantiles=[0.01, 0.999])
    ours, theirs = StreamingPredictor(_WP(), sp, wire=wire), JaxStreamingPredictor(
        _WP(), sp, wire=wire)
    for name in ("wire_label", "wire", "sr", "n_fft", "hop", "_resample", "lo_idx", "hi_idx"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert resolve_streaming_wire(sp, wire)[0] == ours.wire_label


def test_streaming_regrid_geometry_of_the_spectral_wires():
    sp = dict(sampling_rate=SR, nfft=NFFT, n_overlap=HOP, freq_range=[0, 16000],
              quantiles=[0.01, 0.999])
    s = StreamingPredictor(_WP(), sp, wire="sp-bfp5")
    assert (s.wire_label, s.wire, s.sr, s.n_fft, s.hop) == ("sp-bfp5", "bfp5", 36000, 384, 192)
    assert s._resample == (48000, 15937.5, 3, 4)
    s11 = StreamingPredictor(_WP(), sp, wire="sp11-bfp5")
    assert (s11.sr, s11.n_fft, s11.hop, s11._resample) == (33000, 352, 176,
                                                           (48000, 15937.5, 11, 16))


@pytest.fixture(scope="module")
def sp_bfp5_golden(tmp_path_factory):
    """The golden wav through both packages' predict on sp-bfp5 (sp-bfp6
    and sp11-bfp5 are held at the spectrogram level in
    tests/test_torch_frontend.py)."""
    from orcai_tpu.pipeline.predict import predict as jax_predict
    from orcai_tpu.resources import MODELS_DATA_DIR
    from orcai_tpu.utils import Messenger
    from orcai_tpu_torch.pipeline.predict import predict

    tmp = tmp_path_factory.mktemp("sp_golden")
    ours = predict(FIXTURES / "golden.wav", output_path=tmp / "port.txt",
                   predict_batch_size=16, device="cpu", wire="sp-bfp5")
    theirs = tmp / "jax.txt"
    jax_predict(FIXTURES / "golden.wav", model_dir=MODELS_DATA_DIR / "orcai-v1",
                output_path=theirs, overwrite=True, msgr=Messenger(verbosity=0),
                verbosity=0, predict_batch_size=16, wire="sp-bfp5")
    return ours, theirs


def test_golden_sp_bfp5_byte_equal_to_the_jax_package(sp_bfp5_golden):
    ours, theirs = sp_bfp5_golden
    assert ours.read_bytes() == theirs.read_bytes()


def test_golden_sp_bfp5_inside_the_reference_bar(sp_bfp5_golden):
    """tests/test_spectral.py:446-466: every golden call matched (label,
    both boundaries within two aggregation rows), at most two residual
    predictions, each shorter than 0.5 s."""
    def frame(path):
        f = pd.read_csv(path, sep="\t")
        return f[f["stop"] > f["start"]].reset_index(drop=True)

    got, expected = frame(sp_bfp5_golden[0]), frame(FIXTURES / "golden_expected.txt")
    tol = 2 * ROW_S
    used = set()
    for _, e in expected.iterrows():
        hit = next((j for j, g in got.iterrows() if j not in used and g["label"] == e["label"]
                    and abs(g["start"] - e["start"]) <= tol
                    and abs(g["stop"] - e["stop"]) <= tol), None)
        assert hit is not None, f"golden call lost under sp-bfp5: {dict(e)}"
        used.add(hit)
    residual = got[~got.index.isin(used)]
    assert len(residual) <= 2, residual.to_string()
    assert ((residual["stop"] - residual["start"]) < 0.5).all(), residual.to_string()
