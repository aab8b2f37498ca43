"""Port two-pass streaming predict (orcai_tpu_torch/ops/streaming.py) on the
CPU: against the port's in-memory path (counts equal, aggregate atol 1e-5,
tests/test_streaming.py:64-134), against the JAX StreamingPredictor on the
same audio and weights (counts equal, aggregate atol 1e-4: the spectrogram
bar of 2e-4 passes through the CRNN), its pass-1 statistics bit-equal to a
sort of its own magnitudes, and the int64 pick above 2**31."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.ops.overlap import WindowPredictor as JaxWindowPredictor
from orcai_tpu.ops.streaming import (
    StreamingPredictor as JaxStreamingPredictor,
    _AudioSource as JaxAudioSource,
)
from orcai_tpu_torch.io.model_store import convert_flax_variables
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.ops import streaming as tstreaming
from orcai_tpu_torch.ops.dft import dft_magnitude
from orcai_tpu_torch.ops.frontend import compute_spectrogram, nearest_quantile_index
from orcai_tpu_torch.ops.overlap import WindowPredictor
from orcai_tpu_torch.ops.radix_select import radix_pick_plain
from orcai_tpu_torch.ops.streaming import StreamingPredictor, _AudioSource, pick_int64

PARAM = {
    "name": "tiny",
    "architecture": "ResNetLSTM",
    "model": {"filters": [4, 6, 8, 10], "kernel_size": 3, "dropout_rate": 0.5,
              "lstm_units": 8},
    "calls": ["A", "B", "C"],
}
SNIPPET, NFILT, NBINS = 64, 4, 21
SP = {
    "sampling_rate": 4800,
    "nfft": 48,
    "n_overlap": 24,  # the reference schema's name for the hop length
    "freq_range": [0, 2100],  # 21 cropped bins
    "quantiles": [0.01, 0.999],
}


def setup_module():
    torch.set_num_threads(1)


def _pair(param, snippet, seed):
    """(JAX model, its variables, the port's model) with the same random
    weights, drawn with numpy."""
    jmodel = jax_build_model(param)
    template = jmodel.init(jax.random.key(0), jnp.zeros((1, snippet, NBINS, 1)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if "var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, template)
    model = build_model(param, (snippet, NBINS, 1))
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def models():
    return _pair(PARAM, SNIPPET, 0)


def _predictor(model, snippet=SNIPPET, nfilt=NFILT):
    return WindowPredictor(model, snippet_len=snippet, n_filters=nfilt,
                           batch_size=4, max_windows_per_chunk=16)


def _in_memory(model, audio, snippet=SNIPPET, nfilt=NFILT):
    spec, _, _ = compute_spectrogram(
        audio, SP["sampling_rate"], SP["nfft"], SP["n_overlap"],
        SP["freq_range"], SP["quantiles"], device="cpu",
    )
    assert spec.shape[1] == NBINS
    return _predictor(model, snippet, nfilt).aggregate(spec)


def _audio(seed, n=24_000, kind="f32"):
    rng = np.random.default_rng(seed)
    if kind == "int16":
        return (rng.uniform(-0.5, 0.5, size=n) * 32767).astype(np.int16)
    return (rng.uniform(-1, 1, size=n) * 0.5).astype(np.float32)


@pytest.mark.parametrize("kind", ["f32", "int16"])
@pytest.mark.parametrize("stats_tile_frames", [128, 256])
@pytest.mark.parametrize("hbm_audio_budget", [1 << 40, 0])
def test_streaming_matches_in_memory(models, hbm_audio_budget, stats_tile_frames, kind):
    """24000 samples: 1001 frames, 29 windows, many stats tiles with a
    masked tail, four chunks; the audio resident and host-sliced."""
    _, _, model = models
    audio = _audio(0, kind=kind)
    agg0, cnt0 = _in_memory(model, audio)
    streaming = StreamingPredictor(
        _predictor(model), SP, windows_per_chunk=8,
        stats_tile_frames=stats_tile_frames, hbm_audio_budget=hbm_audio_budget,
    )
    agg1, cnt1 = streaming.aggregate(audio)
    assert agg1.shape == agg0.shape
    np.testing.assert_array_equal(cnt1, cnt0)
    np.testing.assert_allclose(agg1, agg0, atol=1e-5, rtol=0)


def test_streaming_matches_in_memory_alt_geometry():
    """Another trunk depth and snippet length (down = 8)."""
    snippet, filters = 48, [4, 6, 8]
    param = {**PARAM, "model": {**PARAM["model"], "filters": filters}}
    _, _, model = _pair(param, snippet, 2)
    audio = _audio(3, n=18_000)
    agg0, cnt0 = _in_memory(model, audio, snippet, len(filters))
    streaming = StreamingPredictor(
        _predictor(model, snippet, len(filters)), SP,
        windows_per_chunk=8, stats_tile_frames=128,
    )
    agg1, cnt1 = streaming.aggregate(audio)
    np.testing.assert_array_equal(cnt1, cnt0)
    np.testing.assert_allclose(agg1, agg0, atol=1e-5, rtol=0)


def test_streaming_too_short_raises(models):
    streaming = StreamingPredictor(_predictor(models[2]), SP)
    with pytest.raises(ValueError, match="too short"):
        streaming.aggregate(np.zeros(SNIPPET, np.float32))


def test_odd_stats_tile_rejected(models):
    with pytest.raises(ValueError, match="even"):
        StreamingPredictor(_predictor(models[2]), SP, stats_tile_frames=127)


@pytest.mark.parametrize("kind", ["f32", "int16"])
@pytest.mark.parametrize("hbm_audio_budget", [1 << 40, 0])
def test_streaming_matches_jax_streaming(models, hbm_audio_budget, kind, capsys):
    jmodel, variables, model = models
    audio = _audio(5, kind=kind)
    kw = dict(windows_per_chunk=8, stats_tile_frames=128,
              hbm_audio_budget=hbm_audio_budget)
    ref = JaxStreamingPredictor(
        JaxWindowPredictor(jmodel, variables, snippet_len=SNIPPET, n_filters=NFILT,
                           batch_size=4, max_windows_per_chunk=16, dense_trunk=False),
        SP, wire="exact", **kw,
    )
    ref_agg, ref_cnt = ref.aggregate(audio)
    agg, cnt = StreamingPredictor(_predictor(model), SP, **kw).aggregate(audio)
    assert agg.shape == ref_agg.shape
    np.testing.assert_array_equal(cnt, ref_cnt)
    with capsys.disabled():
        print(f"\nport vs JAX streaming aggregate ({kind}, budget {hbm_audio_budget}): "
              f"max abs diff {np.abs(agg - ref_agg).max():.3e}")
    np.testing.assert_allclose(agg, ref_agg, atol=1e-4, rtol=0)


def _own_magnitudes(streaming, source, n_frames):
    """The port's cropped magnitudes of the valid frames and the full
    spectrum's maximum, tile by tile as pass 1 computes them."""
    tpad = streaming.stats_tile_frames
    crops, peak = [], -np.inf
    for t0 in range(0, n_frames, tpad):
        n_valid = min(tpad, n_frames - t0)
        mag = dft_magnitude(source.tile(t0, tpad), streaming.window,
                            n_fft=streaming.n_fft, hop=streaming.hop)[:n_valid]
        peak = max(peak, float(mag.max()))
        crops.append(mag[:, streaming.lo_idx : streaming.hi_idx].reshape(-1))
    return torch.cat(crops), peak


@pytest.mark.parametrize("hbm_audio_budget", [1 << 40, 0])
def test_pass1_statistics_bit_equal_sort_and_close_to_jax(models, hbm_audio_budget):
    jmodel, variables, model = models
    audio = _audio(7, n=30_011, kind="int16")
    n_frames = 1 + audio.shape[0] // SP["n_overlap"]
    streaming = StreamingPredictor(_predictor(model), SP, windows_per_chunk=8,
                                   stats_tile_frames=256,
                                   hbm_audio_budget=hbm_audio_budget)
    source = _AudioSource(audio, SP["nfft"], SP["n_overlap"], hbm_audio_budget,
                          256, torch.device("cpu"))
    assert source.resident == (hbm_audio_budget > 0)
    ref, lo_mag, hi_mag = streaming._select_percentiles(source, n_frames)

    values, peak = _own_magnitudes(streaming, source, n_frames)
    ordered = torch.sort(values).values
    ks = [nearest_quantile_index(q, values.numel()) for q in SP["quantiles"]]
    assert float(ref) == peak
    assert np.float32(lo_mag) == ordered[ks[0]].numpy()
    assert np.float32(hi_mag) == ordered[ks[1]].numpy()

    jref = JaxStreamingPredictor(
        JaxWindowPredictor(jmodel, variables, snippet_len=SNIPPET, n_filters=NFILT,
                           batch_size=4, max_windows_per_chunk=16, dense_trunk=False),
        SP, windows_per_chunk=8, stats_tile_frames=256, wire="exact",
    )
    jsource = JaxAudioSource(audio, SP["nfft"], SP["n_overlap"], hbm_audio_budget, 256)
    want = jref._select_percentiles(jsource, n_frames, False)
    np.testing.assert_allclose([float(ref), lo_mag, hi_mag], want, rtol=1e-4)


def test_pass_counts_of_kernel_calls(models, monkeypatch):
    """B1 runs once per stats tile per level and once per chunk, B2 once
    per stats tile per level: the counts the card's run asserts."""
    calls = {"b1": 0, "b2": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tstreaming, "dft_magnitude", count("b1", tstreaming.dft_magnitude))
    monkeypatch.setattr(tstreaming, "digit_histograms",
                        count("b2", tstreaming.digit_histograms))
    audio = _audio(0)  # 1001 frames, 29 windows
    StreamingPredictor(_predictor(models[2]), SP, windows_per_chunk=8,
                       stats_tile_frames=256).aggregate(audio)
    n_tiles, n_chunks = 4, 4
    assert calls == {"b1": 3 * n_tiles + n_chunks, "b2": 3 * n_tiles}


@pytest.mark.parametrize(
    "hist,k,want",
    [
        # counts by hand, each bin beyond int32: bins 0, 2 and 5 occupied
        ([3_000_000_000, 0, 4_000_000_000, 0, 0, 5_000_000_000], 0, (0, 0)),
        ([3_000_000_000, 0, 4_000_000_000, 0, 0, 5_000_000_000],
         2_999_999_999, (0, 2_999_999_999)),
        ([3_000_000_000, 0, 4_000_000_000, 0, 0, 5_000_000_000],
         3_000_000_000, (2, 0)),
        ([3_000_000_000, 0, 4_000_000_000, 0, 0, 5_000_000_000],
         6_999_999_999, (2, 3_999_999_999)),
        ([3_000_000_000, 0, 4_000_000_000, 0, 0, 5_000_000_000],
         11_999_999_999, (5, 4_999_999_999)),
        # a total past 2**31 made of bins that each fit int32
        ([2_000_000_000] * 4, 2**31, (1, 2**31 - 2_000_000_000)),
        ([0, 0, 7], 3, (2, 3)),
    ],
)
def test_pick_int64(hist, k, want):
    assert pick_int64(np.array(hist, dtype=np.int64), k) == want


def test_pick_int64_agrees_with_the_device_pick_on_int32_counts():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 1000, size=(2, 2048)).astype(np.int32)
    hist[:, rng.integers(0, 2048, 600)] = 0
    for k in (0, 1, int(hist[0].sum()) // 3, int(hist[0].sum()) - 1):
        ranks = torch.tensor([k, k], dtype=torch.int64)
        pref, rem = radix_pick_plain(torch.from_numpy(hist), ranks,
                                     torch.zeros(2, dtype=torch.int32), 11, True)
        assert pick_int64(hist[0], k) == (int(pref[0]), int(rem[0]))


def test_statistics_above_int32_totals(models, monkeypatch):
    """A recording's total beyond 2**31 values: every tile's counts scaled
    by 2**18 by hand (as if 262144 such tiles had gone by) select the same
    order statistics at ranks scaled alike, which int32 sums could not."""
    audio = _audio(9, kind="int16")
    n_frames = 1 + audio.shape[0] // SP["n_overlap"]
    streaming = StreamingPredictor(_predictor(models[2]), SP, stats_tile_frames=256)
    source = _AudioSource(audio, SP["nfft"], SP["n_overlap"], 0, 256, torch.device("cpu"))
    _, lo_mag, hi_mag = streaming._select_percentiles(source, n_frames)

    scale = 1 << 18
    real_hist = tstreaming.digit_histograms
    monkeypatch.setattr(
        tstreaming, "digit_histograms",
        lambda *a, **k: real_hist(*a, **k).to(torch.int64) * scale,
    )
    real_index = tstreaming.nearest_quantile_index
    monkeypatch.setattr(
        tstreaming, "nearest_quantile_index",
        lambda q, n: real_index(q, n) * scale + scale // 2,
    )
    assert n_frames * NBINS * scale > 2**31
    _, lo_big, hi_big = streaming._select_percentiles(source, n_frames)
    assert (lo_big, hi_big) == (lo_mag, hi_mag)


# ---------------------------------------------------------------- wires

# a regriddable geometry with the tiny model's 21 bins: 75 Hz bins, the
# band [0, 1575) (top bin 1500); 3/4 gives (3600, 48, 24), 11/16 (3300, 44, 22)
SP_WIRE = {"sampling_rate": 4800, "nfft": 64, "n_overlap": 32,
           "freq_range": [0, 1575], "quantiles": [0.01, 0.999]}


def _tiles(source, t0s, tpad=64):
    return [np.asarray(source.tile(t0, tpad)) for t0 in t0s]


@pytest.mark.parametrize("budget", [0, 1 << 30])
@pytest.mark.parametrize("n_fft,hop", [(512, 256), (384, 192), (400, 100), (48, 24)])
@pytest.mark.parametrize("wire", ["exact", "mulaw8", "bfp6", "bfp5"])
def test_audio_source_tiles_match_jax_per_wire(wire, n_fft, hop, budget):
    """Resident and host-sliced tiles of every byte codec, at aligned and
    misaligned block geometries and tile starts inside a block: equal to the
    JAX package's tiles (uint8 codes on mulaw8, int16 after the bfp decode)."""
    rng = np.random.default_rng(4)
    audio = (rng.uniform(-1, 1, 50_000) * 32767).astype(np.int16)
    ours = _AudioSource(audio, n_fft, hop, budget, 64, torch.device("cpu"), wire=wire)
    theirs = JaxAudioSource(audio, n_fft, hop, budget, 64, wire=wire)
    assert ours.resident == (budget > 0)
    for t0, a, b in zip((0, 1, 37, 150), _tiles(ours, (0, 1, 37, 150)),
                        _tiles(theirs, (0, 1, 37, 150))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f"tile at frame {t0}")


@pytest.mark.parametrize("budget", [0, 1 << 30])
@pytest.mark.parametrize("L,M", [(3, 4), (11, 16)])
def test_audio_source_tiles_of_a_resampled_stream_match_jax(L, M, budget):
    from orcai_tpu.ops.spectral import ResampledStream as JaxResampledStream
    from orcai_tpu_torch.ops.spectral import ResampledStream

    rng = np.random.default_rng(5)
    audio = (rng.uniform(-0.7, 0.7, 60_000) * 32767).astype(np.int16)
    n_fft, hop = 512 * L // M, 256 * L // M
    ours = _AudioSource(ResampledStream(audio, 48000, 15937.5, L, M), n_fft, hop, budget, 64,
                        torch.device("cpu"), wire="bfp5")
    theirs = JaxAudioSource(JaxResampledStream(audio, 48000, 15937.5, L, M), n_fft, hop,
                            budget, 64, wire="bfp5")
    for a, b in zip(_tiles(ours, (0, 3, 40)), _tiles(theirs, (0, 3, 40))):
        np.testing.assert_array_equal(a, b)


def test_host_sliced_bfp_tiles_fill_their_last_block():
    """C1 (ROADMAP, ADVICE.md): on audio whose level changes inside each
    128-sample block, a tile whose span ends inside a block must encode that
    block from the recording, not from zeros, or its shift differs from the
    whole-recording encode. The port's host-sliced tiles equal the global
    round trip and the resident tiles; the JAX package's host-sliced tiles
    do not (the fault is the reference's, shown here, not inherited)."""
    from orcai_tpu_torch.ops.wire_codec import bfp_decode_host, bfp_encode

    t = np.arange(50_000)
    loud = (t % 128) >= 64  # quiet first half, loud second half of each block
    audio = np.where(loud, 20000, 100) * np.sin(0.3 * t)
    audio = audio.astype(np.int16)
    round_trip = bfp_decode_host(*bfp_encode(audio, 5), 5)[: len(audio)]
    cpu = torch.device("cpu")
    n_fft, hop = 384, 192  # the sp wires' geometry: hop and offset off the grid
    exact = _AudioSource(round_trip, n_fft, hop, 0, 64, cpu)
    host = _AudioSource(audio, n_fft, hop, 0, 64, cpu, wire="bfp5")
    resident = _AudioSource(audio, n_fft, hop, 1 << 30, 64, cpu, wire="bfp5")
    jax_host = JaxAudioSource(audio, n_fft, hop, 0, 64, wire="bfp5")
    diverged = 0
    for t0 in (0, 1, 37, 150):
        want = np.asarray(exact.tile(t0, 64))
        np.testing.assert_array_equal(np.asarray(host.tile(t0, 64)), want)
        np.testing.assert_array_equal(np.asarray(resident.tile(t0, 64)), want)
        diverged += int((np.asarray(jax_host.tile(t0, 64)) != want).sum())
    assert diverged > 0


@pytest.fixture(scope="module")
def wire_models():
    return _pair(PARAM, SNIPPET, 7)


@pytest.mark.parametrize("wire", ["mulaw8", "bfp6", "sp-bfp5", "sp11-bfp5"])
def test_streaming_wire_resident_equals_host_sliced_and_holds_in_memory(wire_models, wire):
    """Resident and host-sliced streaming on one wire are equal (the same
    decoded samples in every tile); against the in-memory path on the same
    wire, mulaw8 holds the exact wire's bar (1e-5, counts equal) and the
    bfp wires the reference's (tests/test_streaming.py:206-245: counts
    equal, atol 0.05, mean below 0.01), since the in-memory path anchors
    its bfp blocks at each tile and streaming at the recording's start."""
    _, _, model = wire_models
    rng = np.random.default_rng(12)
    audio = (rng.uniform(-0.7, 0.7, 24_000) * 32767).astype(np.int16)
    spec, _, _ = compute_spectrogram(
        audio, SP_WIRE["sampling_rate"], SP_WIRE["nfft"], SP_WIRE["n_overlap"],
        SP_WIRE["freq_range"], SP_WIRE["quantiles"], device="cpu", wire=wire)
    agg0, cnt0 = _predictor(model).aggregate(spec)
    runs = []
    for budget in (1 << 40, 0):
        s = StreamingPredictor(_predictor(model), SP_WIRE, windows_per_chunk=8,
                               stats_tile_frames=128, hbm_audio_budget=budget, wire=wire)
        assert s.wire_label == wire
        runs.append(s.aggregate(audio))
    (agg1, cnt1), (agg2, cnt2) = runs
    np.testing.assert_array_equal(agg1, agg2)
    np.testing.assert_array_equal(cnt1, cnt2)
    np.testing.assert_array_equal(cnt1, cnt0)
    if wire == "mulaw8":
        np.testing.assert_allclose(agg1, agg0, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(agg1, agg0, atol=0.05, rtol=0)
        assert float(np.abs(agg1 - agg0).mean()) < 0.01


@pytest.mark.parametrize("budget", [1 << 40, 0])
def test_streaming_sp_wire_equals_base_on_preresampled(wire_models, budget):
    """tests/test_streaming.py:160-203: sp-bfp5 streaming equals bfp5
    streaming over the globally resampled audio at the scaled geometry."""
    from orcai_tpu_torch.ops.spectral import resample_poly, spectral_geometry

    _, _, model = wire_models
    audio = (np.random.default_rng(11).uniform(-0.7, 0.7, 24_000) * 32767).astype(np.int16)
    sr, n_fft, hop, pass_hz = spectral_geometry(4800, 64, 32, SP_WIRE["freq_range"])
    assert (sr, n_fft, hop) == (3600, 48, 24)
    kw = dict(windows_per_chunk=8, stats_tile_frames=128, hbm_audio_budget=budget)
    a1, c1 = StreamingPredictor(_predictor(model), SP_WIRE, wire="sp-bfp5", **kw).aggregate(
        audio)
    scaled = dict(SP_WIRE, sampling_rate=sr, nfft=n_fft, n_overlap=hop)
    a2, c2 = StreamingPredictor(_predictor(model), scaled, wire="bfp5", **kw).aggregate(
        resample_poly(audio, 4800, pass_hz, 3, 4))
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(a1, a2, atol=1e-6, rtol=0)


@pytest.mark.parametrize("wire", ["mulaw8", "sp-bfp5"])
def test_streaming_wire_matches_jax_streaming(wire_models, wire):
    jmodel, variables, model = wire_models
    audio = (np.random.default_rng(13).uniform(-0.7, 0.7, 24_000) * 32767).astype(np.int16)
    kw = dict(windows_per_chunk=8, stats_tile_frames=128, hbm_audio_budget=0, wire=wire)
    ref = JaxStreamingPredictor(
        JaxWindowPredictor(jmodel, variables, snippet_len=SNIPPET, n_filters=NFILT,
                           batch_size=4, max_windows_per_chunk=16, dense_trunk=False),
        SP_WIRE, **kw)
    ref_agg, ref_cnt = ref.aggregate(audio)
    agg, cnt = StreamingPredictor(_predictor(model), SP_WIRE, **kw).aggregate(audio)
    np.testing.assert_array_equal(cnt, ref_cnt)
    np.testing.assert_allclose(agg, ref_agg, atol=1e-4, rtol=0)


# streamed against in-memory sp-bfp5 with orcai-v1: the largest difference
# allowed. The reference's own bar (tests/test_streaming.py:206-245, atol 0.05
# on a tiny model) does not hold for orcai-v1 in either package: one-minute
# sweeps read 0.0776 and 0.1004 (seeds 0 and 3, below), the port and the JAX
# package alike, and the card 0.0963 on 20 minutes; chip_smoke.py holds the
# card to this.
SP_BFP5_STREAMED_MAX = 0.2


@pytest.fixture(scope="module")
def orcai_v1_pair():
    from orcai_tpu.io.model_store import load_orcai_model as jax_load_orcai_model
    from orcai_tpu.resources import MODELS_DATA_DIR
    from orcai_tpu_torch.io.model_store import load_orcai_model

    jmodel, variables, param, _ = jax_load_orcai_model(MODELS_DATA_DIR / "orcai-v1")
    model, _, _ = load_orcai_model(None, torch.float32, "cpu")
    return jmodel, variables, model, param["spectrogram"]


@pytest.mark.parametrize("seed", [0, 3])
def test_streamed_sp_bfp5_departs_from_in_memory_as_the_reference_does(
        orcai_v1_pair, seed, tmp_path):
    """One minute of chip_smoke.py's sweep recording through orcai-v1 on
    sp-bfp5, streamed and in memory, in both packages. In memory the bfp
    blocks start at each tile, streamed at the recording's first sample (64
    samples apart at hop 192): the JAX package's difference exceeds its own
    0.05 bar, and the port's equals it within 1e-4 (the bar between the
    packages' aggregates above). Both stay under SP_BFP5_STREAMED_MAX, with
    the reference's mean bar of 0.01."""
    from scipy.io import wavfile

    from orcai_tpu.ops.frontend import compute_spectrogram as jax_compute_spectrogram
    from orcai_tpu_torch.tools.synthetic import synth_sweep_wav

    jmodel, variables, model, sp = orcai_v1_pair
    synth_sweep_wav(tmp_path / "sweep.wav", seed, 1.0)
    _, audio = wavfile.read(tmp_path / "sweep.wav")
    args = (sp["sampling_rate"], sp["nfft"], sp["n_overlap"], sp["freq_range"],
            sp["quantiles"])
    kw = dict(windows_per_chunk=64, stats_tile_frames=8192, wire="sp-bfp5")

    def jax_wp():
        return JaxWindowPredictor(jmodel, variables, snippet_len=736, n_filters=4,
                                  batch_size=32, dense_trunk=False)

    def port_wp():
        return WindowPredictor(model, snippet_len=736, n_filters=4, batch_size=32)

    spec, _, _ = jax_compute_spectrogram(audio, *args, wire="sp-bfp5")
    ref0, ref_cnt0 = jax_wp().aggregate(spec)
    ref1, ref_cnt1 = JaxStreamingPredictor(jax_wp(), sp, **kw).aggregate(audio)
    spec, _, _ = compute_spectrogram(audio, *args, device="cpu", wire="sp-bfp5")
    agg0, cnt0 = port_wp().aggregate(spec)
    agg1, cnt1 = StreamingPredictor(port_wp(), sp, **kw).aggregate(audio)

    for c in (ref_cnt1, cnt0, cnt1):
        np.testing.assert_array_equal(c, ref_cnt0)
    ref_diff = np.asarray(ref1) - np.asarray(ref0)
    diff = agg1 - agg0
    print(f"seed {seed}: streamed - in-memory max {np.abs(ref_diff).max()} (JAX), "
          f"{np.abs(diff).max()} (port)")
    assert np.abs(ref_diff).max() > 0.05
    np.testing.assert_allclose(diff, ref_diff, atol=1e-4, rtol=0)
    for d in (ref_diff, diff):
        assert np.abs(d).max() <= SP_BFP5_STREAMED_MAX
        assert float(np.abs(d).mean()) < 0.01
