"""Port frontend (orcai_tpu_torch/ops/frontend.py, io/wav.py) on the CPU vs
the JAX frontend: spectrogram within 2e-4 (tests/test_frontend.py:141) and
the clip-bound order statistics bit-equal for the same magnitudes."""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from orcai_tpu.io.wav import load_wav_for_frontend as jax_load_wav
from orcai_tpu.ops import frontend as jfront
from orcai_tpu_torch.io.wav import load_wav_for_frontend
from orcai_tpu_torch.ops import frontend as tfront

SR, NFFT, HOP = 48000, 512, 256
FREQ_RANGE, QUANTILES = [0, 16000], [0.01, 0.999]


def setup_module():
    torch.set_num_threads(1)


def _audio(n, seed, dtype):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 3000 * t * (1 + t / 10)) + 0.05 * rng.standard_normal(n)
    x = x.astype(np.float32)
    if dtype == "int16":
        return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)
    return x


def _both(audio):
    ours, f_t, t_t = tfront.compute_spectrogram(
        audio, SR, NFFT, HOP, FREQ_RANGE, QUANTILES, device="cpu"
    )
    ref, f_j, t_j = jfront.compute_spectrogram(
        audio, SR, NFFT, HOP, FREQ_RANGE, QUANTILES
    )
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(t_t, t_j)
    return ours, ref


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_spectrogram_matches_jax_single_tile(dtype):
    audio = _audio(48000 * 3 + 77, 0, dtype)
    ours, ref = _both(audio)
    assert ours.shape == ref.shape == (1 + audio.shape[0] // HOP, 171)
    assert ours.dtype == np.float32 and ours.min() >= 0 and ours.max() <= 1
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


def test_spectrogram_multi_tile_with_zero_tile(monkeypatch):
    """Small port tiles: 5000 frames in an 8192-frame bucket run as three
    real 2048-frame tiles plus one all-padding tile; the result does not
    depend on the tiling, so it must match the JAX frontend (one tile)."""
    monkeypatch.setattr(tfront, "_TILE_FRAMES", 2048)
    audio = _audio(4999 * HOP + 100, 1, "int16")
    assert tfront._tile_plan(1 + audio.shape[0] // HOP) == (2048, 4, 3)
    ours, ref = _both(audio)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


def test_finalize_clip_bounds():
    """Same magnitudes in, the port's finalize picks bit-equal clip-bound
    order statistics and normalizes to the same spectrogram as the JAX sort
    path. The dB of a bound is not bit-equal: torch.log10 and XLA's log10
    round differently, and 20*log10(m) - ref20 carries that to a few
    float32 ulps (recorded in ROADMAP.md, queue C)."""
    from orcai_tpu_torch.ops.radix_select import select_order_statistics

    rng = np.random.default_rng(2)
    tile, n_tiles, nbins, n_valid = 2048, 2, 171, 3001
    mags = rng.uniform(0.0, 2.0, (n_tiles * tile, nbins)).astype(np.float32)
    mags[:n_valid:7] = 0.0  # values below amin: the -80 dB plateau
    maxes = np.asarray([2.5, -np.inf], np.float32)
    n_elem = n_valid * nbins
    idx_lo = tfront.nearest_quantile_index(0.01, n_elem)
    idx_hi = tfront.nearest_quantile_index(0.999, n_elem)

    out, lo, hi = tfront.finalize(
        torch.from_numpy(mags), torch.from_numpy(maxes), n_valid, idx_lo, idx_hi
    )
    ref = jfront._build_finalize_fn(n_tiles, tile, False)(
        tuple(jnp.asarray(m) for m in np.split(mags, n_tiles)),
        jnp.asarray(maxes), jnp.asarray(n_valid, jnp.int32),
        jnp.asarray(idx_lo, jnp.int32), jnp.asarray(idx_hi, jnp.int32),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)

    # the JAX finalize's sort path on the same buffer: order statistics
    # bit-equal, and its dB arithmetic on them
    s = jnp.sort(jnp.where(jnp.arange(n_tiles * tile)[:, None] < n_valid,
                           jnp.asarray(mags), jnp.inf).ravel())
    m_lo, m_hi = select_order_statistics(
        torch.from_numpy(mags).reshape(-1), torch.tensor([n_elem], dtype=torch.int32),
        torch.tensor([idx_lo]), torch.tensor([idx_hi]),
    )
    assert m_lo.numpy().tobytes() == np.asarray(s[idx_lo]).tobytes()
    assert m_hi.numpy().tobytes() == np.asarray(s[idx_hi]).tobytes()
    ref20 = 20.0 * jnp.log10(jnp.maximum(jnp.max(jnp.asarray(maxes)), jfront._AMIN))

    def db_of(m):
        return jnp.maximum(20.0 * jnp.log10(jnp.maximum(m, jfront._AMIN)) - ref20,
                           -jfront._TOP_DB)

    for ours, j in ((lo, db_of(s[idx_lo])), (hi, db_of(s[idx_hi]))):
        np.testing.assert_allclose(ours.numpy()[0], np.asarray(j), rtol=1e-6, atol=0)


@pytest.mark.parametrize("form", ["log10", "log_over_ln10", "log_times_inv_ln10"])
def test_log10_forms_stay_within_ulps_of_jax(form):
    """The trial behind ROADMAP queue C: no float32 log10 that torch offers
    on the CPU is bit-equal to jnp.log10 (itself log(x) / log(10)): torch's
    log and XLA's round differently before any division. Each form stays
    within 4 float32 ulps over the magnitudes' range, so `_db` keeps
    torch.log10 and the clip bounds keep their rtol 1e-6 bar."""
    import math

    rng = np.random.default_rng(0)
    m = np.concatenate([
        rng.uniform(1e-5, 2.0, 200_000),
        np.exp(rng.uniform(np.log(1e-5), np.log(300.0), 200_000)),
    ]).astype(np.float32)
    x = torch.from_numpy(m)
    ours = {
        "log10": lambda: torch.log10(x),
        "log_over_ln10": lambda: torch.log(x) / math.log(10.0),
        "log_times_inv_ln10": lambda: torch.log(x) * (1.0 / math.log(10.0)),
    }[form]().numpy()
    ref = np.asarray(jnp.log10(jnp.asarray(m)))
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    print(f"{form}: max {ulps.max()} ulps, {np.mean(ulps > 0):.4f} of the values differ")
    assert ulps.max() <= 4


def test_host_helpers_match_reference():
    freqs = tfront.fft_frequencies(SR, NFFT)
    np.testing.assert_array_equal(freqs, jfront.fft_frequencies(SR, NFFT))
    assert tfront.freq_crop_indices(freqs, FREQ_RANGE) == jfront.freq_crop_indices(
        freqs, FREQ_RANGE) == (0, 171)
    for n in (1, 2047, 2048, 2049, 11251, 225001, 10**6):
        assert tfront._tile_plan(n) == jfront._tile_plan(n)
        for q in (0.0, 0.01, 0.5, 0.999, 1.0):
            assert tfront.nearest_quantile_index(q, n * 171) == (
                jfront.nearest_quantile_index(q, n * 171))
    audio = np.arange(10_000, dtype=np.int16)
    for t in range(3):
        np.testing.assert_array_equal(
            tfront._audio_tile_chunk(audio, t, 16, NFFT, HOP),
            jfront._audio_tile_chunk(audio, t, 16, NFFT, HOP),
        )


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tfront.compute_spectrogram(
            np.zeros(48000, np.float32), SR, NFFT, HOP, FREQ_RANGE, QUANTILES
        )


@pytest.mark.parametrize(
    "sr,channels,dtype",
    [(48000, 1, np.int16), (48000, 2, np.int16), (44100, 1, np.int16),
     (48000, 1, np.float32)],
)
def test_wav_loader_matches_reference(tmp_path, sr, channels, dtype):
    rng = np.random.default_rng(3)
    n = sr // 2
    data = rng.uniform(-0.5, 0.5, (n, channels)).squeeze()
    data = (data * 32767).astype(np.int16) if dtype == np.int16 else data.astype(dtype)
    path = tmp_path / "x.wav"
    wavfile.write(path, sr, data)
    ours, multi = load_wav_for_frontend(path, sr=48000, channel=channels)
    ref, multi_ref = jax_load_wav(path, sr=48000, channel=channels)
    assert multi == multi_ref == (channels > 1)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    if channels > 1:
        with pytest.raises(ValueError, match="channel"):
            load_wav_for_frontend(path, sr=48000, channel=channels + 1)


def test_spectrogram_multi_tile_default_tiles():
    """The production tiling: 70000 frames in a 131072-frame bucket run as
    three real 32768-frame tiles plus one all-padding tile in both."""
    audio = _audio(69999 * HOP + 10, 4, "int16")
    assert tfront._tile_plan(1 + audio.shape[0] // HOP) == (32768, 4, 3)
    ours, ref = _both(audio)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


WIRES = ["exact", "mulaw8", "bfp6", "bfp5", "sp-bfp6", "sp-bfp5", "sp11-bfp5"]


@pytest.fixture(scope="module")
def golden_audio():
    from pathlib import Path

    audio, _ = load_wav_for_frontend(
        Path(__file__).parent / "fixtures" / "golden.wav", sr=SR)
    return audio


@pytest.mark.parametrize("wire", WIRES)
def test_spectrogram_of_each_wire_matches_jax(golden_audio, wire):
    """Every wire on the golden wav (the spectrogram level of the golden
    predicts that tests/test_torch_wire_codec.py and
    tests/test_torch_spectral.py run end to end): within 2e-4 of the JAX
    frontend on the same wire, the same native frequency vector and the
    same frame times."""
    ours, f_t, t_t = tfront.compute_spectrogram(
        golden_audio, SR, NFFT, HOP, FREQ_RANGE, QUANTILES, device="cpu", wire=wire)
    ref, f_j, t_j = jfront.compute_spectrogram(
        golden_audio, SR, NFFT, HOP, FREQ_RANGE, QUANTILES, wire=wire)
    np.testing.assert_array_equal(f_t, f_j)
    assert f_t.shape == (NFFT // 2 + 1,)
    np.testing.assert_array_equal(t_t, t_j)
    assert ours.shape == ref.shape == (1 + golden_audio.shape[0] // HOP, 171)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("wire", ["mulaw8", "bfp6", "sp-bfp5", "sp11-bfp5"])
def test_wire_frontend_is_its_host_form_then_exact(wire):
    """Plumbing: a coded wire's spectrogram equals the exact wire's on the
    audio the host decodes (tests/test_wire_codec.py:132-147, 297-311) at
    the geometry prepare_wire_audio gives; the native frequency vector
    comes back whatever the wire."""
    from orcai_tpu_torch.ops.wire_codec import (
        bfp_decode_host, bfp_encode, mulaw_decode_host, wire_bfp_bits)

    audio = _audio(48000 * 2 + 11, 5, "int16")
    coded, sr, n_fft, hop, base, bits = tfront.prepare_wire_audio(
        audio, SR, NFFT, HOP, FREQ_RANGE, wire)
    assert bits == wire_bfp_bits(base)
    if base == "mulaw8":
        host = mulaw_decode_host(coded)
    else:
        # per-tile bfp blocks are anchored at each tile's first sample; one
        # tile here, which starts n_fft // 2 before the recording
        head = np.concatenate([np.zeros(n_fft // 2, np.int16), coded])
        host = bfp_decode_host(*bfp_encode(head, bits), bits)[n_fft // 2 : n_fft // 2
                                                               + coded.shape[0]]
    got, freqs, times = tfront.compute_spectrogram(
        audio, SR, NFFT, HOP, FREQ_RANGE, QUANTILES, device="cpu", wire=wire)
    want, _, want_times = tfront.compute_spectrogram(
        host, sr, n_fft, hop, FREQ_RANGE, QUANTILES, device="cpu", wire="exact")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(times, want_times)
    np.testing.assert_array_equal(freqs, tfront.fft_frequencies(SR, NFFT))


def test_auto_wire_is_exact_unless_the_variable_says(monkeypatch):
    audio = _audio(48000, 6, "int16")
    args = (audio, SR, NFFT, HOP, FREQ_RANGE, QUANTILES)
    exact, _, _ = tfront.compute_spectrogram(*args, device="cpu", wire="exact")
    monkeypatch.delenv("ORCAI_TPU_WIRE", raising=False)
    for wire in (None, "auto"):
        np.testing.assert_array_equal(
            tfront.compute_spectrogram(*args, device="cpu", wire=wire)[0], exact)
    monkeypatch.setenv("ORCAI_TPU_WIRE", "mulaw8")
    np.testing.assert_array_equal(
        tfront.compute_spectrogram(*args, device="cpu")[0],
        tfront.compute_spectrogram(*args, device="cpu", wire="mulaw8")[0])
