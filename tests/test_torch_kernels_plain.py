"""The port's kernel modules on the CPU (their plain PyTorch versions, and
the step-by-step references of the kernels' own arithmetic) vs the JAX
Pallas kernels in interpret mode and numpy.

B1 ops/dft.py::dft_magnitude vs orcai_tpu/ops/pallas_dft.py, atol 2e-4
(tests/test_pallas_dft.py); B2 ops/radix_select.py::digit_histograms vs
orcai_tpu/ops/pallas_hist.py, exact; select_order_statistics bit-equal to
the JAX selection and to torch.sort (tests/test_pallas_hist.py).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from orcai_tpu.ops.frontend import _dft_mats as jax_dft_mats, hann_window
from orcai_tpu.ops.pallas_dft import dft_magnitude as jax_dft_magnitude
from orcai_tpu.ops.pallas_hist import (
    _pick as jax_pick,
    digit_histograms as jax_digit_histograms,
    pad_unit,
    select_order_statistics as jax_select,
)
from orcai_tpu.ops.wire_codec import mulaw_decode_host, mulaw_encode
from orcai_tpu_torch.ops import _build
from orcai_tpu_torch.ops.dft import (
    _C16,
    _S16,
    CHIRP_MAX,
    CHIRP_PRIMES,
    CLUSTER_MAX,
    CLUSTER_PAIR_BYTES,
    CLUSTER_PRIMES,
    FFT_SIZES,
    MIXED_MAX,
    MIXED_PRIMES,
    ROUTES,
    STAGED_BATCH,
    STAGED_CTA_BYTES,
    STAGED_CTA_MAX_BYTES,
    STAGED_M_MAX,
    STAGED_MAX,
    _chirp_cluster_reference,
    _chirp_kernel,
    _chirp_reference,
    _chirp_staged_fold_reference,
    _chirp_staged_reference,
    _cluster_plan_array,
    _exchange_accesses,
    _fft_cluster_reference,
    _fft_mixed_reference,
    _fft_pairs_reference,
    _odd_roots,
    _pad_address,
    _passes,
    _build_variant,
    _staged_bytes,
    _staged_plan_array,
    _staged_reference,
    _wavefronts,
    active_clusters,
    chirp_length,
    chirp_tables,
    cluster_bytes,
    cluster_plan,
    cluster_tables,
    dft_magnitude,
    dft_magnitude_plain,
    dft_route,
    exchange_pads,
    fft_plan,
    fft_tables,
    four_step_roots,
    pass_roots,
    product_twiddles,
    roots_of_unity,
    staged_chunk_pairs,
    staged_fold,
    staged_mirror_groups,
    staged_mode,
    staged_plan,
    staged_tables,
    twiddle_split,
    twiddle_tables,
    windowed_dft_mats,
)
from orcai_tpu_torch.ops.frontend import hann_window as port_hann_window
from orcai_tpu_torch.ops.radix_select import (
    _pick,
    digit_histograms,
    radix_pick,
    radix_pick_plain,
    select_order_statistics,
    select_order_statistics_plain,
)

NFFT, HOP = 512, 256


def setup_module():
    torch.set_num_threads(1)


def _numpy_mag(padded):
    tpad = (len(padded) - NFFT) // HOP + 1
    win = hann_window(NFFT)
    frames = np.stack(
        [padded[i * HOP : i * HOP + NFFT] * win for i in range(tpad)]
    )
    return np.abs(np.fft.rfft(frames, axis=1)).astype(np.float32)


WINDOW = port_hann_window(NFFT)


def test_dft_mats_match_reference():
    np.testing.assert_array_equal(WINDOW, hann_window(NFFT))
    for ours, ref in zip(windowed_dft_mats(WINDOW), jax_dft_mats(NFFT)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_dft_plain_matches_pallas_and_numpy(dtype):
    rng = np.random.default_rng(0 if dtype == "f32" else 1)
    tpad = 256
    n = (tpad - 1) * HOP + NFFT
    if dtype == "f32":
        padded = rng.standard_normal(n).astype(np.float32)
        as_float = padded
    else:
        padded = (rng.uniform(-0.5, 0.5, size=n) * 32768).astype(np.int16)
        as_float = padded.astype(np.float32) / 32768.0
    got = dft_magnitude(torch.from_numpy(padded), WINDOW, n_fft=NFFT, hop=HOP)
    assert got.shape == (tpad, 257) and got.dtype == torch.float32
    ref = jax_dft_magnitude(
        jnp.asarray(padded), *map(jnp.asarray, jax_dft_mats(NFFT)),
        n_fft=NFFT, hop=HOP, tile_frames=64, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), _numpy_mag(as_float), atol=2e-4, rtol=0)


def _pallas(padded, n_fft, hop, tile_frames):
    return np.asarray(jax_dft_magnitude(
        jnp.asarray(padded), *map(jnp.asarray, jax_dft_mats(n_fft)),
        n_fft=n_fft, hop=hop, tile_frames=tile_frames, interpret=True,
    ))


@pytest.mark.parametrize("n_fft,hop", [(384, 192), (352, 176), (1024, 256), (512, 128)])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_dft_plain_other_sizes_and_codes_match_pallas(n_fft, hop, dtype):
    """Every size the GEMM route takes (the spectral wires' 384/192 and
    352/176, a longer window, a quarter hop) and the mulaw8 wire's codes,
    against the Pallas kernel in interpret mode: atol 2e-4."""
    rng = np.random.default_rng(n_fft + hop)
    tpad = 64
    n = (tpad - 1) * hop + n_fft
    pcm = (rng.uniform(-0.9, 0.9, size=n) * 32768).astype(np.int16)
    padded = {"f32": (0.3 * rng.standard_normal(n)).astype(np.float32), "int16": pcm,
              "uint8": mulaw_encode(pcm)}[dtype]
    window = port_hann_window(n_fft)
    np.testing.assert_array_equal(window, hann_window(n_fft))
    got = dft_magnitude(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, 32), atol=2e-4, rtol=0)
    for ours, theirs in zip(windowed_dft_mats(window), jax_dft_mats(n_fft)):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("n_fft,hop", [(512, 256), (384, 192)])
def test_dft_of_codes_is_dft_of_their_int16_decode(n_fft, hop):
    """The codes and their host decode to int16 are the same float samples
    through the same arithmetic: bit-equal on the plain version and on the
    FFT route's step-by-step reference (tests/test_wire_codec.py:132-147)."""
    rng = np.random.default_rng(9)
    n = 63 * hop + n_fft
    codes = mulaw_encode((rng.uniform(-1, 1, n) * 32767).astype(np.int16))
    decoded = torch.from_numpy(mulaw_decode_host(codes))
    window = port_hann_window(n_fft)
    a = dft_magnitude(torch.from_numpy(codes), window, n_fft=n_fft, hop=hop)
    assert torch.equal(a, dft_magnitude(decoded, window, n_fft=n_fft, hop=hop))
    if n_fft in FFT_SIZES:
        b = _fft_pairs_reference(torch.from_numpy(codes), window, n_fft=n_fft, hop=hop)
        assert torch.equal(b, _fft_pairs_reference(decoded, window, n_fft=n_fft, hop=hop))


def test_dft_wrapper_validates_geometry():
    with pytest.raises(ValueError, match="hop"):
        dft_magnitude_plain(torch.zeros(1024), WINDOW, n_fft=NFFT, hop=300)
    with pytest.raises(ValueError, match="padded audio"):
        dft_magnitude(torch.zeros(1000), WINDOW, n_fft=NFFT, hop=HOP)
    with pytest.raises(ValueError, match="unsupported device"):
        dft_magnitude(torch.zeros(1024, device="meta"), WINDOW, n_fft=NFFT, hop=HOP)
    with pytest.raises(ValueError, match="window"):
        dft_magnitude(torch.zeros(1024), WINDOW[:-1], n_fft=NFFT, hop=HOP)


@pytest.mark.parametrize(
    "n_fft,hop", [(1024, 256), (256, 128), (384, 128), (416, 208), (4096, 1024), (512, 256),
                  (1088, 544), (4352, 2176), (1216, 608), (16384, 8192), (8198, 4099),
                  (16418, 8209), (470, 235), (24578, 12289), (65536, 32768), (40962, 20481),
                  (464, 232), (496, 248), (1856, 928), (1984, 992), (14848, 7424),
                  (49154, 24577), (98304, 49152), (131072, 65536), (1, 1)])
def test_dft_wrapper_names_supported_sizes(n_fft, hop):
    """Off the CPU every n_fft that hop divides has a kernel: 512 the FFT,
    a {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31}-smooth n_fft up to 8192 the
    mixed-radix FFT (1088, 4352, 1216, 464, 496, 1856, 1984), a
    {2, ..., 23}-smooth n_fft up to 81920 the cluster layout (16384, 65536),
    any other up to 40960 with a prime factor above 31 the chirp mode (470,
    8198, 16418, 24578), any other up to 2^20 the staged route (40962, 49154
    in its chirp mode, 14848 = 2^9 * 29, 98304 and 131072 in its FFT mode),
    1 the point kernel. What no
    kernel takes raises and names what they take; nothing routes it to the
    plain version."""
    want = {512: "fft", 470: "chirp", 8198: "chirp", 16418: "chirp", 24578: "chirp",
            14848: "staged", 16384: "cluster", 65536: "cluster", 40962: "staged",
            49154: "staged", 98304: "staged", 131072: "staged", 1: "point"}.get(n_fft, "mixed")
    assert dft_route(n_fft) == want and dft_route(512) == "fft"
    for dtype in (torch.float64, torch.int32, torch.bool):
        x = torch.zeros(3 * hop + n_fft, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="float32, int16 or uint8"):
            dft_magnitude(x, port_hann_window(n_fft), n_fft=n_fft, hop=hop)
    with pytest.raises(ValueError, match="1-D"):
        dft_magnitude(torch.zeros(2, 3 * hop + n_fft, device="meta"), port_hann_window(n_fft),
                      n_fft=n_fft, hop=hop)
    for dtype in (torch.float32, torch.int16, torch.uint8):
        x = torch.zeros(3 * hop + n_fft, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="unsupported device meta"):
            dft_magnitude(x, port_hann_window(n_fft), n_fft=n_fft, hop=hop)


@pytest.mark.parametrize("n_fft", [512, 1216, 470, 40962])
def test_active_clusters_takes_only_the_cluster_layout(n_fft):
    """active_clusters reads the card's cluster occupancy only where n_fft
    runs on the cluster layout (the cluster route, the chirp mode above a
    length of 8192); any other n_fft raises before a kernel is loaded."""
    with pytest.raises(ValueError, match="does not take the cluster layout"):
        active_clusters(n_fft)


def test_fft_sources_build_per_largest_odd_radix_and_sample_type():
    """dft_mixed.cu and dft_cluster.cu are built once per (largest odd
    radix a build takes, sample type), dft_staged.cu once per largest odd
    radix (it takes the sample type at run time), each build a library of
    its own flags and path, so that their kernels compile side by side;
    _build_variant picks the build of a plan, the least that takes its
    largest odd radix (a plan without a 13, 17, 19, 23, 29 or 31 the
    radix-11 build of the mixed kernel, the radix-17 one of the cluster
    kernel, the radix-13 one of the staged kernels; a 19 the radix-23
    build, a 29 the radix-31 build); a source with builds is not loaded
    without one."""
    paths = set()
    for name, variants in _build.VARIANTS.items():
        for odd, dtype in variants:
            flags = _build._flags((odd, dtype))
            assert f"-DORCAI_ODD={odd}" in flags
            assert (dtype is None) == (name == "dft_staged")
            assert (f"-DORCAI_DTYPE={dtype}" in flags) == (dtype is not None)
            paths.add(_build.library_path(name, (odd, dtype)))
    assert len(paths) == sum(len(v) for v in _build.VARIANTS.values()) == 23
    assert "dft_staged" in _build.KERNELS
    for n, odd in ((384, 11), (4096, 11), (416, 13), (1088, 17), (1216, 23), (1472, 23),
                   (952, 17), (2431, 17), (464, 31), (496, 31), (1856, 31), (1984, 31)):
        assert _build_variant("mixed", n, torch.int16) == (odd, 1)
    for n, odd in ((131072, 13), (98304, 13), (chirp_length(40962), 31), (59392, 31),
                   (1 << 20, 13)):
        for dtype in (torch.float32, torch.int16, torch.uint8):
            assert _build_variant("staged", n, dtype) == (odd, None)
    for n, odd in ((16384, 17), (16456, 17), (32851, 23), (50864, 17), (65536, 17),
                   (11776, 23)):
        assert _build_variant("cluster", n, torch.uint8) == (odd, 2)
    assert _build_variant("gemm", 40962, torch.float32) is None
    with pytest.raises(ValueError, match="builds"):
        _build.load("dft_mixed")


def test_build_runs_each_missing_library_once_longest_first(tmp_path, monkeypatch):
    """_build.build starts one nvcc a library not yet built, as many at once
    as the process has cores, the longest first (_weight: the largest odd
    radix, then the staged source); a library built is not built again; a
    failed nvcc raises with its output. A stand-in nvcc records its calls."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\nfor a; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        f"echo \"$@\" >> {calls}\n"
        "case \"$*\" in *dft_gemm.cu*) [ -n \"$FAIL_GEMM\" ] && echo no && exit 1;; esac\n"
        "echo 'ptxas info    : Used 10 registers'\n: > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.os, "sched_getaffinity", lambda pid: {0})  # one at a time
    logs = _build.build(["dft_gemm", "dft_staged"])
    assert sorted(logs) == ["dft_gemm", "dft_staged-odd13", "dft_staged-odd31"]
    assert all("registers" in log for log in logs.values())
    order = calls.read_text().splitlines()
    assert ["ODD=31" in order[0], "ODD=13" in order[1], "dft_gemm.cu" in order[2]] == [True] * 3
    assert all(_build.library_path(n, v).exists()
               for n in ("dft_gemm", "dft_staged") for v in _build.VARIANTS.get(n, (None,)))
    assert _build.build(["dft_gemm", "dft_staged"]) == {} and len(calls.read_text().splitlines()) == 3
    assert _build._weight("dft_staged", (31, None)) > _build._weight("dft_mixed", (31, 2)) > (
        _build._weight("dft_cluster", (23, 0))) > _build._weight("dft_magnitude", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "again")
    monkeypatch.setenv("FAIL_GEMM", "1")
    with pytest.raises(RuntimeError, match="nvcc failed for dft_gemm"):
        _build.build(["dft_gemm"])


def test_dft_wrapper_rejects_bad_hop_off_cpu():
    with pytest.raises(ValueError, match="hop 300 must divide n_fft 512"):
        dft_magnitude(torch.zeros(1112, device="meta"), WINDOW, n_fft=NFFT, hop=300)


@pytest.mark.parametrize("n_fft", FFT_SIZES)
def test_fft_tables_match_float64(n_fft):
    """The kernel's window and roots of unity are float64 values rounded
    once: bit-equal to the float32 cast of numpy's float64 results."""
    win, tw = fft_tables(port_hann_window(n_fft))
    m = np.arange(n_fft, dtype=np.float64)
    want_win = (0.5 - 0.5 * np.cos(2.0 * np.pi * m / n_fft)).astype(np.float32)
    want_tw = np.exp(-2j * np.pi * m / n_fft)
    assert win.dtype == tw.dtype == np.float32 and tw.shape == (n_fft, 2)
    np.testing.assert_array_equal(win, want_win)
    np.testing.assert_array_equal(tw[:, 0], want_tw.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want_tw.imag.astype(np.float32))
    # half a float32 ulp of values in [-1, 1]
    assert np.abs(tw[:, 0] + 1j * tw[:, 1] - want_tw).max() <= 2.0 ** -24


@pytest.mark.parametrize("n_fft", FFT_SIZES)
@pytest.mark.parametrize("tpad", [64, 37])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_fft_reference_matches_plain_and_pallas(dtype, tpad, n_fft):
    """The kernel's arithmetic (two frames per complex FFT, radix-8
    Stockham passes with the kernel's tables and index maps, untangle)
    against the framed GEMM and the Pallas kernel, atol 2e-4 (the reference
    suite's DFT bar), for an even and an odd frame count."""
    hop = n_fft // 2
    rng = np.random.default_rng(10 + tpad)
    n = (tpad - 1) * hop + n_fft
    if dtype == "f32":
        padded = rng.standard_normal(n).astype(np.float32)
    else:
        padded = rng.integers(-32768, 32768, n, dtype=np.int16)
    window = port_hann_window(n_fft)
    x = torch.from_numpy(padded)
    got = _fft_pairs_reference(x, window, n_fft=n_fft, hop=hop)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    plain = dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-4, rtol=0)
    # the Pallas kernel wants whole tiles of frames: zero-pad the audio
    tile = 64
    t_jax = -(-tpad // tile) * tile
    padded_jax = np.pad(padded, (0, (t_jax - tpad) * hop))
    ref = jax_dft_magnitude(
        jnp.asarray(padded_jax), *map(jnp.asarray, jax_dft_mats(n_fft)),
        n_fft=n_fft, hop=hop, tile_frames=tile, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:tpad], atol=2e-4, rtol=0)


@pytest.mark.parametrize("hop", [512, 128, 64])
def test_fft_reference_other_hops(hop):
    """Any hop dividing n_fft, against numpy's rfft; atol 2e-4."""
    rng = np.random.default_rng(hop)
    tpad = 9
    padded = rng.standard_normal((tpad - 1) * hop + NFFT).astype(np.float32)
    got = _fft_pairs_reference(torch.from_numpy(padded), WINDOW, n_fft=NFFT, hop=hop)
    frames = np.stack([padded[i * hop : i * hop + NFFT] * WINDOW for i in range(tpad)])
    want = np.abs(np.fft.rfft(frames, axis=1))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_fft_reference_is_closer_to_float64_than_the_gemm():
    """An fp32 FFT does ~27 roundings per output where the 512-term fp32
    dot does 512, so against the float64 rfft it must not be worse."""
    rng = np.random.default_rng(5)
    tpad = 32
    padded = rng.standard_normal((tpad - 1) * HOP + NFFT).astype(np.float32)
    x = torch.from_numpy(padded)
    want = _numpy_mag(padded.astype(np.float64)).astype(np.float64)
    frames = np.stack([padded[i * HOP : i * HOP + NFFT] * WINDOW for i in range(tpad)])
    want = np.abs(np.fft.rfft(frames, axis=1))
    err_fft = np.abs(_fft_pairs_reference(x, WINDOW, n_fft=NFFT, hop=HOP).numpy() - want).max()
    err_gemm = np.abs(dft_magnitude_plain(x, WINDOW, n_fft=NFFT, hop=HOP).numpy() - want).max()
    assert err_fft <= err_gemm
    assert err_fft <= 2e-5  # magnitudes up to ~40: a few float32 ulps


MIXED_SIZES = [(384, 192), (352, 176), (768, 384), (704, 352), (1024, 256), (256, 128),
               (2048, 512), (375, 125)]


CHIRP = (2, 3, 5, 7, 11, 13, 17, 19)  # the chirp mode's lengths' primes


CLUSTER = CHIRP + (23,)  # the cluster layout's primes
MIXED = CLUSTER + (29, 31)  # the mixed route's and the staged route's primes


def _smooth(n, primes=MIXED):
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def test_dft_route_and_fft_plan_cover_the_smooth_sizes():
    """dft_route sends 512 to the FFT route, every other {2, 3, 5, 7, 11,
    13, 17, 19, 23, 29, 31}-smooth n_fft from 2 to 8192 to the mixed route
    (416, 1088, 1216, 1472, 464, 496, 1856, 1984, 4096, 4352, 8192), every
    {2, ..., 23}-smooth n_fft from 8193 to 81920 to the cluster layout
    (16384, 32768, 65536), every other n_fft from 2 to 40960 with a prime
    factor above 31 to the chirp mode (a prime, 470, 2038, 8198, 16418,
    24578), every other n_fft from 8193 to 2^20 to the staged route (14848
    = 2^9 * 29, 15872 = 2^9 * 31, 40962, 2 * 81920, 81922, 98304, 131072),
    and 1 to the GEMM; what lies above 2^20 raises (the GEMM's tables, 2.2 TB
    and more, fit on no card);
    fft_plan's radices multiply back to n_fft (for the chirp mode on the
    block layout to its convolution length, {2, ..., 19}-smooth): the
    power-of-two part first, in the fewest passes of radix 16 at most, split
    as evenly as possible with the larger radices first, then the odd
    primes in ascending order."""
    assert dft_route(512) == "fft"
    for n in (384, 352, 768, 704, 1024, 256, 2048, 375, 416, 13, 17, 19, 23, 1088, 1216, 368,
              1472, 4096, 4352, 8192, 29, 31, 464, 496, 1856, 1984, 3712, 7936, 899):
        assert dft_route(n) == "mixed"
    for n in (16384, 32768, 8232, 19683, 28561, 40960, 65536, 81920, 46189, 11776):
        assert dft_route(n) == "cluster"
    for n in (1021, 470, 2038, 37, 2053, 4093, 4097, 8198, 16381, 16411, 16418, 24578, 40959):
        assert dft_route(n) == "chirp"
    for n in (40961, 40962, 2 * CLUSTER_MAX, CLUSTER_MAX + 2, 81921, 98304, 131072, 59392,
              STAGED_MAX, 14848, 15872, 29 * 31 * 16):
        assert dft_route(n) == "staged"
    assert dft_route(1) == "point"
    for n in (STAGED_MAX + 1, 2 * STAGED_MAX, 3 * STAGED_MAX):
        with pytest.raises(ValueError, match="TB; no card holds them"):
            dft_route(n)
    assert MIXED_MAX == 8192 and CHIRP_MAX == 40960 and CLUSTER_MAX == 81920
    assert MIXED_PRIMES == MIXED and CLUSTER_PRIMES == CLUSTER and CHIRP_PRIMES == CHIRP
    routes = {n: dft_route(n) for n in range(1, CHIRP_MAX + 1)}
    mixed = [n for n, r in routes.items() if r == "mixed"]
    assert mixed == [n for n in range(2, MIXED_MAX + 1) if _smooth(n) and n != 512]
    chirp = [n for n, r in routes.items() if r == "chirp"]
    assert chirp == [n for n in range(2, CHIRP_MAX + 1) if not _smooth(n)]
    block = [n for n in chirp if n <= MIXED_MAX // 2]
    for n in mixed + [512] + [chirp_length(n) for n in block]:
        plan = fft_plan(n)
        assert int(np.prod(plan)) == n and set(plan) <= {2, 3, 4, 5, 7, 8, 11, 13, 16, 17, 19, 23,
                                                          29, 31}
        twos = [r for r in plan if r in (2, 4, 8, 16)]
        a = int(np.log2(np.prod(twos)))
        assert list(plan) == twos + sorted(r for r in plan if r not in twos)
        assert len(twos) == -(-a // 4) and twos == sorted(twos, reverse=True)
        assert not twos or twos[0] <= 2 * twos[-1]
    for n in block:
        m = chirp_length(n)
        assert 2 * n - 1 <= m <= min(4 * n, MIXED_MAX) and _smooth(m, CHIRP)
    for n in chirp[len(block)::397]:  # the cluster layout's lengths
        m = chirp_length(n)
        assert MIXED_MAX < 2 * n - 1 <= m <= min(4 * n, CLUSTER_MAX) and _smooth(m, CHIRP)
        assert _chirp_kernel(n) == "cluster"
    upto = [n for n in chirp if n <= 16384]  # of the lengths it may take, the fewest values
    for n in upto[::37] + chirp[len(block)::797] + chirp[len(upto)::2797]:  # moved
        m = chirp_length(n)
        top = min(4 * n, MIXED_MAX if n <= MIXED_MAX // 2 else CLUSTER_MAX)
        for k in range(2 * n - 1, top + 1):
            assert not _smooth(k, CHIRP) or (m * _passes(m), m) <= (k * _passes(k), k)
    # radix 17 gives 1088's length (2197 = 13^3 without it); 470's uses it,
    # 16418's radix 19 (247 x 133 = 13 * 19 x 7 * 19); radix 23 takes no
    # part (with it 8198 would take 16445 = 143 x 115 = 11 * 13 x 5 * 23)
    assert chirp_length(1088) == 2176 and chirp_length(470) == 952
    assert chirp_length(2038) == 4096 and chirp_length(8198) == 16456
    assert chirp_length(16418) == 32851 and chirp_length(24578) == 50864
    assert fft_plan(384) == (16, 8, 3) and fft_plan(352) == (8, 4, 11)
    assert fft_plan(1024) == (16, 8, 8) and fft_plan(375) == (3, 5, 5, 5)
    assert fft_plan(416) == (8, 4, 13) and fft_plan(8192) == (16, 8, 8, 8)
    assert fft_plan(1088) == (8, 8, 17) and fft_plan(4352) == (16, 16, 17)
    assert fft_plan(2431) == (11, 13, 17) and fft_plan(1216) == (8, 8, 19)
    assert fft_plan(952) == (8, 7, 17) and fft_plan(247) == (13, 19)
    assert fft_plan(1472) == (8, 8, 23) and fft_plan(368) == (16, 23)
    assert fft_plan(464) == (16, 29) and fft_plan(496) == (16, 31)
    assert fft_plan(1856) == (8, 8, 29) and fft_plan(1984) == (8, 8, 31)
    assert fft_plan(3712) == (16, 8, 29) and fft_plan(7936) == (16, 16, 31)
    for n in (37, 16384, 1, 29 * 37):
        with pytest.raises(ValueError):
            fft_plan(n)


def test_dft_route_partitions_every_size_to_twice_the_cluster_limit():
    """Every n_fft from 1 to 2 * 81920 has exactly one route, by its
    factors and size alone: 512 the FFT; a {2, ..., 31}-smooth n_fft the
    mixed route up to 8192; a {2, ..., 23}-smooth one the cluster layout
    from 8193 to 81920; one with a prime factor above 31 the chirp mode
    from 2 to 40960; every other n_fft from 8193 the staged route; the point
    kernel for 1 alone, and the GEMM for none (ROUTES names it for a caller
    that asks for it)."""
    counts = dict.fromkeys(ROUTES, 0)
    for n in range(1, 2 * CLUSTER_MAX + 1):
        route = dft_route(n)
        if n == 512:
            want = "fft"
        elif 2 <= n <= MIXED_MAX and _smooth(n):
            want = "mixed"
        elif MIXED_MAX < n <= CLUSTER_MAX and _smooth(n, CLUSTER):
            want = "cluster"
        elif 2 <= n <= CHIRP_MAX and not _smooth(n):
            want = "chirp"
        elif n > MIXED_MAX:
            want = "staged"
        else:
            want = "point"
        assert route == want, (n, route, want)
        counts[route] += 1
    assert sum(counts.values()) == 2 * CLUSTER_MAX and counts["fft"] == 1
    assert counts["point"] == 1 and dft_route(1) == "point" and counts["gemm"] == 0
    assert ROUTES == ("fft", "mixed", "cluster", "chirp", "staged", "point", "gemm")
    assert counts["staged"] == 2 * CLUSTER_MAX - MIXED_MAX - counts["cluster"] - sum(
        1 for n in range(MIXED_MAX + 1, CHIRP_MAX + 1) if not _smooth(n))


def test_no_n_fft_up_to_the_staged_reach_takes_the_gemm():
    """No n_fft from 2 to STAGED_MAX (2^20) routes to the GEMM, whose
    tables (4 N (N/2 + 1) bytes) no card holds there; each staged n_fft has
    a mode: the FFT mode where staged_plan splits it, else the chirp mode
    on a convolution length from 2 n_fft - 1 up to STAGED_M_MAX that
    staged_plan splits (checked on a sample: chirp_length at 2^20 takes a
    second)."""
    assert STAGED_MAX == 1 << 20 and STAGED_M_MAX == 2 * STAGED_MAX
    routes = [dft_route(n) for n in range(2, STAGED_MAX + 1)]
    assert "gemm" not in routes
    staged = [n for n, r in zip(range(2, STAGED_MAX + 1), routes) if r == "staged"]
    assert MIXED_MAX < staged[0] < CHIRP_MAX and staged[-1] == STAGED_MAX
    below = [n for n in staged if n <= CHIRP_MAX]  # a 29 or a 31: the FFT mode
    assert all(_smooth(n) and not _smooth(n, CLUSTER) for n in below)
    assert all(staged_mode(n) == "fft" for n in below)
    for n in staged[::20011] + [40962, 49154, 98304, 131072, STAGED_MAX - 1, STAGED_MAX]:
        if staged_mode(n) == "fft":
            n1, n2, _, _ = staged_plan(n)
            assert n1 * n2 == n and _smooth(n)
        else:
            m = chirp_length(n)
            assert 2 * n - 1 <= m <= min(4 * n, STAGED_M_MAX) and _smooth(m, CHIRP)
            assert staged_plan(m)[0] * staged_plan(m)[1] == m


def test_cluster_plan_splits_and_tables():
    """cluster_plan splits N = N1 * N2 with the fewest passes, then the most
    even split, on the fewest CTAs whose shared memory (cluster_bytes) fits
    twice on an SM: 2 up to 13338, 4 from 12167 to 25536, 8 from 24334
    (a CTA's buffers grow with N/C and its odd strides; 20736 = 144 x 144 on
    4, 32768 on 8), and where none fits twice, on 8 CTAs of one an SM (65536,
    81920, 50864); each side is at least C
    (every rank has columns and row pairs); four_step_roots are the float64
    roots of unity W_N^(k1 j) rounded once; cluster_tables hold the two
    sides' pass roots and the two float64 tables of twiddle_tables, whose
    products rounded once (product_twiddles, the kernel's twiddles) are
    four_step_roots at every twiddle of the power-of-two sizes and all but
    3 and 2 at the chirp lengths 16456 and 50864, one ulp away there; the
    packed plan holds the lengths the kernel checks."""
    assert cluster_plan(16384) == (128, 128, 4) and cluster_plan(32768) == (256, 128, 8)
    assert cluster_plan(16456) == (136, 121, 4) and cluster_plan(8228) == (121, 68, 2)
    assert cluster_plan(20480)[2] == 4 and cluster_plan(20736) == (144, 144, 4)
    assert cluster_plan(20482)[2] == 4 and cluster_plan(40960) == (256, 160, 8)
    assert cluster_plan(40964)[2] == 8 and cluster_plan(81920) == (320, 256, 8)
    assert cluster_plan(65536) == (256, 256, 8) and cluster_plan(32851) == (247, 133, 8)
    assert cluster_plan(50864) == (272, 187, 8)
    assert cluster_plan(13338)[2] == 2 and cluster_plan(25536)[2] == 4
    assert cluster_plan(24334)[2] == 8
    assert [cluster_bytes(*cluster_plan(n)) <= CLUSTER_PAIR_BYTES
            for n in (16384, 32768, 16456, 32851, 65536, 50864)] == [True] * 4 + [False] * 2
    for n in (MIXED_MAX, CLUSTER_MAX + 1, 16418, 1, 2 * CLUSTER_MAX):
        with pytest.raises(ValueError):
            cluster_plan(n)
    for n in (8232, 9801, 19683, 28561, 30000, 32768, 46189, 57344, 69632, 73728, 81796):
        n1, n2, ranks = cluster_plan(n)
        assert n1 * n2 == n and 2 <= n2 <= n1 <= MIXED_MAX and n2 >= ranks
        pair = [c for c in (2, 4, 8) if cluster_bytes(n1, n2, c) <= CLUSTER_PAIR_BYTES]
        assert ranks == (pair[0] if pair else 8)
        passes = len(fft_plan(n1)) + len(fft_plan(n2))
        for d in range(2, MIXED_MAX + 1):
            if n % d == 0 and n // d <= MIXED_MAX:
                assert passes <= len(fft_plan(d)) + len(fft_plan(n // d))
    n1, n2 = 24, 40
    t = four_step_roots(n1, n2)
    k1, j = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    want = np.exp(-2j * np.pi * (k1 * j % (n1 * n2)) / (n1 * n2)).reshape(-1)
    np.testing.assert_array_equal(t[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(t[:, 1], want.imag.astype(np.float32))
    n1, n2, ranks = cluster_plan(32768)
    table = cluster_tables(32768)
    len1, len2 = len(pass_roots(n1, fft_plan(n1))), len(pass_roots(n2, fft_plan(n2)))
    s = 1 << twiddle_split(32768)
    assert s == 256 and twiddle_split(16384) == 7 and twiddle_split(81920) == 9
    roots = len1 + len2 + (len1 + len2) % 2
    assert table.shape == (roots + 2 * (s + -(-32768 // s)), 2)
    np.testing.assert_array_equal(table[:len1], pass_roots(n1, fft_plan(n1)))
    np.testing.assert_array_equal(table[len1:len1 + len2], pass_roots(n2, fft_plan(n2)))
    np.testing.assert_array_equal(table[roots:].view(np.float64).reshape(-1, 2),
                                  np.concatenate(twiddle_tables(32768)))
    for n, differ in ((16384, 0), (32768, 0), (65536, 0), (81920, 0), (16456, 3), (32851, 0),
                      (50864, 2)):
        n1, n2, _ = cluster_plan(n)
        got = product_twiddles(n, np.arange(n1)[:, None] * np.arange(n2)[None, :])
        want = four_step_roots(n1, n2).reshape(n1, n2, 2)
        assert int((got != want).sum()) == differ, n
        assert np.abs(got - want).max() <= 2.0 ** -24
    assert list(_cluster_plan_array(32768)) == [8, 256, 128, len1, len2, 2, 16, 16, 2, 16, 8]
    assert list(_cluster_plan_array(65536)) == [8, 256, 256, 240, 240, 2, 16, 16, 2, 16, 16]


# csrc/dft_cluster_plan.cuh on the host: each argument "n_fft:chirp:packed
# plan", one JSON line each of what the kernel builds from it (the plan and
# every lookup)
PLAN_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#define __host__
#define __device__
#define __forceinline__ inline
#include "dft_cluster_plan.cuh"

static void list(const char* key, const int* v, int n) {
  std::printf("\"%s\": [", key);
  for (int i = 0; i < n; ++i) std::printf("%d%s", v[i], i + 1 < n ? ", " : "");
  std::printf("], ");
}

int main(int argc, char** argv) {
  for (int a = 1; a < argc; ++a) {
    char* p = argv[a];
    const int n_fft = std::strtol(p, &p, 10), chirp = std::strtol(p + 1, &p, 10);
    int packed[64], n = 0;
    while (*p == ':' || *p == ',') packed[n++] = std::strtol(p + 1, &p, 10);
    static Plan plan;
    const int err = make_plan(packed, n_fft, chirp != 0, &plan);
    std::printf("{\"err\": %d", err);
    if (err) { std::printf("}\n"); continue; }
    std::printf(", ");
    static int v[8192];
    for (int k = 0; k < plan.n1; ++k) v[k] = static_cast<int>(home_of_row(plan, k));
    list("home_row", v, plan.n1);
    for (int j = 0; j < plan.n2; ++j) v[j] = static_cast<int>(home_of_col(plan, j));
    list("home_col", v, plan.n2);
    std::printf("\"rows_k1\": [");
    for (int r = 0; r < plan.ranks; ++r) {
      const int rows = plan.alen[r] + plan.blen[r];
      std::printf("[");
      for (int l = 0; l < rows; ++l)
        std::printf("%d%s", row_of_local(plan, r, l), l + 1 < rows ? ", " : "");
      std::printf("]%s", r + 1 < plan.ranks ? ", " : "], ");
    }
    list("col_lo", plan.col_lo, plan.ranks + 1);
    std::printf("\"n1\": %d, \"n2\": %d, \"ranks\": %d, \"bytes\": %d, \"threads\": %d, "
                "\"tw_log2\": %d, \"table_bytes\": %d}\n",
                plan.n1, plan.n2, plan.ranks, plan.bytes, threads_of(plan), plan.tw_log2,
                plan.table_bytes);
  }
}
"""


@pytest.fixture(scope="module")
def plan_header(tmp_path_factory):
    """A host build of csrc/dft_cluster_plan.cuh (PLAN_MAIN) with g++, and a
    function that runs it: [(n_fft, chirp, packed plan)] -> one dict each."""
    import json
    import shutil
    import subprocess

    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler, "no C++ compiler"
    out = tmp_path_factory.mktemp("plan")
    (out / "plan.cpp").write_text(PLAN_MAIN)
    subprocess.run([compiler, "-std=c++17", "-O1", f"-I{_build.CSRC}", "-o", str(out / "plan"),
                    str(out / "plan.cpp")], check=True)

    def run(cases):
        args = [f"{n}:{c}:" + ",".join(map(str, packed)) for n, c, packed in cases]
        lines = subprocess.run([str(out / "plan"), *args], capture_output=True, text=True,
                               check=True).stdout.splitlines()
        return [json.loads(line) for line in lines]
    return run


def _packed(ranks, n1, n2):
    """[C, N1, N2, len1, len2, P1, radices, P2, radices], as
    _cluster_plan_array packs cluster_plan's, for any split and C."""
    p1, p2 = fft_plan(n1), fft_plan(n2)
    return [ranks, n1, n2, len(pass_roots(n1, p1)), len(pass_roots(n2, p2)), len(p1), *p1,
            len(p2), *p2]


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_cluster_plan_header_places_each_column_and_row_once(plan_header, ranks):
    """On every cluster size the kernel runs, the plans it is given
    (cluster_plan's at 9801, 10240, 16384, 32768 and 65536, the chirp
    mode's 16456, 32851 and 50864, and small splits with odd N1 and N2), as
    csrc/dft_cluster_plan.cuh builds them, each in both modes (the FFT mode
    at N1 N2, the chirp mode on M = N1 N2): the ranks' column ranges cover
    each column exactly once and home_col finds each at its rank and local
    column; the ranks' rows (row_of_local) cover each row k1 exactly once,
    home_row finds each at its rank and local row (the lookups round-trip),
    and each mirror row n1 - k1 lies on the rank of k1."""
    sizes = {2: [(9801, 99, 99), (10240, 128, 80)], 4: [(16384, 128, 128), (16456, 136, 121)],
             8: [(32768, 256, 128), (32851, 247, 133), (65536, 256, 256), (50864, 272, 187)]}
    small = {2: [(9, 7), (10, 3)], 4: [(15, 9), (20, 7)], 8: [(21, 11), (24, 9)]}
    plans = sizes[ranks] + [(n1 * n2, n1, n2) for n1, n2 in small[ranks]]
    args, what = [], []
    for m, n1, n2 in plans:
        if m > MIXED_MAX:
            assert cluster_plan(m) == (n1, n2, ranks)
        for n_fft, chirp in ((m, 0), ((m + 1) // 2, 1)):
            args.append((n_fft, chirp, _packed(ranks, n1, n2)))
            what.append((n_fft, chirp, n1, n2))
    for (n_fft, chirp, n1, n2), got in zip(what, plan_header(args), strict=True):
        assert got["err"] == 0 and got["ranks"] == ranks, (n_fft, got)
        col_lo = got["col_lo"]
        assert col_lo[0] == 0 and col_lo[-1] == n2 and all(
            a < b for a, b in zip(col_lo, col_lo[1:]))
        for j, h in enumerate(got["home_col"]):
            r, local = h >> 16, h & 0xFFFF
            assert col_lo[r] <= j < col_lo[r + 1] and local == j - col_lo[r]
        rows = [k for ranks_rows in got["rows_k1"] for k in ranks_rows]
        assert sorted(rows) == list(range(n1))
        for r, ranks_rows in enumerate(got["rows_k1"]):
            for local, k1 in enumerate(ranks_rows):
                assert got["home_row"][k1] == r << 16 | local
                assert got["home_row"][(n1 - k1) % n1] >> 16 == r
        assert got["tw_log2"] == twiddle_split(n1 * n2)


def test_cluster_plan_header_takes_every_plan_on_its_layout(plan_header):
    """make_plan takes cluster_plan's plan at every n_fft of the cluster route
    and at the convolution lengths of a spread of the chirp mode's sizes on
    the cluster layout, its shared memory within the card's 227 KB and equal
    to ops/dft.py::cluster_bytes; a plan that fits twice on an SM (every
    plan up to 40960 points, and up to about 48000 on 8 CTAs) runs 256
    threads a CTA, two frame pairs in flight on every SM, a larger one
    (65536, 81920 and 50864: 8 CTAs of 120 to 190 KB) one CTA of 512 an SM."""
    fft_sizes = [n for n in range(MIXED_MAX + 1, CLUSTER_MAX + 1) if dft_route(n) == "cluster"]
    # chirp_length takes a few ms a size: a spread of the chirp mode's sizes
    chirp = [n for n in [*range(MIXED_MAX // 2 + 1, CHIRP_MAX + 1, 397), 8198, 16418, 24578]
             if dft_route(n) == "chirp" and _chirp_kernel(n) == "cluster"]
    assert len(fft_sizes) > 1000 and len(chirp) > 60
    cases = [(n, 0, _cluster_plan_array(n)) for n in fft_sizes]
    cases += [(n, 1, _cluster_plan_array(chirp_length(n))) for n in chirp]
    threads = {}
    for (n, chirp_mode, packed), got in zip(cases, plan_header(cases), strict=True):
        m = packed[1] * packed[2]
        assert got["err"] == 0 and got["bytes"] <= 232448, (n, got)
        assert got["bytes"] == cluster_bytes(packed[1], packed[2], packed[0]), (n, got)
        pair = got["bytes"] <= CLUSTER_PAIR_BYTES
        assert got["threads"] == (256 if pair else 512) and (pair or m > 40960), (n, m, got)
        threads[m] = got["threads"]
    assert [threads[m] for m in (16384, 32768, 65536, 81920, 16456, 32851, 50864)] == [
        256, 256, 512, 512, 256, 256, 512]


def test_compiled_cluster_plans_are_cluster_plans_in_the_build_that_runs_them():
    """csrc/dft_cluster.cu compiles whole the plans of the powers of two
    16384, 32768 and 65536 (Fixed<R0, R1, R2, R3, C>: N1 = R0 R1, N2 = R2 R3
    on C CTAs), each cluster_plan's split, CTAs and fft_plan radices, in the
    build of the least odd radix, which _build_variant gives them in every
    sample type."""
    import re

    source = (_build.CSRC / "dft_cluster.cu").read_text()
    table = re.search(r"#if ORCAI_ODD == (\d+)\nusing Compiled = Plans<(.*?)>;\n#else", source,
                      re.S)
    builds = sorted({odd for odd, _ in _build.VARIANTS["dft_cluster"]})
    assert int(table.group(1)) == builds[0]
    plans = [tuple(int(v) for v in m) for m in
             re.findall(r"Fixed<(\d+), (\d+), (\d+), (\d+), (\d+)>", table.group(2))]
    assert sorted(r0 * r1 * r2 * r3 for r0, r1, r2, r3, _ in plans) == [16384, 32768, 65536]
    for r0, r1, r2, r3, ranks in plans:
        n1, n2 = r0 * r1, r2 * r3
        assert cluster_plan(n1 * n2) == (n1, n2, ranks) and dft_route(n1 * n2) == "cluster"
        assert fft_plan(n1) == (r0, r1) and fft_plan(n2) == (r2, r3)
        for dtype in (torch.float32, torch.int16, torch.uint8):
            assert _build_variant("cluster", n1 * n2, dtype)[0] == builds[0]


def test_compiled_cluster_plans_are_every_plan_whose_radices_are_powers_of_two():
    """The plans csrc/dft_cluster.cu compiles whole are the cluster route's
    plans whose radices are all powers of two, every one of them: over the
    route's whole reach (every n_fft from MIXED_MAX + 1 to CLUSTER_MAX that
    dft_route sends to it) those are 16384, 32768 and 65536, and every other
    size, each a plan of its own, has an odd radix and runs the generic
    kernel."""
    import re

    source = (_build.CSRC / "dft_cluster.cu").read_text()
    table = re.search(r"using Compiled = Plans<(.*?)>;", source, re.S).group(1)
    compiled = {int(np.prod([int(v) for v in m[:4]]))
                for m in re.findall(r"Fixed<(\d+), (\d+), (\d+), (\d+), (\d+)>", table)}
    powers_of_two, plans = set(), set()
    for n in range(MIXED_MAX + 1, CLUSTER_MAX + 1):
        if dft_route(n) != "cluster":
            continue
        n1, n2, ranks = cluster_plan(n)
        radices = fft_plan(n1) + fft_plan(n2)
        plans.add((fft_plan(n1), fft_plan(n2), ranks))
        if all(r & (r - 1) == 0 for r in radices):
            powers_of_two.add(n)
    assert compiled == powers_of_two == {16384, 32768, 65536}
    assert len(plans) > 2000


@pytest.mark.parametrize("probe", ["kernel", "no_passes", "no_exchange", "no_tables",
                                   "no_stores", "generic"])
def test_probe_cluster_copies_edit_the_source(probe):
    """tools/probe_cluster.py builds its own copies of csrc/dft_cluster.cu
    and the headers it edits: each probe's edits find their text as often
    as they expect in the shipped source, the copy holds each replacement
    and nothing is left of what it replaced, the kernel probe is the source
    itself, and the shipped source keeps no probe."""
    from orcai_tpu_torch.tools.probe_cluster import EDITS, PROBES, probe_sources

    assert probe in PROBES
    files = probe_sources(probe)
    shipped = {name: (_build.CSRC / name).read_text() for name in files}
    if probe == "kernel":
        assert files == shipped
    for name, edits in EDITS.get(probe, {}).items():
        for old, new, count in edits:
            assert shipped[name].count(old) == count and new in files[name]
            assert old not in files[name] or old in new
    assert "probe" not in shipped["dft_cluster.cu"].lower().replace("probe_cluster", "")


def test_b1_tools_cover_the_cluster_layout_and_stop_without_a_card():
    """tools/ab_b1_sizes.py's default sizes hold the cluster route's compiled
    plans (16384, 32768 and 65536, on 11251 frames), its generic kernel
    (20736 and 40960, on 11251 frames) and the chirp mode on both of its
    cluster layouts (8198 and 16418 two CTAs an SM, 24578 on 11251 frames
    one), and tools/probe_cluster.py stops without a card."""
    from orcai_tpu_torch.tools import ab_b1_sizes, probe_cluster

    sizes = set(ab_b1_sizes.DEFAULT_SIZES.split(","))
    assert {"16384/8192", "32768/16384", "65536/32768/11251", "8198/4099", "16418/8209",
            "24578/12289/11251", "20736/10368/11251", "40960/20480/11251"} <= sizes
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe_cluster.main([])


@pytest.mark.parametrize("n_fft,hop,m,split", [
    (1024, 512, None, (32, 32)),     # 16384 = 128 x 128: a square power of two
    (2048, 1024, None, (64, 32)),    # 32768 = 256 x 128
    (4096, 2048, None, (64, 64)),    # 65536 = 256 x 256
    (2560, 1280, None, (80, 32)),    # 81920 = 320 x 256
    (1296, 648, None, (36, 36)),     # 20736 = 144 x 144: three passes a side, radix 3
    (93, 93, 187, (17, 11)),         # the chirp mode's 16456 = 136 x 121: odd N2
    (181, 181, 361, (19, 19)),       # 32851 = 247 x 133: radix 19 on both sides
    (131, 131, 272, (16, 17)),       # 50864 = 272 x 187: radix 17 on both sides
])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_cluster_references_on_the_plans_splits_match_pallas(n_fft, hop, m, split, dtype):
    """The cluster kernel's arithmetic with its product twiddles
    (_fft_cluster_reference, _chirp_cluster_reference) on small splits of
    the shapes cluster_plan picks at the route's and the chirp mode's sizes,
    against the Pallas kernel in interpret mode and numpy's float64 rfft,
    atol 2e-4, on an odd frame count."""
    tpad = 9
    padded, as_f64 = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft + split[0])
    window = port_hann_window(n_fft)
    x = torch.from_numpy(padded)
    got = (_fft_cluster_reference(x, window, n_fft=n_fft, hop=hop, split=split) if m is None
           else _chirp_cluster_reference(x, window, n_fft=n_fft, hop=hop, m=m, split=split))
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, tpad), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), _rfft_mag(as_f64, window, n_fft, hop), atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("n_fft,hop", MIXED_SIZES)
@pytest.mark.parametrize("tpad", [64, 37])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_fft_mixed_reference_matches_pallas_and_float64(n_fft, hop, tpad, dtype):
    """The mixed route's arithmetic (two frames per complex FFT, one
    Stockham pass per radix of fft_plan with the kernel's tables, index
    maps and butterfly constants, untangle) against the Pallas kernel in
    interpret mode and numpy's float64 rfft, atol 2e-4 (the reference
    suite's DFT bar), at an even and an odd frame count; odd N included."""
    rng = np.random.default_rng(n_fft + tpad)
    n = (tpad - 1) * hop + n_fft
    pcm = rng.integers(-32768, 32768, n, dtype=np.int16)
    padded = {"f32": (0.3 * rng.standard_normal(n)).astype(np.float32), "int16": pcm,
              "uint8": mulaw_encode(pcm)}[dtype]
    window = port_hann_window(n_fft)
    got = _fft_mixed_reference(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    as_f64 = {"f32": padded.astype(np.float64), "int16": pcm / 32768.0,
              "uint8": mulaw_decode_host(padded) / 32768.0}[dtype]
    frames = np.stack([as_f64[i * hop : i * hop + n_fft] * window for i in range(tpad)])
    np.testing.assert_allclose(got.numpy(), np.abs(np.fft.rfft(frames, axis=1)), atol=2e-4, rtol=0)
    tile = 32
    padded_jax = np.pad(padded, (0, (-(-tpad // tile) * tile - tpad) * hop))
    ref = _pallas(padded_jax, n_fft, hop, tile)[:tpad]
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("n_fft,hop", MIXED_SIZES)
def test_fft_mixed_reference_of_codes_is_of_their_int16_decode(n_fft, hop):
    """Codes and their host decode to int16 are the same float samples
    through the mixed route's arithmetic: bit-equal."""
    rng = np.random.default_rng(n_fft)
    codes = mulaw_encode(rng.integers(-32768, 32768, 37 * hop + n_fft, dtype=np.int16))
    window = port_hann_window(n_fft)
    a = _fft_mixed_reference(torch.from_numpy(codes), window, n_fft=n_fft, hop=hop)
    b = _fft_mixed_reference(torch.from_numpy(mulaw_decode_host(codes)), window,
                             n_fft=n_fft, hop=hop)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n_fft,hop", [(384, 192), (352, 176)])
def test_fft_mixed_reference_is_no_farther_from_float64_than_the_gemm(n_fft, hop):
    """An 11-point direct DFT rounds more than a radix-8 one, but the
    mixed FFT's few roundings an output still beat the n_fft-term fp32
    dot against the float64 rfft, as at 512."""
    rng = np.random.default_rng(n_fft)
    tpad = 32
    padded = rng.standard_normal((tpad - 1) * hop + n_fft).astype(np.float32)
    x = torch.from_numpy(padded)
    window = port_hann_window(n_fft)
    frames = np.stack([padded[i * hop : i * hop + n_fft] * window for i in range(tpad)])
    want = np.abs(np.fft.rfft(frames, axis=1))
    err_fft = np.abs(_fft_mixed_reference(x, window, n_fft=n_fft, hop=hop).numpy() - want).max()
    err_gemm = np.abs(dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop).numpy() - want).max()
    assert err_fft <= err_gemm
    assert err_fft <= 2e-5


NEW_SIZES = [(416, 208), (4096, 2048), (8192, 4096), (1088, 544), (2038, 1019), (1021, 1021),
             (4352, 2176), (1216, 608), (470, 235), (1472, 736)]


def _reference(n_fft):
    """The step-by-step arithmetic of the CUDA route that takes n_fft."""
    return {"mixed": _fft_mixed_reference, "chirp": _chirp_reference}[dft_route(n_fft)]


@pytest.mark.parametrize("n_fft,hop", NEW_SIZES)
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_mixed_and_chirp_references_at_the_new_sizes(n_fft, hop, dtype):
    """The mixed route at 416 (8, 4, 13), 4096, 8192, with radix 17 at 1088
    (8, 8, 17) and 4352 (16, 16, 17), with radix 19 at 1216 (8, 8, 19) and
    with radix 23 at 1472 (8, 8, 23), and the chirp mode at 2038, the prime 1021 and 470 = 2 * 5 * 47 (two
    Bluestein FFTs of the kernel's passes with its chirp tables; M = 952 =
    8 * 7 * 17) against the Pallas kernel in interpret mode, atol 2e-4, and
    no farther from numpy's float64 rfft than the plain version (the framed
    fp32 GEMM), in float32, int16 and uint8."""
    rng = np.random.default_rng(n_fft + hop)
    tpad = 64 if n_fft < 4352 else 32
    n = (tpad - 1) * hop + n_fft
    pcm = rng.integers(-32768, 32768, n, dtype=np.int16)
    padded = {"f32": (0.3 * rng.standard_normal(n)).astype(np.float32), "int16": pcm,
              "uint8": mulaw_encode(pcm)}[dtype]
    window = port_hann_window(n_fft)
    x = torch.from_numpy(padded)
    got = _reference(n_fft)(x, window, n_fft=n_fft, hop=hop)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, 32), atol=2e-4, rtol=0)
    as_f64 = {"f32": padded.astype(np.float64), "int16": pcm / 32768.0,
              "uint8": mulaw_decode_host(padded) / 32768.0}[dtype]
    frames = np.lib.stride_tricks.sliding_window_view(as_f64, n_fft)[::hop] * window
    want = np.abs(np.fft.rfft(frames, axis=1))
    err = np.abs(got.numpy() - want).max()
    err_plain = np.abs(dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop).numpy() - want).max()
    assert err <= err_plain, (err, err_plain)


@pytest.mark.parametrize("n_fft,hop", [(470, 235), (1088, 544), (1021, 1021), (19, 19), (17, 17),
                                       (23, 23)])
def test_chirp_reference_odd_count_and_codes(n_fft, hop):
    """The chirp mode at an odd frame count (a phantom second frame of
    zeros) against numpy's float64 rfft, atol 2e-4, and the codes through
    it bit-equal to their host decode to int16."""
    rng = np.random.default_rng(n_fft)
    tpad = 37
    pcm = rng.integers(-32768, 32768, (tpad - 1) * hop + n_fft, dtype=np.int16)
    codes = mulaw_encode(pcm)
    window = port_hann_window(n_fft)
    got = _chirp_reference(torch.from_numpy(pcm), window, n_fft=n_fft, hop=hop)
    frames = np.lib.stride_tricks.sliding_window_view(pcm / 32768.0, n_fft)[::hop] * window
    np.testing.assert_allclose(got.numpy(), np.abs(np.fft.rfft(frames, axis=1)), atol=2e-4,
                               rtol=0)
    a = _chirp_reference(torch.from_numpy(codes), window, n_fft=n_fft, hop=hop)
    b = _chirp_reference(torch.from_numpy(mulaw_decode_host(codes)), window, n_fft=n_fft,
                         hop=hop)
    assert torch.equal(a, b)


def _signal(dtype, n, seed):
    """(samples, their float64 values) of a synthetic tile."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, n, dtype=np.int16)
    padded = {"f32": (0.3 * rng.standard_normal(n)).astype(np.float32), "int16": pcm,
              "uint8": mulaw_encode(pcm)}[dtype]
    as_f64 = {"f32": padded.astype(np.float64), "int16": pcm / 32768.0,
              "uint8": mulaw_decode_host(padded) / 32768.0}[dtype]
    return padded, as_f64


def _rfft_mag(as_f64, window, n_fft, hop):
    frames = np.lib.stride_tricks.sliding_window_view(as_f64, n_fft)[::hop] * window
    return np.abs(np.fft.rfft(frames, axis=1))


@pytest.mark.parametrize("n_fft,hop,split", [(1024, 256, (32, 32)), (2048, 512, (64, 32)),
                                             (1000, 500, (40, 25))])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_cluster_reference_at_small_splits_matches_pallas(n_fft, hop, split, dtype):
    """The cluster layout's arithmetic (the four steps: N1-point column
    FFTs, the four-step twiddles, N2-point row FFTs, then the untangle) at
    small splits against the Pallas kernel in interpret mode and numpy's
    float64 rfft, atol 2e-4; the split changes the arithmetic, the kernel's
    rank count does not."""
    tpad = 32
    padded, as_f64 = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft + split[1])
    window = port_hann_window(n_fft)
    got = _fft_cluster_reference(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop,
                                 split=split)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, 32), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), _rfft_mag(as_f64, window, n_fft, hop), atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("n_fft,hop,m,split", [(1021, 1021, 2048, (64, 32)),
                                               (607, 607, 1224, (51, 24)),
                                               (1216, 608, 2448, (48, 51))])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_chirp_cluster_reference_at_small_splits_matches_pallas(n_fft, hop, m, split, dtype):
    """The chirp mode on the cluster layout (the first FFT in four steps,
    the product with B where it leaves each value, the second FFT rows
    first) at small lengths and splits against the Pallas kernel in
    interpret mode and numpy's float64 rfft, atol 2e-4."""
    tpad = 32
    padded, as_f64 = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft + m)
    window = port_hann_window(n_fft)
    got = _chirp_cluster_reference(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop, m=m,
                                   split=split)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, 32), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), _rfft_mag(as_f64, window, n_fft, hop), atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("n_fft,hop,tpad", [(16384, 8192, 3), (32768, 16384, 2),
                                            (8198, 4099, 3), (16383, 16383, 2),
                                            (16418, 8209, 3), (24578, 12289, 2),
                                            (65536, 32768, 2)])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_cluster_references_at_the_route_sizes_match_float64(n_fft, hop, tpad, dtype):
    """The cluster route's arithmetic at 16384 (128 x 128), 32768 (256 x
    128) and 65536 (256 x 256, 8 CTAs), and the chirp mode on the cluster
    layout at 8198 (M = 16456 = 136 x 121), 16383 (M = 32768), 16418 (M =
    32851 = 247 x 133, radix 19 on both sides, 4 CTAs) and 24578 (M = 50864
    = 272 x 187, 8 CTAs), on a few frames (an odd count included) against
    numpy's float64 rfft, atol 2e-4; the codes through each bit-equal to
    their host decode to int16. (The Pallas kernel's matrices at these sizes
    are too heavy for this suite.)"""
    padded, as_f64 = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft + tpad)
    window = port_hann_window(n_fft)
    ref = (_fft_cluster_reference if dft_route(n_fft) == "cluster"
           else _chirp_cluster_reference)
    assert dft_route(n_fft) == "cluster" or _chirp_kernel(n_fft) == "cluster"
    got = ref(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _rfft_mag(as_f64, window, n_fft, hop), atol=2e-4,
                               rtol=0)
    if dtype == "uint8":
        decoded = ref(torch.from_numpy(mulaw_decode_host(padded)), window, n_fft=n_fft, hop=hop)
        assert torch.equal(got, decoded)


@pytest.mark.parametrize("n_fft,hop,split", [(96, 48, (8, 12)), (240, 120, (16, 15)),
                                             (105, 105, (7, 15)), (1984, 992, (62, 32))])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_staged_reference_at_small_splits_matches_pallas(n_fft, hop, split, dtype):
    """The staged route's arithmetic (kernel 1's N1-point column FFTs and
    the four-step twiddles, kernel 2's N2-point row FFTs and the untangle)
    at small splits, an even and an odd N1 (7: row 0 alone pairs with
    itself) and radix 31 on the column side, against the Pallas kernel in
    interpret mode and numpy's float64 rfft, atol 2e-4."""
    tpad = 32
    padded, as_f64 = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft + split[0])
    window = port_hann_window(n_fft)
    got = _staged_reference(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop, split=split)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, 32), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), _rfft_mag(as_f64, window, n_fft, hop), atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("n_fft,hop,m,split", [(47, 47, 96, (8, 12)), (101, 101, 210, (15, 14)),
                                               (1021, 1021, 2048, (32, 64))])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_chirp_staged_reference_at_small_splits_matches_pallas(n_fft, hop, m, split, dtype):
    """The staged route's chirp mode (kernel 1 the first FFT's columns,
    kernel 2 its rows, the product with B and the second FFT's rows, kernel
    3 its columns, kernel 4 a[k] conj u[k] and the untangle) at small
    lengths and splits, an odd N1 among them, against the Pallas kernel in
    interpret mode and numpy's float64 rfft, atol 2e-4."""
    tpad = 32
    padded, as_f64 = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft + m)
    window = port_hann_window(n_fft)
    got = _chirp_staged_reference(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop, m=m,
                                  split=split)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, 32), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), _rfft_mag(as_f64, window, n_fft, hop), atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("n_fft,hop,m,split", [(47, 47, 96, (8, 12)), (101, 101, 210, (15, 14)),
                                               (1021, 1021, 2048, (32, 64))])
def test_chirp_staged_reference_takes_the_product_twiddles(n_fft, hop, m, split):
    """The staged chirp mode's arithmetic forms both FFTs' four-step
    twiddles as products of two float64 tables (product_twiddles, the
    kernels' twiddle and twiddled), as the FFT mode and the cluster route
    do: at the small splits it is the cluster route's chirp arithmetic on
    the same split bit for bit, kernel 3's fold walk keeps those bits, and
    the tables its kernels read are the product layout (staged_tables)."""
    padded, _ = _signal("int16", 31 * hop + n_fft, n_fft + 2 * m)
    x, window = torch.from_numpy(padded), port_hann_window(n_fft)
    got = _chirp_staged_reference(x, window, n_fft=n_fft, hop=hop, m=m, split=split)
    assert torch.equal(got, _chirp_cluster_reference(x, window, n_fft=n_fft, hop=hop, m=m,
                                                     split=split))
    assert torch.equal(got, _chirp_staged_fold_reference(x, window, n_fft=n_fft, hop=hop, m=m,
                                                         split=split))
    if split == staged_plan(m)[:2]:
        np.testing.assert_array_equal(staged_tables(m), cluster_tables(m, split))


@pytest.mark.parametrize("n_fft,hop,tpad", [(40962, 20481, 3), (131072, 65536, 2),
                                            (98304, 49152, 2), (49154, 24577, 2)])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_staged_references_at_the_route_sizes_match_float64(n_fft, hop, tpad, dtype):
    """The staged route at its sizes: 40962 and 49154 in its chirp mode (M =
    chirp_length: 82688 = 256 x 323, 104329 = 289 x 361), 131072 (256 x
    512) and 98304 (256 x 384) in its FFT mode, on a few frames (an odd
    count included) against numpy's float64 rfft, atol 2e-4; the codes
    through each bit-equal to their host decode to int16. (No Pallas
    matrices or plain tables at these sizes: 6.7 GB and more.)"""
    padded, as_f64 = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft + tpad)
    window = port_hann_window(n_fft)
    assert dft_route(n_fft) == "staged"
    ref = _staged_reference if staged_mode(n_fft) == "fft" else _chirp_staged_reference
    got = ref(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _rfft_mag(as_f64, window, n_fft, hop), atol=2e-4,
                               rtol=0)
    if dtype == "uint8":
        decoded = ref(torch.from_numpy(mulaw_decode_host(padded)), window, n_fft=n_fft, hop=hop)
        assert torch.equal(got, decoded)


# The staged route's top reach (ROADMAP C1). The reference suite's bar is an
# absolute 2e-4 on magnitudes that grow with n_fft: no float32 FFT holds it
# far past 2^19. Where the step-by-step reference holds it, it is asserted;
# where it cannot hold, the reference is held to within C1_FACTOR of float32
# torch.fft.rfft's own error on the same windowed frames. The factor is set
# from the readings of test_staged_reach_holds_float32s_own_error (0.91x at
# 524290, 0.08x at 2^20, 1.03x at 2^20 - 2) with room for other draws of
# the noise, which move the ratio.
C1_FACTOR = 1.25


@pytest.mark.parametrize("n_fft,holds_2e4", [(524288, True), (524290, False),
                                             (1 << 20, False), ((1 << 20) - 2, False)])
def test_staged_reach_holds_float32s_own_error(n_fft, holds_2e4, record_property):
    """The staged route's references at the top of its reach and on each
    side of where 2e-4 stops holding: 524288 (FFT mode, 256 x 2048) and
    524290 (chirp mode, M = 1074944 = 256 x 4199), 2^20 (FFT mode) and
    2^20 - 2 (chirp mode, M = 2^21 = 512 x 4096), on 2 full-scale int16
    noise frames against numpy's float64 rfft. Each records its reading
    beside float32 torch.fft.rfft's on the same windowed frames
    (`max_abs_err`, `rfft_f32_max_abs_err`). At 524288 the reference holds
    2e-4 (1.885e-4, torch.fft.rfft 1.878e-4: this size is the crossing, and
    other draws of the noise land on either side of the bar); above, it is
    held within C1_FACTOR (1.25x) of torch.fft.rfft's own error."""
    hop, tpad = n_fft // 2, 2
    padded, as_f64 = _signal("int16", (tpad - 1) * hop + n_fft, 0)
    window = port_hann_window(n_fft)
    assert dft_route(n_fft) == "staged"
    ref = _staged_reference if staged_mode(n_fft) == "fft" else _chirp_staged_reference
    got = ref(torch.from_numpy(padded), window, n_fft=n_fft, hop=hop).numpy()
    frames = np.lib.stride_tricks.sliding_window_view(as_f64, n_fft)[::hop] * window
    want = np.abs(np.fft.rfft(frames, axis=1))
    err = float(np.abs(got - want).max())
    err_f32 = float(np.abs(torch.fft.rfft(torch.from_numpy(frames.astype(np.float32)),
                                          dim=1).abs().numpy() - want).max())
    record_property("max_abs_err", err)
    record_property("rfft_f32_max_abs_err", err_f32)
    print(f"n_fft {n_fft} ({staged_mode(n_fft)} mode): reference {err:.3e}, "
          f"float32 torch.fft.rfft {err_f32:.3e}")
    if holds_2e4:
        assert err <= 2e-4
    else:
        assert err > 2e-4 and err <= C1_FACTOR * err_f32


@pytest.mark.parametrize("n_fft,m,split", [(40962, None, None), (49154, None, None),
                                           ((1 << 20) - 2, None, None), (101, 225, (15, 15)),
                                           (47, 96, (8, 12)), (101, 210, (15, 14))])
def test_staged_mirror_groups_hold_each_bin_once_with_its_mirror(n_fft, m, split):
    """The staged chirp mode's kernel 3 (csrc/dft_staged.cu) on the column
    groups of staged_mirror_groups: every column lies in one group; a
    group's columns f + d are adjacent (mod N2) and its partners too; its
    two buffers fit two CTAs on an SM; walked as the kernel walks them
    (rows p1 <= (n_fft/2) / N2 of each column p2, bins k = N2 p1 + p2 <=
    n_fft / 2), every bin k <= n_fft / 2 is written once, and its mirror
    n_fft - k (k itself at 0) lies in the same group, in the partner column
    (r - p2) mod N2 at row q - p1, or q - p1 - 1 where p2 > r. At 40962 (N1
    256, N2 323), 49154 (289, 361), 2^20 - 2 (512, 4096, where two columns
    are their own partners) and small splits with an odd N1 and N2 (15 x
    15), an even N2 and an odd n_fft (8 x 12: e = 1, no column alone)."""
    m = m or chirp_length(n_fft)
    n1, n2 = staged_plan(m, split)[:2]
    g3, f, e = staged_fold(n_fft, m, split)
    assert e in (0, 1) and (2 * f + e - n_fft) % n2 == 0
    assert _staged_bytes(n1, 2 * g3) <= STAGED_CTA_BYTES
    groups = staged_mirror_groups(n_fft, m, split)
    group_of = np.full(n2, -1)
    for i, (a, b) in enumerate(groups):
        assert 1 <= len(a) <= g3 and len(b) <= len(a)
        assert all((y - x) % n2 == 1 for x, y in zip(a, a[1:]))
        assert all((x - y) % n2 == 1 for x, y in zip(b, b[1:]))
        for c in a + b:
            assert group_of[c] == -1
            group_of[c] = i
    assert (group_of >= 0).all()
    q, r = divmod(n_fft, n2)
    written = np.zeros(n_fft // 2 + 1, dtype=np.int64)
    for i, (a, b) in enumerate(groups):
        cols = np.array(a + b)
        p1 = np.arange((n_fft // 2) // n2 + 1)[:, None]
        k = (p1 * n2 + cols[None, :]).reshape(-1)
        p1 = np.broadcast_to(p1, (p1.shape[0], cols.size)).reshape(-1)
        p2 = np.broadcast_to(cols, (len(p1) // cols.size, cols.size)).reshape(-1)
        keep = k <= n_fft // 2
        k, p1, p2 = k[keep], p1[keep], p2[keep]
        np.add.at(written, k, 1)
        partner = (r - p2) % n2
        assert (group_of[partner] == i).all()
        row = np.where(p2 <= r, q - p1, q - p1 - 1)
        mirror = np.where(k == 0, 0, row * n2 + partner)
        assert (mirror == np.where(k == 0, 0, n_fft - k)).all()
    assert (written == 1).all()


@pytest.mark.parametrize("n_fft,hop,m,split", [(47, 47, 96, (8, 12)), (101, 101, 210, (15, 14)),
                                               (1021, 1021, 2048, (32, 64))])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_chirp_staged_fold_walk_is_bit_equal_to_the_reference(n_fft, hop, m, split, dtype):
    """The staged chirp mode's kernel 3 walked step by step
    (`_chirp_staged_fold_reference`: the N1-point FFTs of each group's
    columns, then a conj u and the untangle of each bin of its columns with
    its mirror from the partner column) is bit-equal to
    `_chirp_staged_reference` at the small splits of
    test_chirp_staged_reference_at_small_splits_matches_pallas: the same
    arithmetic in another order."""
    tpad = 5
    padded, _ = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft + m + 1)
    window = port_hann_window(n_fft)
    x = torch.from_numpy(padded)
    got = _chirp_staged_fold_reference(x, window, n_fft=n_fft, hop=hop, m=m, split=split)
    want = _chirp_staged_reference(x, window, n_fft=n_fft, hop=hop, m=m, split=split)
    assert got.shape == want.shape == (tpad, n_fft // 2 + 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_fft", [STAGED_MAX + 1, STAGED_MAX + 2, 3 << 20])
def test_no_route_above_the_staged_reach(n_fft):
    """Above STAGED_MAX (2^20) only the GEMM route would be left, whose
    window-folded tables take 4 N (N/2 + 1) bytes (2.2 TB at 2^20 + 2):
    dft_route and dft_magnitude raise, naming that size, before any table
    or output is made (a meta tensor allocates nothing); n_fft 1 takes the
    point kernel."""
    hop = n_fft // 2 if n_fft % 2 == 0 else n_fft
    tb = f"{4 * n_fft * (n_fft // 2 + 1) / 1e12:.1f} TB"
    with pytest.raises(ValueError, match=tb):
        dft_route(n_fft)
    x = torch.zeros(hop + n_fft, dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match=tb):
        dft_magnitude(x, np.ones(n_fft), n_fft=n_fft, hop=hop)
    assert dft_route(1) == "point"


@pytest.mark.parametrize("n_fft,hop", [(464, 232), (496, 248), (1856, 928), (1984, 992)])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_fft_mixed_reference_at_radix_29_and_31(n_fft, hop, dtype):
    """The mixed route at 464 (16, 29), 496 (16, 31), 1856 (8, 8, 29) and
    1984 (8, 8, 31), which took the chirp mode before radices 29 and 31,
    against the Pallas kernel in interpret mode and numpy's float64 rfft,
    atol 2e-4, and no farther from the float64 rfft than the plain version;
    the codes bit-equal to their int16 decode."""
    tpad = 32
    padded, as_f64 = _signal(dtype, (tpad - 1) * hop + n_fft, n_fft)
    window = port_hann_window(n_fft)
    x = torch.from_numpy(padded)
    got = _fft_mixed_reference(x, window, n_fft=n_fft, hop=hop)
    assert dft_route(n_fft) == "mixed" and got.shape == (tpad, n_fft // 2 + 1)
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, 32), atol=2e-4, rtol=0)
    want = _rfft_mag(as_f64, window, n_fft, hop)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    err_plain = np.abs(dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop).numpy() - want).max()
    assert np.abs(got.numpy() - want).max() <= err_plain
    if dtype == "uint8":
        decoded = _fft_mixed_reference(torch.from_numpy(mulaw_decode_host(padded)), window,
                                       n_fft=n_fft, hop=hop)
        assert torch.equal(got, decoded)


def test_staged_plan_splits_limits_and_tables():
    """staged_plan splits N = N1 * N2 (both {2, ..., 31}-smooth, 2 to 8192)
    with the fewest passes, then the largest batch a CTA takes (the smaller
    of G1 and 2 G2), then the shorter column side; G1 and G2 are the most,
    a power of two up to 16, whose two buffers fit in 96 KB, else 1 within
    200 KB; a split given is taken; it raises for a size or split the
    kernels do not take. The tables hold both sides' pass roots and the
    four-step twiddles' two float64 tables, in either mode; the packed plan the lengths the kernel checks; a
    chunk's scratch stays within 512 MB."""
    assert staged_plan(131072) == (256, 512, 16, 4)
    assert staged_plan(98304) == (256, 384, 16, 4)
    assert staged_plan(1 << 20)[:2] == (256, 4096) or staged_plan(1 << 20)[0] * staged_plan(
        1 << 20)[1] == 1 << 20
    assert staged_plan(STAGED_M_MAX) == (512, 4096, 8, 1)
    assert staged_plan(131072, (32, 4096)) == (32, 4096, 16, 1)
    assert staged_plan(131072, (128, 1024)) == (128, 1024, 16, 2)
    for n in (131072, 98304, 82688, 104329, 59392, 1 << 20, STAGED_M_MAX, 96, 240):
        n1, n2, g1, g2 = staged_plan(n)
        assert n1 * n2 == n and 2 <= min(n1, n2) and max(n1, n2) <= MIXED_MAX
        assert 1 <= g1 <= STAGED_BATCH and 1 <= g2 <= STAGED_BATCH
        for side, rows, g in ((n1, 1, g1), (n2, 2, g2)):
            assert _staged_bytes(side, rows * g) <= STAGED_CTA_MAX_BYTES
            assert g == 1 or _staged_bytes(side, rows * g) <= STAGED_CTA_BYTES
            assert g == STAGED_BATCH or _staged_bytes(side, rows * 2 * g) > STAGED_CTA_BYTES
        passes = len(fft_plan(n1)) + len(fft_plan(n2))
        for d in range(2, MIXED_MAX + 1):
            if n % d == 0 and 2 <= n // d <= MIXED_MAX:
                assert passes <= len(fft_plan(d)) + len(fft_plan(n // d))
    for n, split in ((3, None), (STAGED_M_MAX * 2, None), (131072 * 37, None), (37 * 4096, None),
                     (131072, (64, 1024)), (131072, (16, 8192)), (1 << 24, (4096, 4096))):
        with pytest.raises(ValueError):
            staged_plan(n, split)
    n1, n2, g1, g2 = staged_plan(131072)
    table = staged_tables(131072)
    len1, len2 = len(pass_roots(n1, fft_plan(n1))), len(pass_roots(n2, fft_plan(n2)))
    lo, hi = twiddle_tables(131072)
    tab_off = (len1 + len2 + 1) & ~1
    assert table.shape == (tab_off + 2 * (len(lo) + len(hi)), 2)
    np.testing.assert_array_equal(table[:len1], pass_roots(n1, fft_plan(n1)))
    np.testing.assert_array_equal(table[len1:len1 + len2], pass_roots(n2, fft_plan(n2)))
    np.testing.assert_array_equal(table[tab_off:].view(np.float64).reshape(-1, 2),
                                  np.concatenate([lo, hi]))
    np.testing.assert_array_equal(staged_tables(82688), cluster_tables(82688, (256, 323)))
    assert list(_staged_plan_array(131072)) == [256, 512, 16, 4, len1, len2, 2, 16, 16, 3, 8, 8, 8]
    assert staged_chunk_pairs(131072) == 512 and staged_chunk_pairs(STAGED_M_MAX) == 32
    assert staged_mode(131072) == "fft" and staged_mode(40962) == "chirp"
    assert staged_mode(37 * 4096) == "chirp" and staged_mode(59392) == "fft"


@pytest.mark.parametrize("n_fft", [46349, 1088, 17])
def test_chirp_tables_match_float64(n_fft):
    """chirp_tables' a[n] = exp(-i pi (n^2 mod 2N) / N), w a and B =
    FFT_M(b) / M are float64 values rounded once to float32, also at an N
    (46349, past the chirp mode's sizes, with a power-of-two M) where n^2
    overflows an int32 (where an int32 square would give other angles); in
    float64 the rounded tables still give the DFT."""
    window = port_hann_window(n_fft)
    m = chirp_length(n_fft) if n_fft <= CHIRP_MAX else 1 << (2 * n_fft - 1).bit_length()
    table = chirp_tables(window, m)
    assert table.dtype == np.float32 and table.shape == (2 * n_fft + m, 2)
    n = np.arange(n_fft, dtype=np.float64)  # n^2 exact in float64 below 2^53
    a64 = np.exp(-1j * np.pi * np.fmod(n * n, 2.0 * n_fft) / n_fft)
    got = table[:, 0] + 1j * table[:, 1].astype(np.complex128)
    np.testing.assert_array_equal(table[:n_fft, 0], (window * a64).real.astype(np.float32))
    np.testing.assert_array_equal(table[:n_fft, 1], (window * a64).imag.astype(np.float32))
    np.testing.assert_array_equal(table[n_fft:2 * n_fft, 0], a64.real.astype(np.float32))
    np.testing.assert_array_equal(table[n_fft:2 * n_fft, 1], a64.imag.astype(np.float32))
    if (n_fft - 1) ** 2 > np.iinfo(np.int32).max:
        with np.errstate(over="ignore"):
            k32 = np.arange(n_fft, dtype=np.int32)
            wrapped = np.exp(-1j * np.pi * ((k32 * k32) % (2 * n_fft)) / n_fft)
        assert not np.allclose(wrapped.real.astype(np.float32), table[n_fft:2 * n_fft, 0])
    b = np.zeros(m, np.complex128)
    b[:n_fft] = np.conj(a64)
    b[m - n_fft + 1:] = np.conj(a64[1:])[::-1]
    big = np.fft.fft(b) / m
    assert np.abs(got[2 * n_fft:] - big).max() <= 2.0 ** -24 * np.abs(big).max()
    if n_fft < 4096:  # the Bluestein identity with the float32 tables, in float64
        x = np.random.default_rng(0).standard_normal(n_fft)
        z = np.zeros(m, np.complex128)
        z[:n_fft] = got[:n_fft] * x
        dft = got[n_fft:2 * n_fft] * np.fft.ifft(np.fft.fft(z) * got[2 * n_fft:] * m)[:n_fft]
        want = np.fft.fft(window * x)
        assert np.abs(dft - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", [384, 416, 4096, 2178, 13, 1088, 4352, 2431, 17, 1216, 247, 1472])
def test_pass_roots_are_the_roots_each_pass_reads(n):
    """pass_roots lays the n roots of unity out as the mixed kernel's passes
    read them: for pass p > 0 of radix R after Ns points, tw[r jm n/(Ns R)]
    at tw_off[p] + (r - 1) Ns + jm."""
    plan = fft_plan(n)
    tw = roots_of_unity(n)
    table = pass_roots(n, plan)
    off, ns = 0, plan[0]
    for radix in plan[1:]:
        for r in range(1, radix):
            for jm in range(ns):
                np.testing.assert_array_equal(table[off + (r - 1) * ns + jm],
                                              tw[r * jm * (n // (ns * radix))])
        off += (radix - 1) * ns
        ns *= radix
    assert len(table) == max(off, 1)


def test_mixed_kernel_constants_are_the_reference_s():
    """The butterflies' float32 constants written in csrc/dft_butterflies.cuh
    (the odd radices' roots up to 31, radix 16's W16 twiddles), which
    csrc/dft_mixed.cu, csrc/dft_cluster.cu and csrc/dft_staged.cu include,
    are those of the reference (_odd_roots, _C16, _S16): float64 values
    rounded once."""
    for name in ("dft_mixed.cu", "dft_cluster.cu", "dft_staged.cu"):
        assert '#include "dft_butterflies.cuh"' in (_build.CSRC / name).read_text()
    import re

    src = (_build.CSRC / "dft_butterflies.cuh").read_text()  # included by both FFT kernels
    for fn, col in (("root_cos", 0), ("root_sin", 1)):
        body = src[src.index(f"float {fn}(int R, int m)"):]
        body = body[:body.index("return 0.0f;")]
        got = {(int(r), int(m)): np.float32(v) for r, m, v in re.findall(
            r"case (\d+) \* 16 \+ (\d+): return (-?[0-9.]+)f;", body)}
        want = {(r, m + 1): v for r in (3, 5, 7, 11, 13, 17, 19, 23, 29, 31)
                for m, v in enumerate(_odd_roots(r)[col])}
        assert got == want
    for name, want in (("wc", _C16), ("ws", _S16)):
        table = re.search(rf"const float {name}\[10\] = {{([^}}]*)}};", src).group(1)
        got = np.array([float(v.strip().rstrip("f")) for v in table.split(",")], np.float32)
        np.testing.assert_array_equal(got, want)


def test_exchange_pads_leave_no_bank_conflict_at_the_main_sizes():
    """The layouts the host picks for the mixed kernel's exchange buffers
    (a + ((a >> s) << g)) give each warp access its fewest shared-memory
    wavefronts at 256, 384, 768, 1024, 2048, 4096, 8192 and 4352 = 16 * 16
    * 17 and 368 = 16 * 23, within 10 % of that at 352, 704, 416, 1088 = 8 *
    8 * 17, 1216 = 8 * 8 * 19 and 1472 = 8 * 8 * 23, and never more than no
    padding."""
    for n, slack in ((256, 0), (384, 0), (768, 0), (1024, 0), (2048, 0), (4096, 0), (8192, 0),
                     (4352, 0), (368, 0), (352, 0.1), (704, 0.1), (416, 0.1), (1088, 0.1),
                     (1216, 0.1), (1472, 0.1)):
        got = ideal = bare = 0
        for accesses, pad in zip(_exchange_accesses(n, fft_plan(n)), exchange_pads(n)):
            for addr in accesses:
                got += _wavefronts(np.where(addr >= 0, _pad_address(addr, pad), -1))
                bare += _wavefronts(addr)
                ideal += int((addr.reshape(-1, 16) >= 0).any(axis=1).sum())
        assert ideal <= got <= (1 + slack) * ideal and got <= bare, (n, got, ideal, bare)


def test_b1_tools_plans_and_refusal_without_a_card():
    """tools/bench_dft_plans.py's radix-8 plans multiply back to n_fft, its
    chirp sizes are the chirp route's, its sweep holds sizes of 2^a * 23 on
    the FFT routes, of 2^a * 29 and 31 on the mixed route and in the chirp
    route's FFT mode above 8192, sizes with a prime factor above 31 on both layouts of
    the chirp mode and in the staged route's, and the staged route's FFT
    mode, and its staged splits and lengths are staged_plan's, at the chirp
    mode's sizes; it, tools/time_b1_routes.py, tools/ab_b1_sizes.py and
    tools/trace_staged.py stop without a card instead of timing the CPU."""
    from orcai_tpu_torch.tools import ab_b1_sizes, bench_dft_plans, time_b1_routes, trace_staged

    assert bench_dft_plans.radix8_plan(384) == (8, 8, 2, 3)
    assert bench_dft_plans.radix8_plan(1024) == (8, 8, 8, 2)
    for n, _ in bench_dft_plans.SIZES:
        assert int(np.prod(bench_dft_plans.radix8_plan(n))) == n
    assert bench_dft_plans.radix8_plan(352) == fft_plan(352)
    assert all(dft_route(n) == "chirp" for n, _ in bench_dft_plans.CHIRP_SIZES)
    sweep = bench_dft_plans.SWEEP_SIZES
    assert all(n % hop == 0 for n, hop in sweep)
    by23 = [n for n, _ in sweep if n % 23 == 0 and _smooth(n)]
    assert {368, 1472} <= set(by23) and {dft_route(n) for n in by23} == {"mixed", "cluster"}
    by29 = [n for n, _ in sweep if (n % 29 == 0 or n % 31 == 0) and _smooth(n)]
    assert {464, 496, 1856, 1984, 3712, 3968, 7424, 7936, 14848, 15872} == set(by29)
    assert {dft_route(n) for n in by29} == {"mixed", "staged"}
    staged = [n for n, _ in sweep if dft_route(n) == "staged"]
    assert {14848, 15872, 40962, 49154, 98304, 131072} == set(staged)
    assert {staged_mode(n) for n in staged} == {"fft", "chirp"}
    chirp = [n for n, _ in sweep if n not in by23 + staged and dft_route(n) == "chirp"]
    assert {_chirp_kernel(n) for n in chirp} == {"mixed", "cluster"}
    for n1, n2 in bench_dft_plans.STAGED_SPLITS:
        assert staged_plan(131072, (n1, n2))[:2] == (n1, n2)
    for n_fft, hop, _ in bench_dft_plans.STAGED_CHIRP_TILES:
        assert dft_route(n_fft) == "staged" and staged_mode(n_fft) == "chirp"
        assert all(m >= 2 * n_fft - 1 and staged_plan(m)
                   for m in bench_dft_plans.STAGED_LENGTHS[n_fft])
    for size in trace_staged.DEFAULT_SIZES.split(","):
        assert dft_route(int(size.split("/")[0])) == "staged"
    for tool, argv in ((bench_dft_plans, []), (time_b1_routes, []),
                       (ab_b1_sizes, ["--trees", ".", "."]), (trace_staged, [])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main(argv)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n = 300_000
    x = rng.uniform(0.0, 1.0, n).astype(np.float32)
    x[::11] = 0.125  # heavy ties across a digit boundary
    return x, n


def _padded(x):
    unit = pad_unit()
    return np.pad(x, (0, -(-x.shape[0] // unit) * unit - x.shape[0]))


def _levels(x):
    """The three (digit_shift, bits, prefix_shift, prefixes) levels of a
    selection, with prefixes that occur in the data."""
    bits = x.view(np.uint32)
    top = np.unique(bits >> 21)
    mid = np.unique(bits >> 10)
    return [
        (21, 11, None, (0, 0)),
        (10, 11, 21, (int(top[0]), int(top[-1]))),
        (0, 10, 10, (int(mid[len(mid) // 3]), int(mid[-1]))),
    ]


@pytest.mark.parametrize("level", [0, 1, 2])
def test_digit_histograms_plain_matches_pallas(data, level):
    x, n = data
    shift, bits, pshift, pref = _levels(x)[level]
    n_valid = n - 1234  # a validity bound inside the data
    got = digit_histograms(
        torch.from_numpy(x), torch.tensor([n_valid], dtype=torch.int32),
        torch.tensor(pref, dtype=torch.int32), shift, bits, pshift,
    )
    ref = jax_digit_histograms(
        jnp.asarray(_padded(x)), jnp.asarray(n_valid, jnp.int32),
        jnp.asarray(pref, jnp.uint32), shift, bits, pshift, interpret=True,
    )
    assert got.shape == (2, 1 << bits) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and against a numpy bincount of the same selection
    b = x[:n_valid].view(np.uint32)
    digit = (b >> shift) & ((1 << bits) - 1)
    for t in range(2 if pshift is not None else 1):
        sel = digit if pshift is None else digit[(b >> pshift) == pref[t]]
        np.testing.assert_array_equal(
            got[t].numpy(), np.bincount(sel, minlength=1 << bits)
        )


@pytest.mark.parametrize("q_lo,q_hi", [(0.01, 0.999), (0.0, 1.0)])
def test_select_order_statistics_bit_equal(data, q_lo, q_hi):
    x, n = data
    k_lo = int(round(q_lo * (n - 1)))
    k_hi = int(round(q_hi * (n - 1)))
    args = (
        torch.from_numpy(x), torch.tensor([n], dtype=torch.int32),
        torch.tensor([k_lo]), torch.tensor([k_hi]),
    )
    lo, hi = select_order_statistics(*args)
    lo_s, hi_s = select_order_statistics_plain(*args)
    j_lo, j_hi = jax.jit(
        lambda f, nv, kl, kh: jax_select(f, nv, kl, kh, interpret=True)
    )(
        jnp.asarray(_padded(x)), jnp.asarray(n, jnp.int32),
        jnp.asarray(k_lo, jnp.int32), jnp.asarray(k_hi, jnp.int32),
    )
    s = np.sort(x)
    for ours, sort_t, jx, want in ((lo, lo_s, j_lo, s[k_lo]), (hi, hi_s, j_hi, s[k_hi])):
        assert ours.dtype == torch.float32 and ours.shape == (1,)
        assert ours.numpy().tobytes() == sort_t.numpy().tobytes()
        assert ours.numpy()[0].tobytes() == np.float32(np.asarray(jx)).tobytes()
        assert ours.numpy()[0] == want


def test_select_validity_bound_excludes_padding(data):
    x, n = data
    padded = np.concatenate([x, np.zeros(5000, np.float32)])
    lo, hi = select_order_statistics(
        torch.from_numpy(padded), torch.tensor([n], dtype=torch.int32),
        torch.tensor([0]), torch.tensor([n - 1]),
    )
    assert float(lo) == x.min() != 0.0
    assert float(hi) == x.max()


def _pick_both(hist, k):
    b, left = _pick(torch.from_numpy(hist), torch.tensor([k]))
    jb, jleft = jax_pick(jnp.asarray(hist), jnp.asarray(k, jnp.int32))
    assert int(b) == int(jb) and int(left) == int(jleft)
    return int(b), int(left)


@settings(max_examples=60, deadline=None)
@given(
    counts=st.lists(st.integers(0, 5), min_size=1, max_size=64),
    frac=st.floats(0.0, 1.0),
)
def test_pick_matches_reference_hypothesis(counts, frac):
    """`_pick` against orcai_tpu's, exact, on small histograms with many
    empty bins and ties; the picked bin holds the k-th value."""
    hist = np.asarray(counts, np.int32)
    n = int(hist.sum())
    if n == 0:
        return
    k = min(n - 1, int(frac * n))
    b, left = _pick_both(hist, k)
    cum = np.cumsum(hist)
    assert cum[b] > k and (b == 0 or cum[b - 1] <= k) and 0 <= left < hist[b]


@pytest.mark.parametrize("case", ["k0", "k_last", "one_bin", "ties"])
def test_pick_edges_match_reference(case):
    hist = np.zeros(2048, np.int32)
    if case == "one_bin":
        hist[1234] = 1000
        assert _pick_both(hist, 0) == (1234, 0)
        assert _pick_both(hist, 999) == (1234, 999)
        return
    rng = np.random.default_rng(7)
    hist[rng.integers(0, 2048, 80)] = rng.integers(1, 10_000_000, 80)
    n = int(hist.sum())
    first, last = np.flatnonzero(hist)[[0, -1]]
    if case == "k0":
        assert _pick_both(hist, 0) == (first, 0)
    elif case == "k_last":
        assert _pick_both(hist, n - 1) == (last, hist[last] - 1)
    else:  # a rank on either side of every bin boundary
        for edge in np.cumsum(hist)[np.flatnonzero(hist)][:-1]:
            assert _pick_both(hist, int(edge) - 1)[1] >= 0
            assert _pick_both(hist, int(edge))[1] == 0


@pytest.mark.parametrize("shared_row", [True, False])
def test_radix_pick_plain_is_pick_with_shifts(shared_row):
    """radix_pick (CPU: its plain version) = `_pick` per target plus
    (prefix << bits) | digit, the form select_order_statistics chains."""
    rng = np.random.default_rng(8)
    hists = rng.integers(0, 1000, (2, 1024)).astype(np.int32)
    hists[1, :100] = 0
    ranks = np.asarray([17, int(hists[0 if shared_row else 1].sum()) - 1], np.int64)
    prefixes = np.asarray([3, 0x1FFFFF], np.int32)
    got_p, got_k = radix_pick(
        torch.from_numpy(hists), torch.from_numpy(ranks), torch.from_numpy(prefixes),
        10, shared_row,
    )
    assert got_p.dtype == torch.int32 and got_k.dtype == torch.int64
    for t in range(2):
        b, left = _pick_both(hists[0 if shared_row else t], int(ranks[t]))
        want = ((int(prefixes[t]) << 10) | b) & 0xFFFFFFFF
        assert int(got_p[t]) & 0xFFFFFFFF == want and int(got_k[t]) == left
    # an empty target: every bin's cumulative count is <= k
    empty = torch.zeros((2, 1024), dtype=torch.int32)
    p, k = radix_pick_plain(empty, torch.tensor([5, 0]), torch.zeros(2, dtype=torch.int32), 10, False)
    assert p.tolist() == [1024, 1024] and k.tolist() == [5, 0]


@pytest.mark.parametrize("offset,n_valid", [(1, 9997), (3, 1001), (2, 2), (1, 0)])
def test_digit_histograms_offset_view_and_ragged_count(data, offset, n_valid):
    """A view that starts inside a buffer (4-byte aligned only) with a valid
    count that is no multiple of 4: the wrapper takes it as it is."""
    x, _ = data
    flat = torch.from_numpy(x[:20000])[offset:]
    assert flat.data_ptr() % 16 != 0 or offset == 0
    got = digit_histograms(
        flat, torch.tensor([n_valid], dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), 21, 11, None,
    )
    b = x[offset : offset + n_valid].view(np.uint32)
    np.testing.assert_array_equal(got[0].numpy(), np.bincount(b >> 21, minlength=2048))
    assert int(got[1].sum()) == 0


def test_digit_histograms_rejects_strided_off_cpu():
    nv = torch.tensor([4], dtype=torch.int32, device="meta")
    p = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        digit_histograms(torch.zeros(16, device="meta")[::2], nv, p, 21, 11, None)
    with pytest.raises(ValueError, match="unsupported device"):
        select_order_statistics(torch.zeros(16, device="meta"), nv, p[:1].long(), p[:1].long())
    with pytest.raises(ValueError, match="unsupported device"):
        radix_pick(torch.zeros((2, 2048), dtype=torch.int32, device="meta"),
                   p.long(), p, 11, True)


def test_digit_histograms_wrapper_validates():
    x = torch.zeros(10)
    nv = torch.tensor([10], dtype=torch.int32)
    p = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="digit_bits"):
        digit_histograms(x, nv, p, 0, 12, None)
    with pytest.raises(ValueError, match="unsupported device"):
        digit_histograms(x.to("meta"), nv, p, 21, 11, None)
