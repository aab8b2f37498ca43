"""csrc/dft_mixed.cu's compiled layouts on the CPU: the plans it compiles
whole (the warp layout's and the block layout's) against the host's plans,
the spectral wires' sizes and the powers of two above the warp layout's
reach, the exchange layouts it derives at compile time (csrc/dft_pads.cuh,
built with g++) or holds against the host's, the pruned radix-16 butterfly
of the chirp mode's first pass (g++), the builds they go into, the window
that carries the samples' scale, the probe tool's copies of the source,
and the mixed
route's arithmetic (ops/dft.py::_fft_mixed_reference, which the compiled
and warp layouts run pass for pass) against the Pallas kernel in
interpret mode and numpy's float64 rFFT, atol 2e-4."""
import json
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from orcai_tpu.ops.frontend import _dft_mats as jax_dft_mats
from orcai_tpu.ops.pallas_dft import dft_magnitude as jax_dft_magnitude
from orcai_tpu.ops.wire_codec import mulaw_decode_host, mulaw_encode
from orcai_tpu_torch.ops import _build
from orcai_tpu_torch.ops.dft import (
    MIXED_BLOCK_COMPILED,
    MIXED_MAX,
    _build_variant,
    _fft_mixed_reference,
    block_compiled,
    chirp_length,
    dft_magnitude_plain,
    dft_route,
    exchange_pads,
    fft_plan,
    mixed_layout,
    pass_roots,
)
from orcai_tpu_torch.ops.frontend import hann_window
from orcai_tpu_torch.ops.spectral import spectral_geometry

SOURCE = (_build.CSRC / "dft_mixed.cu").read_text()


def setup_module():
    torch.set_num_threads(1)


def _compiled(source: str = SOURCE) -> list[tuple[int, ...]]:
    """csrc/dft_mixed.cu's COMPILED table: the radices of each plan."""
    body = source[source.index("constexpr Compiled COMPILED[] = {"):]
    body = body[:body.index("};")]
    return [tuple(int(v) for v in radix.split(","))[:int(n_passes)]
            for n_passes, radix in re.findall(r"\{(\d), \{([\d, ]+)\}\}", body)]


def _spectral_wire_sizes() -> set[int]:
    """The n_fft the spectral wires (ops/spectral.py: L/M 3/4, sp-bfp5 and
    sp-bfp6; 11/16, sp11-bfp5) run at the default parameters' spectrogram."""
    spec = json.loads((_build.CSRC.parent / "defaults" / "default_orcai_parameter.json")
                      .read_text())["spectrogram"]
    return {spectral_geometry(spec["sampling_rate"], spec["nfft"], spec["n_overlap"],
                              spec["freq_range"], L, M)[1] for L, M in ((3, 4), (11, 16))}


def test_compiled_plans_are_the_hosts():
    """Every plan the kernel compiles whole is fft_plan's for its size, on
    the mixed route, once each: the plans of the spectral wires' n_fft at
    the default parameters (384 and 352), the sizes of this route that a
    configuration of the repo runs."""
    plans = _compiled()
    sizes = [int(np.prod(radices)) for radices in plans]
    assert len(sizes) == len(set(sizes))
    assert set(sizes) == _spectral_wire_sizes() == {384, 352}
    for n, radices in zip(sizes, plans):
        assert fft_plan(n) == radices, n
        assert dft_route(n) == "mixed", n


def _block_compiled(source: str = SOURCE) -> list[dict]:
    """csrc/dft_mixed.cu's BLOCK_COMPILED table: each row's radices, pads,
    mode, threads a group and groups a block."""
    body = source[source.index("constexpr BlockCompiled BLOCK_COMPILED[] = {"):]
    body = body[:body.index("};")]
    rows = []
    for n_passes, radix, pad_s, pad_g, chirp, threads, groups in re.findall(
            r"\{(\d), \{([\d, ]+)\}, \{([\d, ]+)\}, \{([\d, ]+)\}, ([01]), (\d+), (\d+)\}",
            body):
        p = int(n_passes)
        radices, s, g = (tuple(int(v) for v in x.split(","))[:p] for x in (radix, pad_s, pad_g))
        rows.append({"radix": radices, "pads": tuple(zip(s, g)), "chirp": chirp == "1",
                     "threads": int(threads), "groups": int(groups)})
    return rows


def test_block_compiled_plans_are_the_hosts():
    """The block layout's plans compiled whole are fft_plan's of every power
    of two above the warp layout's reach up to MIXED_MAX (4096 and 8192),
    a row for each mode, each with exchange_pads' layouts and the host's
    threads and groups (MIXED_BLOCK_COMPILED); both modes reach them (4096
    and 8192 on the mixed route; 2038 and 4078 = 2 * 2039 in the chirp
    mode, on M = 4096 and 8192), and block_compiled names exactly those
    n_fft. Each pass's butterflies fill a group's threads evenly, and a
    block's roots, buffers and, in the chirp mode, B fit in the card's 227
    KB."""
    rows = _block_compiled()
    keys = [(int(np.prod(row["radix"])), row["chirp"]) for row in rows]
    assert keys == [(n, chirp) for n in (1 << 12, 1 << 13) for chirp in (False, True)]
    assert 1 << 13 == MIXED_MAX and set(keys) == set(MIXED_BLOCK_COMPILED)
    for (n, chirp), row in zip(keys, rows):
        assert row["radix"] == fft_plan(n) and dft_route(n) == "mixed", n
        assert row["pads"] == exchange_pads(n), n
        assert (row["threads"], row["groups"]) == MIXED_BLOCK_COMPILED[(n, chirp)]
        assert row["radix"][0] == 16 and row["threads"] % 32 == 0 and row["groups"] <= 15
        assert all(n // r % row["threads"] == 0 for r in row["radix"]), n
        zbuf = max(n - 1 + (((n - 1) >> s) << g if s else 0) + 1 for s, g in row["pads"])
        roots = len(pass_roots(n, row["radix"])) * 8
        assert roots + row["groups"] * zbuf * 8 + (8 * n if chirp else 0) <= 232448, n
    assert chirp_length(2038) == 4096 and chirp_length(4078) == 8192
    for n_fft, key in ((4096, (4096, False)), (8192, (8192, False)), (2038, (4096, True)),
                       (4078, (8192, True))):
        assert block_compiled(n_fft) == MIXED_BLOCK_COMPILED[key]
    reach = [n for n in range(2, MIXED_MAX + 1) if block_compiled(n)]
    assert all(chirp_length(n) in (4096, 8192) if dft_route(n) == "chirp" else n in (4096, 8192)
               for n in reach)
    assert {4096, 8192, 2038, 4078} <= set(reach) and not {2048, 4352, 470} & set(reach)


BUTTERFLIES_MAIN = r"""
#include <cstdint>
#include <cstdio>
#include <utility>
#define __device__
#define __forceinline__ inline
namespace {
#include "dft_butterflies.cuh"
}
int main() {  // seeded inputs whose upper half is zero: dft16_half against dft
  unsigned s = 1;
  long differ = 0;
  for (int trial = 0; trial < 20000; ++trial) {
    float re[16], im[16], hr[16], hi[16];
    for (int i = 0; i < 16; ++i) {
      s = s * 1664525u + 1013904223u;
      re[i] = hr[i] = i < 8 ? static_cast<int>(s >> 8) / 8388608.0f - 1.0f : 0.0f;
      s = s * 1664525u + 1013904223u;
      im[i] = hi[i] = i < 8 ? static_cast<int>(s >> 8) / 8388608.0f - 1.0f : 0.0f;
    }
    dft(re, im);
    dft16_half(hr, hi);
    for (int i = 0; i < 16; ++i) differ += !(re[i] == hr[i] && im[i] == hi[i]);
  }
  std::printf("%ld\n", differ);
}
"""


def test_half_radix16_is_the_full_one_on_a_zero_upper_half(tmp_path):
    """The chirp mode's compiled first pass leaves out the sums of its zero
    inputs (dft_butterflies.cuh::dft16_half): on 20000 seeded inputs whose
    entries 8..15 are zero it gives the full radix-16 DFT's values (built
    with g++), so _chirp_reference, which sums the zeros, stays its
    arithmetic."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler, "no C++ compiler"
    (tmp_path / "half.cpp").write_text(BUTTERFLIES_MAIN)
    subprocess.run([compiler, "-std=c++17", "-O1", f"-I{_build.CSRC}", "-o",
                    str(tmp_path / "half"), str(tmp_path / "half.cpp")], check=True)
    out = subprocess.run([str(tmp_path / "half")], capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["0"]


PADS_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include "dft_pads.cuh"
int main(int argc, char** argv) {  // each argument a plan's radices, "16,8,3"
  for (int a = 1; a < argc; ++a) {
    int radix[PLAN_PASSES], n = 0;
    for (char* p = argv[a]; *p;) {
      radix[n++] = static_cast<int>(std::strtol(p, &p, 10));
      if (*p == ',') ++p;
    }
    const Pads pads = exchange_pads(radix, n);
    for (int p = 0; p < n; ++p)
      std::printf("%d %d%s", pads.s[p], pads.g[p], p + 1 < n ? " " : "\n");
  }
  constexpr int wire[3] = {16, 8, 3};  // evaluated at compile time, as nvcc does
  static_assert(exchange_pads(wire, 3).s[0] == 4, "");
}
"""


def test_compiled_pads_are_exchange_pads(tmp_path):
    """csrc/dft_pads.cuh, from which the compiled layout takes its exchange
    layouts at compile time, gives ops/dft.py::exchange_pads' layouts for
    every pass: at the compiled plans, 512 and a spread of the mixed
    route's plans of one to five passes up to 2048 points (built with g++,
    which the C++17 of the header needs alone)."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler, "no C++ compiler"
    (tmp_path / "pads.cpp").write_text(PADS_MAIN)
    subprocess.run([compiler, "-std=c++17", "-O1", f"-I{_build.CSRC}", "-o",
                    str(tmp_path / "pads"), str(tmp_path / "pads.cpp")], check=True)
    mixed = [n for n in range(2, 2049) if dft_route(n) == "mixed"]
    sizes = sorted({int(np.prod(r)) for r in _compiled()} | {512} | set(mixed[::11]))
    assert len(sizes) > 60 and max(len(fft_plan(n)) for n in sizes) >= 5
    lines = subprocess.run([str(tmp_path / "pads"), *(",".join(map(str, fft_plan(n)))
                                                      for n in sizes)],
                           capture_output=True, text=True, check=True).stdout.splitlines()
    for n, line in zip(sizes, lines, strict=True):
        values = [int(v) for v in line.split()]
        assert tuple(zip(values[::2], values[1::2])) == exchange_pads(n), n


def test_compiled_plans_go_into_the_builds_that_run_them():
    """The kernel's build_of (which build compiles a plan in) is
    ops/dft.py::_build_variant's rule over ops/_build.py's builds: the least
    odd radix built at or above the plan's largest."""
    chain = re.search(r"constexpr int build_of\(int odd\) \{\s*return ([^;]*);", SOURCE).group(1)
    thresholds = [int(v) for v in re.findall(r"odd <= (\d+)", chain)]
    builds = sorted({odd for odd, _ in _build.VARIANTS["dft_mixed"]})
    assert thresholds == builds[:-1] and chain.endswith(f": {builds[-1]}")
    for radices in _compiled() + [row["radix"] for row in _block_compiled()]:
        odd = max(r for r in (1, *radices) if r % 2)
        want = next(b for b in builds if b >= odd)
        for dtype in (torch.float32, torch.int16, torch.uint8):
            assert _build_variant("mixed", int(np.prod(radices)), dtype)[0] == want
    assert "if (build_of(1) != ORCAI_ODD) return -1;" in SOURCE


@pytest.mark.parametrize("n_fft", [384, 352, 1216])
def test_window_carries_the_sample_scale_bit_for_bit(n_fft):
    """The compiled layout multiplies the unscaled sample by the window
    times its scale; the reference multiplies the scaled sample by the
    window. For every int16 value (scale 1/32768) and every mu-law code's
    14-bit magnitude (scale 4/32768: its int16 decode is 4 m14) both
    scalings are exact, so the products are the same float32 at every
    window value."""
    w = hann_window(n_fft).astype(np.float32)[None, :]
    x = np.arange(-32768, 32768, dtype=np.int16).astype(np.float32)[:, None]
    scale = np.float32(1.0 / 32768.0)
    np.testing.assert_array_equal((w * scale) * x, w * (x * scale))
    codes = np.arange(256, dtype=np.uint8)
    m14 = (mulaw_decode_host(codes).astype(np.int32) // 4).astype(np.float32)[:, None]
    np.testing.assert_array_equal(mulaw_decode_host(codes), 4 * m14[:, 0])
    np.testing.assert_array_equal((w * np.float32(4.0 / 32768.0)) * m14,
                                  w * ((np.float32(4.0) * m14) * scale))


def test_int_to_f32_is_exact():
    """The kernels' int_to_f32: the bits of 1.5 * 2^23 plus an integer v,
    less 1.5 * 2^23, is v exactly for every |v| below 2^22 (every int16
    value and mu-law magnitude), as float32 arithmetic."""
    v = np.arange(-(1 << 22) + 1, 1 << 22, dtype=np.int32)
    bits = (np.int32(0x4B400000) + v).view(np.float32)
    np.testing.assert_array_equal(bits - np.float32(12582912.0), v.astype(np.float32))
    assert "return __int_as_float(0x4B400000 + v) - 12582912.0f;" in SOURCE


def test_mulaw_code_bits_give_its_magnitude():
    """The compiled layout's mu-law decode: 33.0f's bits plus the code's low
    7 bits shifted left by 19 are (2 mant + 33) 2^e as a float; less 33,
    both with the code's sign bit, that is the code's int16 decode / 4, for
    every one of the 256 codes (+0 for both zero codes), as float32
    arithmetic."""
    c = np.arange(256, dtype=np.uint32)
    sign = (c & 0x80) << 24
    a = ((np.uint32(0x42040000) + ((c & 0x7F) << 19)) | sign).view(np.float32)
    b = (np.uint32(0x42040000) | sign).view(np.float32)
    got = a - b
    want = (mulaw_decode_host(c.astype(np.uint8)).astype(np.int32) // 4).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert not np.signbit(got).any() or (got[np.signbit(got)] != 0).all()
    assert "(0x42040000u + ((c & 0x7Fu) << 19)) | sign" in SOURCE


def _pallas(padded, n_fft, hop, tile_frames):
    return np.asarray(jax_dft_magnitude(
        jnp.asarray(padded), *map(jnp.asarray, jax_dft_mats(n_fft)),
        n_fft=n_fft, hop=hop, tile_frames=tile_frames, interpret=True,
    ))


@pytest.mark.parametrize("n_fft,hop", [(1088, 544), (1216, 608)])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_mixed_reference_at_compiled_sizes(n_fft, hop, dtype):
    """Radix 17 (1088) and 19 (1216), sizes of the warp layout that
    tests/test_torch_kernels_plain.py holds to the Pallas kernel alone, on 32
    seeded frames: the mixed route's arithmetic against the Pallas kernel in
    interpret mode and numpy's float64 rFFT, atol 2e-4, no farther from the
    latter than the plain version; the codes bit-equal to their int16
    decode. (384/192 and 352/176 are held so in test_torch_kernels_plain.py's
    test_fft_mixed_reference_matches_pallas_and_float64, 1856/928 in
    test_fft_mixed_reference_at_radix_29_and_31.)"""
    tpad = 32
    rng = np.random.default_rng(n_fft + 17)
    n = (tpad - 1) * hop + n_fft
    pcm = rng.integers(-32768, 32768, n, dtype=np.int16)
    padded = {"f32": (0.3 * rng.standard_normal(n)).astype(np.float32), "int16": pcm,
              "uint8": mulaw_encode(pcm)}[dtype]
    as_f64 = {"f32": padded.astype(np.float64), "int16": pcm / 32768.0,
              "uint8": mulaw_decode_host(padded) / 32768.0}[dtype]
    window = hann_window(n_fft)
    x = torch.from_numpy(padded)
    got = _fft_mixed_reference(x, window, n_fft=n_fft, hop=hop)
    assert got.shape == (tpad, n_fft // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(padded, n_fft, hop, 32), atol=2e-4, rtol=0)
    frames = np.lib.stride_tricks.sliding_window_view(as_f64, n_fft)[::hop] * window
    want = np.abs(np.fft.rfft(frames, axis=1))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    err_plain = np.abs(dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop).numpy() - want).max()
    assert np.abs(got.numpy() - want).max() <= err_plain
    if dtype == "uint8":
        decoded = _fft_mixed_reference(torch.from_numpy(mulaw_decode_host(padded)), window,
                                       n_fft=n_fft, hop=hop)
        assert torch.equal(got, decoded)


@pytest.mark.parametrize("n_fft", [1, 16384, 40962])
def test_mixed_layout_takes_only_the_kernels_sizes(n_fft):
    """mixed_layout reports csrc/dft_mixed.cu's launch: another route's size
    raises before any build is loaded."""
    with pytest.raises(ValueError, match="does not take csrc/dft_mixed.cu"):
        mixed_layout(n_fft, n_fft // 2)


def test_b1_tools_cover_the_mixed_route_and_stop_without_a_card():
    """tools/ab_b1_sizes.py's default sizes hold every compiled plan's size
    beside the warp layout's (480/240 a plan of four passes, 1024, 1216,
    1856) and the block layout's, and it (for every sample type) and
    tools/probe_mixed.py stop without a card instead of timing the CPU."""
    from orcai_tpu_torch.tools import ab_b1_sizes, probe_mixed

    sizes = set(ab_b1_sizes.DEFAULT_SIZES.split(","))
    assert {"384/192", "352/176", "480/240", "1024/256", "1216/608", "1856/928", "4096/2048",
            "8192/4096"} <= sizes
    compiled = {int(np.prod(radices)) for radices in _compiled()}
    mixed = {int(v.split("/")[0]) for v in sizes if dft_route(int(v.split("/")[0])) == "mixed"}
    assert compiled <= mixed and len(mixed - compiled - {4096, 8192, 4352}) >= 10
    for tool, argv in ((ab_b1_sizes, ["--trees", ".", ".", "--dtype", "uint8"]),
                       (probe_mixed, [])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main(argv)


@pytest.mark.parametrize("probe", [0, 1, 2, 3, 4])
def test_probe_copies_edit_the_source_once(probe):
    """tools/probe_mixed.py builds its own copies of csrc/dft_mixed.cu: each
    probe's edits (none; no passes; no row stores; no table loads; no
    second FFT) find their text once in each layout they reach (the
    compiled, the warp and block layouts' shared code, the compiled block
    layout; the chirp mode's tables and second FFT on both block kernels),
    --compile adds a plan to the copy's table and nothing else, and the
    shipped source keeps no probe."""
    from orcai_tpu_torch.tools.probe_mixed import EDITS, PROBES, probe_source

    copy = probe_source(probe, (512,))
    assert _compiled(copy) == [(8, 8, 8), *_compiled()]
    assert len(EDITS.get(probe, ())) == {0: 0, 1: 3, 2: 2, 3: 8, 4: 2}[probe]
    assert set(PROBES) == {0, 1, 2, 3, 4}
    for old, new in EDITS.get(probe, ()):
        assert SOURCE.count(old) == 1 and new in copy and copy.count(old) == new.count(old)
    if probe == 0:
        assert copy.replace("    {3, {8, 8, 8}},  // 512, probe_mixed\n", "") == SOURCE
        shaped = probe_source(0, (), {(8192, True): (256, 1)})  # --block-shapes 8192c:256:1
        assert [row["threads"] for row in _block_compiled(shaped)] == [256, 256, 512, 256]
        assert shaped.replace("{0, 0, 0, 0}, 1, 256, 1}", "{0, 0, 0, 0}, 1, 512, 1}") == SOURCE
    assert "PROBE" not in SOURCE
