"""csrc/dft_staged.cu's FFT mode on the CPU: which sides run a kernel
compiled whole, the product twiddles its kernel 1 forms, its plan header
(csrc/dft_staged_plan.cuh) built with g++ and checked over the mode's
reach, and the tools that take it apart and time it on the card.

The arithmetic itself (ops/dft.py::_staged_reference, now with the product
twiddles) is held against the Pallas kernel in interpret mode and numpy's
float64 rfft by tests/test_torch_kernels_plain.py.
"""

import json
import re
import shutil
import subprocess
from functools import lru_cache

import numpy as np
import pytest
import torch

from orcai_tpu_torch.ops import _build
from orcai_tpu_torch.ops.dft import (
    MIXED_MAX,
    MIXED_PRIMES,
    STAGED_EXTRA_ROWS,
    STAGED_KERNELS,
    STAGED_MAX,
    _staged_plan_array,
    _staged_split,
    chirp_length,
    cluster_tables,
    dft_route,
    fft_plan,
    four_step_roots,
    pass_roots,
    product_twiddles,
    staged_layout,
    staged_mode,
    staged_plan,
    staged_sides_compiled,
    staged_tables,
    twiddle_split,
    twiddle_tables,
)


@lru_cache(maxsize=None)
def _fft_mode_sizes() -> tuple[int, ...]:
    """Every n_fft of the staged route's FFT mode, MIXED_MAX + 1 to
    STAGED_MAX: the MIXED_PRIMES-smooth sizes no other route takes whose
    split fits (staged_mode "fft")."""
    smooth = {1}
    for p in MIXED_PRIMES:
        more = set()
        for v in smooth:
            while v <= STAGED_MAX:
                more.add(v)
                v *= p
        smooth = more
    return tuple(n for n in sorted(smooth)
                 if n > MIXED_MAX and dft_route(n) == "staged" and _staged_split(n) is not None)


def _compiled_sides(kind: str) -> set[tuple[int, tuple[int, ...]]]:
    """(G, radices) of each side csrc/dft_staged.cu compiles whole: its
    Columns (kind "Column") or Rows ("Row") table."""
    source = (_build.CSRC / "dft_staged.cu").read_text()
    table = re.search(rf"using {kind}s = Sides<(.*?)>;\n", source, re.S).group(1)
    return {(int(g), tuple(int(r) for r in radices.split(", ")))
            for g, radices in re.findall(rf"{kind}<(\d+), ([\d, ]+)>", table)}


def test_compiled_staged_sides_are_every_side_whose_radices_are_powers_of_two():
    """The sides csrc/dft_staged.cu compiles whole (Columns, Rows: each a
    side's radices with its batch G1 or G2) are, over the FFT mode's whole
    reach (every n_fft from 8193 to 2^20 on it), exactly the sides of
    staged_plan's splits whose radices are all powers of two in two passes
    or more (a one-pass side, the columns of 16 points of 10672 = 16 x 667,
    stays generic), and the rows of STAGED_EXTRA_ROWS (98304's 384 = 16 x 8
    x 3, which the card singled out), the rule of staged_sides_compiled and
    of dft_staged_plan.cuh's powers_of_two and extra_row; so 131072 = 256 x
    512 and 98304 = 256 x 384 run both of their kernels compiled, and the
    extra row side serves no size but 98304."""
    sizes = _fft_mode_sizes()
    assert len(sizes) == 14210 and {98304, 131072, 14848, STAGED_MAX} <= set(sizes)
    assert STAGED_EXTRA_ROWS == (((16, 8, 3), 4),)
    assert staged_plan(10672)[0] == 16 and staged_sides_compiled(10672) == (False, False)
    columns, rows, both, extra = set(), set(), [], []
    for n in sizes:
        n1, n2, g1, g2 = staged_plan(n)
        fixed = staged_sides_compiled(n)
        pow2 = [len(fft_plan(side)) >= 2 and all(r & (r - 1) == 0 for r in fft_plan(side))
                for side in (n1, n2)]
        assert fixed == (pow2[0], pow2[1] or (fft_plan(n2), g2) in STAGED_EXTRA_ROWS)
        for side, g, compiled, found in ((n1, g1, fixed[0], columns), (n2, g2, fixed[1], rows)):
            if compiled:
                found.add((g, fft_plan(side)))
        if all(fixed):
            both.append(n)
        if fixed[1] and not pow2[1]:
            extra.append(n)
    assert _compiled_sides("Column") == columns
    assert _compiled_sides("Row") == rows
    assert both == [98304, 131072, 262144, 524288, 1 << 20] and extra == [98304]


@pytest.mark.parametrize("n,differ", [(131072, 0), (98304, 0), (14848, 0), (262144, 0),
                                      (524288, 0), (1 << 20, 0), (82944, 11)])
def test_staged_product_twiddles_against_four_step_roots(n, differ):
    """The FFT mode's twiddles, W_N^(k1 j) as products of two float64
    tables (product_twiddles, formed by kernel 1 in shared memory), against
    the float64 roots rounded once (four_step_roots, the table the kernel
    read before): bit-equal at every twiddle of the route's sizes, 131072
    and 98304 among them, and of the powers of two; at 82944 = 256 x 324,
    11 of 82944 differ, by a unit of the last place of values near zero.
    The tables kernel 1 copies are the cluster route's layout of the
    split's pass roots and twiddle_tables(n)."""
    assert staged_mode(n) == "fft"
    n1, n2, _, _ = staged_plan(n)
    got = product_twiddles(n, np.arange(n1)[:, None] * np.arange(n2)[None, :])
    want = four_step_roots(n1, n2).reshape(n1, n2, 2)
    assert int((got != want).sum()) == differ
    assert np.abs(got - want).max() <= 2.0 ** -24
    table = staged_tables(n, product=True)
    np.testing.assert_array_equal(table, cluster_tables(n, (n1, n2)))
    len1, len2 = len(pass_roots(n1, fft_plan(n1))), len(pass_roots(n2, fft_plan(n2)))
    tab_off = (len1 + len2 + 1) & ~1
    lo, hi = twiddle_tables(n)
    np.testing.assert_array_equal(table[tab_off:].view(np.float64).reshape(-1, 2),
                                  np.concatenate([lo, hi]))
    assert len(lo) == 1 << twiddle_split(n) and len(lo) * len(hi) >= n


# csrc/dft_staged_plan.cuh on the host: each line of standard input
# "n_fft chirp packed plan...", one JSON line each of the plan make_plan
# builds
STAGED_PLAN_MAIN = r"""
#include <cstdio>
#define __host__
#define __device__
#define __forceinline__ inline
#include "dft_staged_plan.cuh"

int main() {
  int n_fft, chirp, count;
  while (std::scanf("%d %d %d", &n_fft, &chirp, &count) == 3) {
    int packed[64];
    for (int i = 0; i < count; ++i) std::scanf("%d", &packed[i]);
    Plan p{};
    const int err = make_plan(packed, n_fft, chirp != 0, &p);
    std::printf("{\"err\": %d, \"col_threads\": %d, \"row_threads\": %d, \"col_bytes\": %d, "
                "\"row_bytes\": %d, \"col_fixed\": %d, \"row_fixed\": %d, \"tw_log2\": %d, "
                "\"tab_off\": %d, \"tab_bytes\": %d, \"col_groups\": %d, \"row_groups\": %d}\n",
                err, p.col_threads, p.row_threads, p.col_bytes, p.row_bytes, p.col_fixed,
                p.row_fixed, p.tw_log2, p.tab_off, p.tab_bytes, p.col_groups, p.row_groups);
  }
}
"""


@pytest.fixture(scope="module")
def staged_plan_header(tmp_path_factory):
    """A host build of csrc/dft_staged_plan.cuh (STAGED_PLAN_MAIN) with g++,
    and a function that runs it: [(n_fft, chirp, packed plan)] -> one dict
    each."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler, "no C++ compiler"
    out = tmp_path_factory.mktemp("staged_plan")
    (out / "plan.cpp").write_text(STAGED_PLAN_MAIN)
    subprocess.run([compiler, "-std=c++17", "-O1", f"-I{_build.CSRC}", "-o", str(out / "plan"),
                    str(out / "plan.cpp")], check=True)

    def run(cases):
        text = "".join(f"{n} {c} {len(packed)} {' '.join(map(str, packed))}\n"
                       for n, c, packed in cases)
        lines = subprocess.run([str(out / "plan")], input=text, capture_output=True, text=True,
                               check=True).stdout.splitlines()
        return [json.loads(line) for line in lines]
    return run


def test_staged_plan_header_is_the_host_mirror_over_the_reach(staged_plan_header):
    """make_plan (dft_staged_plan.cuh, as the kernels' host code and the
    Fixed sides build it) takes every plan of the FFT mode's reach and the
    chirp mode's lengths at 40962, 49154 and the top of its reach. Each
    kernel gets whole warps, from 64 to 256 threads and enough for its pass
    of the largest radix; a side compiled whole exactly where
    staged_sides_compiled says (never in the chirp mode); two buffers of its
    batch at an odd stride, or one where compiled (its passes in place) with
    kernel 1's twiddle tables before it (float2 row tab_off of
    staged_tables; the generic kernel reads them there); every CTA within
    the card's 227 KB."""
    cases = [(n, 0, list(_staged_plan_array(n))) for n in _fft_mode_sizes()]
    chirp = {n: chirp_length(n) for n in (40962, 49154, 524290, (1 << 20) - 2)}
    cases += [(n, 1, list(_staged_plan_array(m, None, n))) for n, m in chirp.items()]
    for (n, c, packed), got in zip(cases, staged_plan_header(cases), strict=True):
        m = chirp[n] if c else n
        n1, n2, g1, g2 = staged_plan(m)
        assert got["err"] == 0, (n, got)
        fixed = (False, False) if c else staged_sides_compiled(n)
        assert (got["col_fixed"], got["row_fixed"]) == fixed, (n, got)
        for side, batch, threads in ((n1, g1, got["col_threads"]),
                                     (n2, 2 * g2, got["row_threads"])):
            assert threads % 32 == 0 and 64 <= threads <= 256, (n, got)
            assert threads >= min(256, batch * side // max(fft_plan(side))), (n, got)
        tables = got["tab_bytes"]
        assert got["col_bytes"] == (tables + n1 * (g1 | 1) * 8 if fixed[0]
                                    else 2 * n1 * (g1 | 1) * 8), (n, got)
        assert got["row_bytes"] == (1 if fixed[1] else 2) * n2 * ((2 * g2) | 1) * 8, (n, got)
        assert max(got["col_bytes"], got["row_bytes"]) <= 232448, (n, got)
        assert (got["col_groups"], got["row_groups"]) == (-(-n2 // g1), -(-(n1 // 2 + 1) // g2))
        if c:
            assert (got["tw_log2"], got["tab_off"], tables) == (0, 0, 0), (n, got)
        else:
            len12 = len(pass_roots(n1, fft_plan(n1))) + len(pass_roots(n2, fft_plan(n2)))
            s = 1 << twiddle_split(n)
            assert (got["tw_log2"], got["tab_off"], tables) == (
                twiddle_split(n), (len12 + 1) & ~1, (s + -(-n // s)) * 16), n
    a, b = staged_plan_header([(n, 0, list(_staged_plan_array(n))) for n in (131072, 98304)])
    assert (a["col_bytes"], a["row_bytes"], a["col_fixed"], a["row_fixed"]) == (47104, 36864, 1, 1)
    assert (b["col_fixed"], b["row_fixed"], b["row_bytes"]) == (1, 1, 27648)


@pytest.mark.parametrize("probe", ["kernel", "no_passes", "no_twiddles", "no_sample_loads",
                                   "no_scratch_stores", "no_row_loads", "no_magnitude_stores"])
def test_probe_staged_copies_edit_the_source(probe):
    """tools/probe_staged.py builds its own copies of csrc/dft_staged.cu and
    the headers it edits: each probe's edits find their text as often as
    they expect in the shipped source, the copy holds each replacement and
    nothing is left of what it replaced, the kernel probe is the source
    itself, and the shipped source keeps no probe."""
    from orcai_tpu_torch.tools.probe_staged import EDITS, PROBES, probe_sources

    assert probe in PROBES
    files = probe_sources(probe)
    shipped = {name: (_build.CSRC / name).read_text() for name in files}
    if probe == "kernel":
        assert files == shipped
    for name, edits in EDITS.get(probe, {}).items():
        for old, new, count in edits:
            assert shipped[name].count(old) == count and new in files[name]
            assert old not in files[name] or old in new
    assert "probe" not in shipped["dft_staged.cu"].lower().replace("probe_staged", "")


def test_b1_tools_cover_the_staged_route_and_stop_without_a_card():
    """tools/ab_b1_sizes.py's default sizes hold the staged route's: the FFT
    mode at 131072 and 98304 on 2048 frames and at 14848 (2^9 * 29) on 301,
    and on 301 frames one size of each column side compiled whole that no
    other size there runs (17856, 33408, 270336; so every compiled column
    side is timed) and 10672 (one-pass columns, generic), the chirp mode at
    40962 and 49154 on 301;
    tools/probe_staged.py's
    default sizes are the FFT mode's; it, and staged_layout's refusal of
    another route's size, stop without a card."""
    from orcai_tpu_torch.tools import ab_b1_sizes, probe_staged

    sizes = set(ab_b1_sizes.DEFAULT_SIZES.split(","))
    staged = {"14848/7424/301", "40962/20481/301", "49154/24577/301", "98304/49152/2048",
              "131072/65536/2048", "10672/5336/301", "17856/8928/301", "33408/16704/301",
              "270336/135168/301"}
    assert staged <= sizes
    fft_mode = [int(s.split("/")[0]) for s in sizes]
    fft_mode = [n for n in fft_mode if dft_route(n) == "staged" and staged_mode(n) == "fft"]
    columns = {(staged_plan(n)[2], fft_plan(staged_plan(n)[0])) for n in fft_mode
               if staged_sides_compiled(n)[0]}
    assert columns == _compiled_sides("Column")
    assert {staged_mode(int(s.split("/")[0])) for s in staged} == {"fft", "chirp"}
    assert all(staged_mode(int(s.split("/")[0])) == "fft"
               for s in probe_staged.DEFAULT_SIZES.split(","))
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe_staged.main([])
    with pytest.raises(ValueError, match="does not take the staged route"):
        staged_layout(16384, torch.int16)
    assert STAGED_KERNELS == {"fft": ("columns", "rows"),
                              "chirp": ("columns", "rows", "columns_untangle")}
