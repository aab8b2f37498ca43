"""The selection's levels and its picks on the card's forms, on the CPU.

ops/radix_select.py::select_levels (on CUDA one launch: each level a B2
sweep with the pick as its tail) runs its plain version here: each level a
sweep (digit_histograms_plain) followed by its pick (radix_pick_plain).
It is held bit-equal, level by level, to the JAX package's Pallas
digit_histograms in interpret mode followed by its `_pick`. The pick on
int64 counts (the streaming path's, on the card since the three streamed
levels chain on the stream) is held to ops/streaming.py::pick_int64 and to
the JAX package's host pick, past 2^31. The streamed pass 1 is checked to
pick through radix_pick on its int64 counts with no host pick, bit-equal
to a sort and within 1e-4 of the JAX package's pass 1.
"""

from __future__ import annotations

import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.ops.overlap import WindowPredictor as JaxWindowPredictor
from orcai_tpu.ops.pallas_hist import _pick as jax_pick
from orcai_tpu.ops.pallas_hist import digit_histograms as jax_digit_histograms
from orcai_tpu.ops.pallas_hist import pad_unit
from orcai_tpu.ops.streaming import _AudioSource as JaxAudioSource
from orcai_tpu.ops.streaming import StreamingPredictor as JaxStreamingPredictor
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.ops import radix_select
from orcai_tpu_torch.ops import streaming as tstreaming
from orcai_tpu_torch.ops.frontend import nearest_quantile_index
from orcai_tpu_torch.ops.overlap import WindowPredictor
from orcai_tpu_torch.ops.radix_select import (
    _LEVELS,
    radix_pick,
    select_levels,
    select_order_statistics,
    select_order_statistics_at,
)
from orcai_tpu_torch.ops.streaming import StreamingPredictor, pick_int64
from orcai_tpu_torch.tools import probe_select

N = 20_003


@pytest.fixture(scope="module")
def values():
    """|normal| * exp(3 normal) with heavy ties at 0.125 and a run of zeros:
    most of the 2048 top digits empty, a few crowded."""
    rng = np.random.default_rng(23)
    x = (np.abs(rng.standard_normal(N + 8)) * np.exp(3.0 * rng.standard_normal(N + 8)))
    x = x.astype(np.float32)
    x[::97] = 0.125
    x[40:90] = 0.0
    return x


def _bin_edge_rank(x: np.ndarray) -> int:
    """A rank that sits on a level-0 bin edge: the count below the second
    occupied top digit, so the rank left inside its bin is 0."""
    hist = np.bincount(x.view(np.uint32) >> 21, minlength=2048)
    return int(np.cumsum(hist)[np.flatnonzero(hist)[0]])


CASES = {
    # (offset of the view, n_valid, rank rule)
    "ragged view": (1, N - 3, "quantiles"),
    "k at 0 and n - 1": (0, N, "ends"),
    "k on a bin edge": (3, N - 1, "edge"),
    "a short prefix": (2, 1001, "quantiles"),
}


def _ranks(x, rule, n_valid):
    if rule == "ends":
        return [0, n_valid - 1]
    if rule == "edge":
        return [_bin_edge_rank(x[:n_valid]), n_valid // 2]
    return [nearest_quantile_index(q, n_valid) for q in (0.01, 0.999)]


@pytest.mark.parametrize("case", list(CASES))
def test_levels_match_pallas_and_pick(values, case):
    """Each level: the counts, the next prefixes and the ranks inside,
    bit-equal to the Pallas sweep in interpret mode and its `_pick` with
    the shifts of orcai_tpu's select_order_statistics; the results, to a
    sort."""
    offset, n_valid, rule = CASES[case]
    view = values[offset : offset + N]
    flat = torch.from_numpy(values)[offset : offset + N]
    assert flat.data_ptr() % 16 == 4 * offset % 16
    ks = _ranks(view, rule, n_valid)
    padded = jnp.asarray(np.pad(view, (0, -(-N // pad_unit()) * pad_unit() - N)))
    counts, prefixes, ranks = select_levels(
        flat, torch.tensor([n_valid], dtype=torch.int32), torch.tensor([ks[0]]),
        torch.tensor([ks[1]]))
    j_prefixes, j_ranks = [0, 0], list(ks)
    for level, (shift, bits, pshift) in enumerate(_LEVELS):
        ref = np.asarray(jax_digit_histograms(
            padded, jnp.asarray(n_valid, jnp.int32), jnp.asarray(j_prefixes, jnp.uint32),
            shift, bits, pshift, interpret=True))
        np.testing.assert_array_equal(counts[level].numpy(), ref)
        for t in range(2):
            b, left = jax_pick(jnp.asarray(ref[0 if pshift is None else t]),
                               jnp.asarray(j_ranks[t], jnp.int32))
            j_prefixes[t] = (j_prefixes[t] << bits) | int(b)
            j_ranks[t] = int(left)
        assert prefixes[level].dtype == torch.int32 and ranks[level].dtype == torch.int64
        assert [p & 0xFFFFFFFF for p in prefixes[level].tolist()] == j_prefixes
        assert ranks[level].tolist() == j_ranks
    ordered = np.sort(view[:n_valid])
    got = prefixes[-1].view(torch.float32).numpy()
    assert got.tobytes() == ordered[ks].tobytes()


def test_levels_on_host_integers_are_the_tensor_form(values):
    """select_levels with n_valid and the ranks as host integers (the
    kernel's values) gives the tensor form's levels."""
    n, ks = N - 7, [5, N - 20]
    flat = torch.from_numpy(values[:N])
    ints = select_levels(flat, n, *ks)
    tensors = select_levels(flat, torch.tensor([n], dtype=torch.int32),
                            torch.tensor([ks[0]]), torch.tensor([ks[1]]))
    for a, b in zip(ints, tensors):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("q_lo,q_hi", [(0.01, 0.999), (0.0, 1.0), (0.5, 0.5)])
def test_selection_on_host_integers_is_the_tensor_form(values, q_lo, q_hi):
    """select_order_statistics_at (finalize's form: host integers) bit-equal
    to select_order_statistics on tensors and to a sort."""
    n = N - 5
    ks = [nearest_quantile_index(q, n) for q in (q_lo, q_hi)]
    flat = torch.from_numpy(values[:N])
    lo, hi = select_order_statistics(
        flat, torch.tensor([n], dtype=torch.int32), torch.tensor([ks[0]]), torch.tensor([ks[1]]))
    lo_at, hi_at = select_order_statistics_at(flat, n, *ks)
    s = np.sort(values[:n])
    for a, b, want in ((lo, lo_at, s[ks[0]]), (hi, hi_at, s[ks[1]])):
        assert a.shape == b.shape == (1,) and a.dtype == b.dtype == torch.float32
        assert a.numpy().tobytes() == b.numpy().tobytes() == np.float32(want).tobytes()


def _jax_host_pick():
    """The JAX package's host pick, the function `pick` nested in
    orcai_tpu/ops/streaming.py's StreamingPredictor._select_percentiles,
    rebuilt from its code object."""
    def find(code):
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                if const.co_name == "pick":
                    return const
                found = find(const)
                if found is not None:
                    return found
        return None

    code = find(JaxStreamingPredictor._select_percentiles.__code__)
    assert code is not None and not code.co_freevars
    return types.FunctionType(code, {"np": np})


def _int64_cases():
    rng = np.random.default_rng(5)
    sparse = [3_000_000_000, 0, 4_000_000_000, 0, 0, 5_000_000_000]
    wide = rng.integers(0, 1 << 40, (2, 2048)).astype(np.int64)
    wide[:, rng.integers(0, 2048, 900)] = 0
    return {
        # counts and ranks past 2^31 (test_pick_int64's), on 2048 bins
        "bins past int32": (np.array([sparse + [0] * 2042] * 2, np.int64),
                            [2_999_999_999, 6_999_999_999], 11),
        "rank on an edge past int32": (np.array([sparse + [0] * 2042] * 2, np.int64),
                                       [3_000_000_000, 11_999_999_999], 11),
        "a total past 2^31 of int32 bins": (np.full((2, 1024), 2_000_000_000, np.int64),
                                            [2**31, 2_000_000_000 * 1024 - 1], 10),
        "40-bit counts": (wide, [int(wide[0].sum()) // 3, int(wide[1].sum()) - 1], 11),
        "an empty target": (np.stack([wide[0], np.zeros(2048, np.int64)]), [0, 0], 11),
    }


@pytest.mark.parametrize("case", list(_int64_cases()))
@pytest.mark.parametrize("shared_row", [True, False])
def test_int64_pick_matches_host_picks(case, shared_row):
    """radix_pick on int64 counts (on the CPU its plain version), the ranks
    on the host as the streamed path passes its first level's, against
    pick_int64 and the JAX package's host pick."""
    hists, ks, bits = _int64_cases()[case]
    prefixes = torch.tensor([5, 0x7FF], dtype=torch.int32)
    got_p, got_k = radix_pick(torch.from_numpy(hists), torch.tensor(ks, dtype=torch.int64),
                              prefixes, bits, shared_row)
    assert got_p.dtype == torch.int32 and got_k.dtype == torch.int64
    jax_host_pick = _jax_host_pick()
    for t in range(2):
        row = hists[0 if shared_row else t]
        b, left = pick_int64(row, ks[t])
        assert jax_host_pick(row, ks[t]) == (b, left)
        assert int(got_p[t]) & 0xFFFFFFFF == ((int(prefixes[t]) << bits) | b) & 0xFFFFFFFF
        assert int(got_k[t]) == left


SP = {"sampling_rate": 4800, "nfft": 48, "n_overlap": 24, "freq_range": [0, 2100],
      "quantiles": [0.01, 0.999]}
PARAM = {"name": "tiny", "architecture": "ResNetLSTM",
         "model": {"filters": [4, 6, 8, 10], "kernel_size": 3, "dropout_rate": 0.5,
                   "lstm_units": 8},
         "calls": ["A", "B", "C"]}
SNIPPET, NBINS = 64, 21


@pytest.mark.parametrize("hbm_audio_budget", [1 << 40, 0])
def test_streamed_levels_pick_on_the_device_form(monkeypatch, hbm_audio_budget):
    """Pass 1 picks each level through radix_pick on its int64 counts (the
    host pick is never called), returns 0-d float32 tensors on the source's
    device, bit-equal to a sort of its own magnitudes and within 1e-4 of
    the JAX package's pass 1; pass 2 takes those tensors as they are."""
    torch.manual_seed(0)
    model = build_model(PARAM, (SNIPPET, NBINS, 1)).eval()
    wp = WindowPredictor(model, snippet_len=SNIPPET, n_filters=4, batch_size=4,
                         max_windows_per_chunk=16)
    rng = np.random.default_rng(11)
    audio = (rng.uniform(-0.5, 0.5, size=20_011) * 32767).astype(np.int16)
    streaming = StreamingPredictor(wp, SP, windows_per_chunk=8, stats_tile_frames=128,
                                   hbm_audio_budget=hbm_audio_budget)
    source, n_frames = streaming.source(audio)
    assert source.resident == (hbm_audio_budget > 0)

    picks = []
    real_pick = tstreaming.radix_pick

    def recording(hists, ranks, prefixes, bits, shared_row):
        picks.append((hists.dtype, ranks.dtype, bits, shared_row))
        return real_pick(hists, ranks, prefixes, bits, shared_row)

    def no_host_pick(*_):
        raise AssertionError("pass 1 picked on the host")

    monkeypatch.setattr(tstreaming, "radix_pick", recording)
    monkeypatch.setattr(tstreaming, "pick_int64", no_host_pick)
    ref, lo_mag, hi_mag = streaming._select_percentiles(source, n_frames)
    assert picks == [(torch.int64, torch.int64, bits, pshift is None)
                     for _, bits, pshift in _LEVELS]
    for v in (ref, lo_mag, hi_mag):
        assert isinstance(v, torch.Tensor) and v.shape == () and v.dtype == torch.float32

    mags = []
    for t0 in range(0, n_frames, 128):
        mag = streaming._magnitudes(source, t0, 128)[: min(128, n_frames - t0)]
        mags.append(mag[:, streaming.lo_idx : streaming.hi_idx].reshape(-1))
    ordered = torch.sort(torch.cat(mags)).values
    ks = [nearest_quantile_index(q, ordered.numel()) for q in SP["quantiles"]]
    assert lo_mag.numpy().tobytes() == ordered[ks[0]].numpy().tobytes()
    assert hi_mag.numpy().tobytes() == ordered[ks[1]].numpy().tobytes()

    jmodel = jax_build_model(PARAM)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, SNIPPET, NBINS, 1)))
    jref = JaxStreamingPredictor(
        JaxWindowPredictor(jmodel, variables, snippet_len=SNIPPET, n_filters=4, batch_size=4,
                           max_windows_per_chunk=16, dense_trunk=False),
        SP, windows_per_chunk=8, stats_tile_frames=128, wire="exact")
    jsource = JaxAudioSource(audio, SP["nfft"], SP["n_overlap"], hbm_audio_budget, 128)
    want = jref._select_percentiles(jsource, n_frames, False)
    np.testing.assert_allclose([float(ref), float(lo_mag), float(hi_mag)], want, rtol=1e-4)

    agg, count, n_out = streaming._infer(source, n_frames, ref, lo_mag, hi_mag)
    assert n_out == n_frames // wp.down and torch.isfinite(agg).all()


def test_selection_wrappers_validate():
    p = torch.zeros(2, dtype=torch.int32)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        select_levels(torch.zeros(16, device=meta), 16, 0, 15)
    with pytest.raises(ValueError, match="unsupported device"):
        select_order_statistics_at(torch.zeros(16, device=meta), 16, 0, 15)
    with pytest.raises(ValueError, match="unsupported device"):
        radix_pick(torch.zeros((2, 2048), dtype=torch.int64, device=meta),
                   torch.tensor([0, 1]), p.to(meta), 11, True)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_host_n_valid_stays_below_int32(device):
    """The host-integer form rejects an n_valid of 2**31 or more on every
    device, as the int32 tensor form cannot hold one: the kernel's counts
    and the pick's sums are int32."""
    flat = torch.zeros(16, device=device)
    for n in (1 << 31, 1 << 33):
        with pytest.raises(ValueError, match="below 2\\*\\*31"):
            select_order_statistics_at(flat, n, 0, 1)
        with pytest.raises(ValueError, match="below 2\\*\\*31"):
            select_levels(flat, n, 0, 1)
    if device == "cpu":  # the largest int32 count clips to the 16 values
        lo, hi = select_order_statistics_at(torch.arange(16.0), (1 << 31) - 1, 0, 15)
        assert (float(lo), float(hi)) == (0.0, 15.0)


def test_kernel_source_mirrors_the_levels_and_the_scratch():
    """csrc/digit_hist.cu's level table and scratch layout are the ones
    ops/radix_select.py reads its views from."""
    source = (radix_select._build.CSRC / "digit_hist.cu").read_text()
    table = re.search(r"LEVELS\[3\]\[3\] = \{(.*?)\};", source).group(1)
    rows = [tuple(int(v) for v in row.split(",")) for row in re.findall(r"\{([^{}]*)\}", table)]
    assert rows == [(shift, bits, -1 if pshift is None else pshift)
                    for shift, bits, pshift in _LEVELS]
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", source))
    words = {"MAX_BINS": radix_select._MAX_BINS}
    for name in ("O_PREFIX", "O_RANK", "O_TICKET"):
        words[name] = eval(consts[name], {}, dict(words))  # noqa: S307 (the source's own sums)
    assert (words["O_PREFIX"], words["O_RANK"], words["O_TICKET"]) == (
        radix_select._O_PREFIX, radix_select._O_RANK, radix_select._O_TICKET)
    assert radix_select._SCRATCH_WORDS >= radix_select._O_TICKET + 3  # a ticket a level


def test_probe_select_needs_a_card():
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe_select.main(["--trees", "."])
