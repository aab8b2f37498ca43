"""The port's kernel modules on the CPU (their plain PyTorch versions) vs
the JAX Pallas kernels in interpret mode and numpy.

B1 ops/dft.py::dft_magnitude vs orcai_tpu/ops/pallas_dft.py, atol 2e-4
(tests/test_pallas_dft.py); B2 ops/radix_select.py::digit_histograms vs
orcai_tpu/ops/pallas_hist.py, exact; select_order_statistics bit-equal to
the JAX selection and to torch.sort (tests/test_pallas_hist.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orcai_tpu.ops.frontend import _dft_mats as jax_dft_mats, hann_window
from orcai_tpu.ops.pallas_dft import dft_magnitude as jax_dft_magnitude
from orcai_tpu.ops.pallas_hist import (
    digit_histograms as jax_digit_histograms,
    pad_unit,
    select_order_statistics as jax_select,
)
from orcai_tpu_torch.ops.dft import dft_magnitude, dft_magnitude_plain
from orcai_tpu_torch.ops.frontend import _dft_mats
from orcai_tpu_torch.ops.radix_select import (
    digit_histograms,
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


def _mats():
    C, S = _dft_mats(NFFT)
    return torch.from_numpy(C.copy()), torch.from_numpy(S.copy())


def test_dft_mats_match_reference():
    for ours, ref in zip(_dft_mats(NFFT), jax_dft_mats(NFFT)):
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
    C, S = _mats()
    got = dft_magnitude(torch.from_numpy(padded), C, S, n_fft=NFFT, hop=HOP)
    assert got.shape == (tpad, 257) and got.dtype == torch.float32
    ref = jax_dft_magnitude(
        jnp.asarray(padded), *map(jnp.asarray, jax_dft_mats(NFFT)),
        n_fft=NFFT, hop=HOP, tile_frames=64, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), _numpy_mag(as_float), atol=2e-4, rtol=0)


def test_dft_wrapper_validates_geometry():
    C, S = _mats()
    with pytest.raises(ValueError, match="hop"):
        dft_magnitude_plain(torch.zeros(1024), C, S, n_fft=NFFT, hop=300)
    with pytest.raises(ValueError, match="padded audio"):
        dft_magnitude(torch.zeros(1000), C, S, n_fft=NFFT, hop=HOP)
    with pytest.raises(ValueError, match="unsupported device"):
        dft_magnitude(torch.zeros(1024, device="meta"), C, S, n_fft=NFFT, hop=HOP)


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


def test_digit_histograms_wrapper_validates():
    x = torch.zeros(10)
    nv = torch.tensor([10], dtype=torch.int32)
    p = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="digit_bits"):
        digit_histograms(x, nv, p, 0, 12, None)
    with pytest.raises(ValueError, match="unsupported device"):
        digit_histograms(x.to("meta"), nv, p, 21, 11, None)
