"""B1 at n_fft 1 on the CPU: the point route's arithmetic (ops/dft.py::
_point_reference, what csrc/dft_point.cu computes) bit-equal to the plain
version and within 2e-4 of the Pallas kernel in interpret mode and of the
float64 magnitudes, in float32, int16 and uint8 mu-law codes, with a window
that is not 1; the route and the wrapper's refusals. The kernel itself runs
on the card (chip_smoke.py, phase wires: bit-equal to the plain version in
every type and on a code view one byte off)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orcai_tpu.ops.pallas_dft import dft_magnitude as jax_dft_magnitude
from orcai_tpu.ops.wire_codec import mulaw_decode_host, mulaw_encode
from orcai_tpu_torch.ops.dft import (
    _build_variant,
    _point_reference,
    dft_magnitude,
    dft_magnitude_plain,
    dft_route,
    windowed_dft_mats,
)

FRAMES = 4096  # a multiple of the Pallas tile


def _samples(dtype: str, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(samples, their float64 values): FRAMES one-point frames."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, FRAMES, dtype=np.int16)
    padded = {"f32": (0.3 * rng.standard_normal(FRAMES)).astype(np.float32), "int16": pcm,
              "uint8": mulaw_encode(pcm)}[dtype]
    as_f64 = {"f32": padded.astype(np.float64), "int16": pcm / 32768.0,
              "uint8": mulaw_decode_host(padded) / 32768.0}[dtype]
    return padded, as_f64


@pytest.mark.parametrize("w0", [0.7, 1.0, 0.0])
@pytest.mark.parametrize("dtype", ["f32", "int16", "uint8"])
def test_point_reference_is_the_plain_version_and_pallas(dtype, w0):
    """|w[0] s(x[t])| as the point kernel computes it (re = s w[0] in
    float32, then sqrt(re * re)) is the plain version's bits (its im = s
    S[0, 0] is +-0), which the wrapper returns for a CPU tensor, and within
    2e-4 of the Pallas kernel in interpret mode and of the float64 values;
    a window of 0 gives zeros."""
    padded, as_f64 = _samples(dtype, 11 + int(10 * w0))
    window = np.array([w0])
    x = torch.from_numpy(padded)
    got = _point_reference(x, window)
    plain = dft_magnitude_plain(x, window, n_fft=1, hop=1)
    assert got.shape == (FRAMES, 1) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(dft_magnitude(x, window, n_fft=1, hop=1), plain)
    C, S = windowed_dft_mats(window)
    pallas = np.asarray(jax_dft_magnitude(jnp.asarray(padded), jnp.asarray(C), jnp.asarray(S),
                                          n_fft=1, hop=1, tile_frames=512, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy()[:, 0], np.abs(w0 * as_f64), atol=2e-4, rtol=0)
    if w0 == 0.0:
        assert not got.any()


def test_point_reference_keeps_the_plain_bits_where_the_square_underflows():
    """Where re * re underflows, sqrt(re * re) (the plain version's, and the
    kernel's) is not |re|: the point arithmetic keeps the plain version's
    bits there too, and the codes give their int16 decode's bits."""
    x = torch.tensor([1e-30, -3e-25, 2e-20, 1e-19, 0.0, -0.0, 5e-38], dtype=torch.float32)
    window = np.array([0.7])
    got = _point_reference(x, window)
    assert torch.equal(got.view(torch.int32),
                       dft_magnitude_plain(x, window, n_fft=1, hop=1).view(torch.int32))
    assert not torch.equal(got[:, 0], (x * np.float32(0.7)).abs())
    codes = torch.from_numpy(mulaw_encode(np.arange(-32768, 32768, 7, dtype=np.int16)))
    decoded = torch.from_numpy(mulaw_decode_host(codes.numpy()))
    assert torch.equal(_point_reference(codes, window), _point_reference(decoded, window))


def test_point_route_takes_n_fft_1_alone():
    """n_fft 1 (hop 1) takes the point route, built once for every sample
    type (no variants); no other size does; a window of another length, an
    unsupported dtype or device is refused before a kernel runs."""
    assert dft_route(1) == "point"
    assert all(dft_route(n) != "point" for n in (2, 3, 512, 8193, 40962))
    assert _build_variant("point", 1, torch.int16) is None
    x = torch.zeros(64, dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dft_magnitude(x, np.ones(1), n_fft=1, hop=1)
    with pytest.raises(ValueError, match="window"):
        dft_magnitude(torch.zeros(64), np.ones(2), n_fft=1, hop=1)
    with pytest.raises(ValueError, match="float32, int16 or uint8"):
        dft_magnitude(torch.zeros(64, dtype=torch.float64, device="meta"), np.ones(1), n_fft=1,
                      hop=1)
