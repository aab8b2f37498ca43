"""Windowed rDFT magnitude of hop-framed audio (kernel B1).

Counterpart of orcai_tpu/ops/pallas_dft.py. The function is
|rDFT(window * frame)| of every frame of float32, int16 (scaled by 1/32768)
or uint8 mu-law audio (the mulaw8 wire's codes, decoded as
ops/wire_codec.py::mulaw_decode_f32 does), at any n_fft that hop divides.

`dft_magnitude` takes one of six CUDA routes for a CUDA tensor, chosen by
n_fft alone (`dft_route`), and runs the plain PyTorch version,
`dft_magnitude_plain`, for a CPU tensor:

- "fft", csrc/dft_magnitude.cu, at n_fft in FFT_SIZES (512, the reference
  geometry): a batched FFT in shared memory, two real frames on one
  512-point complex FFT (three radix-8 Stockham passes), untangled
  afterwards. `_fft_pairs_reference` is that arithmetic step by step in
  PyTorch, with the kernel's tables (`fft_tables`) and index maps, so the
  algorithm is testable where no card is;
- "mixed", csrc/dft_mixed.cu, at every other n_fft from 2 to MIXED_MAX
  (8192) whose prime factors are all in MIXED_PRIMES (the spectral wires'
  384 and 352, 416, 464, 496, 1024, 1088, 1216, 1472, 1856, 1984, 2048,
  4096, 4352, 8192, ...): the same shape with one Stockham pass per radix of
  `fft_plan(n_fft)` (16, 8, 4, 2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31). The
  plans of the spectral wires' 384 and 352 (ops/spectral.py), the sizes of
  this route that a configuration of the repo runs, are compiled whole
  into kernels of their own, every stride, pad and round a constant (the
  compiled layout: a warp a frame pair, 24 warps an SM; the exchange
  layouts derived from the radices at compile time, csrc/dft_pads.cuh,
  as `exchange_pads` derives them); any other plan is read at run time,
  each warp owning a frame pair where four warps fit on an SM (the warp
  layout, up to 2048 at the usual hops) and the whole block owning one
  otherwise (the block layout); the block layout's powers of two (4096,
  8192; `block_compiled`) are compiled whole too, a group of threads a
  frame pair and several groups a block. `mixed_layout` reports the
  layout the card takes. `_fft_mixed_reference` is the arithmetic of all
  of them step by step;
- "cluster", csrc/dft_cluster.cu, at an n_fft from MIXED_MAX + 1 to
  CLUSTER_MAX (81920) whose prime factors are all in CLUSTER_PRIMES (no 29,
  31): one frame pair's FFT on a thread block cluster of 2, 4 or 8 CTAs that
  read each other's shared memory, as the four-step split of
  `cluster_plan(n_fft)` (column FFTs, twiddles, one exchange, row FFTs; the
  tables of `cluster_tables`). `_fft_cluster_reference` is its arithmetic
  step by step;
- "chirp", at every other n_fft from 2 to CHIRP_MAX (40960), those with a
  prime factor above 31: the DFT as a circular
  convolution of length `chirp_length(n_fft)` (a smooth M >= 2 n_fft - 1
  whose passes move the fewest values) with the tables of `chirp_tables`,
  in the chirp-z (Bluestein) mode of csrc/dft_mixed.cu where M is within
  MIXED_MAX and of csrc/dft_cluster.cu above, on up to 8 CTAs
  (`_chirp_kernel`). `_chirp_reference` and `_chirp_cluster_reference` are
  their arithmetic step by step;
- "staged", csrc/dft_staged.cu, at every n_fft the routes above leave from
  MIXED_MAX + 1 to STAGED_MAX (2^20: a smooth n_fft with a 29 or 31 from
  8193, any n_fft from 40961): the four-step split of `staged_plan(n)` in
  kernels of their own that pass each frame pair's values through a
  scratch buffer in device memory, in chunks of frame pairs
  (`staged_chunk_pairs`). A MIXED_PRIMES-smooth n_fft it splits runs in
  its FFT mode (14848, 98304, 131072; two kernels a chunk; a side whose
  radices are all powers of two, and 98304's rows, on a kernel compiled
  whole: `staged_sides_compiled`, `staged_layout`);
  any other runs in its chirp-z mode, on a convolution length up to
  STAGED_M_MAX (40962, 49154; three kernels a chunk, the last one on the
  column pairs of `staged_mirror_groups`). `_staged_reference` and
  `_chirp_staged_reference` are their arithmetic step by step;
- "point", csrc/dft_point.cu, at n_fft 1 (hop 1): each frame's one bin
  |w[0] s(x[t])|, one grid-stride pass of 16-byte loads and stores,
  bit-equal to the plain version (`_point_reference` is its arithmetic).

csrc/dft_gemm.cu, the reference's own algorithm (a tiled IEEE fp32 GEMM of
the frames, read straight from the audio, with the window-folded cos/sin
matrices of `windowed_dft_mats`), is reached by no route: it took n_fft 1
until the point kernel did, and stays as a yardstick that tools call
directly ("gemm" in ROUTES, for a caller that routes a size to it).

Above STAGED_MAX no route runs: the GEMM's 4 N (N/2 + 1) bytes of tables
(2.2 TB at 2^20 + 2) fit on no card, and `dft_route` raises.

The plain version computes the reference's GEMM with torch.matmul.
`dft_magnitude.launches` counts every kernel launch and
`dft_magnitude.route_launches` splits them by route; a staged call launches
its kernels chunk by chunk, counted in `dft_magnitude.staged_kernels`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from orcai_tpu_torch.ops import _build
from orcai_tpu_torch.ops.wire_codec import mulaw_decode_f32

FFT_SIZES = (512,)  # the sizes csrc/dft_magnitude.cu is instantiated for
MIXED_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31)  # the FFT kernels' radices, and 4, 8, 16
# of the chirp mode's convolution lengths: no radix-23, -29 or -31 pass (23
# makes 8198 slower, PERF.md)
CHIRP_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19)
CLUSTER_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23)  # csrc/dft_cluster.cu's radices: no 29, 31
MIXED_MAX = 8192  # the largest FFT of csrc/dft_mixed.cu (two buffers of it in shared memory)
CLUSTER_MAX = 81920  # the largest FFT of csrc/dft_cluster.cu (N/C of each buffer on C CTAs)
CHIRP_MAX = 40960  # the largest n_fft of the chirp mode: its M stays within CLUSTER_MAX
CLUSTER_RANKS = (2, 4, 8)  # the cluster sizes csrc/dft_cluster.cu runs (8: the portable most)
# a cluster CTA's shared memory where two share an SM (half its 228 KB less
# the 1 KB each CTA keeps; dft_cluster_plan.cuh::PAIR_CTA_BYTES); where no
# cluster fits so, a CTA's two exchange buffers alone, one CTA an SM
CLUSTER_PAIR_BYTES = 233472 // 2 - 1024
CLUSTER_SOLO_BUFFERS = 160 * 1024
CLUSTER_PLAN_BYTES = 576  # sizeof(Plan) of dft_cluster_plan.cuh, rounded to 16 bytes
STAGED_MAX = 1 << 20  # the largest n_fft of csrc/dft_staged.cu, either mode
STAGED_M_MAX = 2 * STAGED_MAX  # its largest FFT: its chirp mode's M at STAGED_MAX
STAGED_BATCH = 16  # the most columns, or row pairs, one staged CTA transforms
STAGED_CTA_BYTES = 96 * 1024  # a staged CTA's two buffers, so that two CTAs share an SM
STAGED_CTA_MAX_BYTES = 200 * 1024  # ... and the most they take, for a batch of one
STAGED_CHUNK_BYTES = 512 << 20  # a chunk's scratch: fewer, larger launches beat L2 (PERF.md)
ROUTES = ("fft", "mixed", "cluster", "chirp", "staged", "point", "gemm")
_DTYPE_CODES = {torch.float32: 0, torch.int16: 1, torch.uint8: 2}  # the kernels' dtype
_RADIX = 8
_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


def _frames_count(n_samples: int, n_fft: int, hop: int) -> int:
    if n_fft % hop != 0:
        raise ValueError(f"hop {hop} must divide n_fft {n_fft}")
    if n_samples < n_fft or (n_samples - n_fft) % hop != 0:
        raise ValueError(
            f"padded audio of {n_samples} samples is not (T - 1) * {hop} + "
            f"{n_fft} for any frame count T"
        )
    return (n_samples - n_fft) // hop + 1


def _check_window(window: np.ndarray, n_fft: int) -> np.ndarray:
    window = np.asarray(window, dtype=np.float64)
    if window.shape != (n_fft,):
        raise ValueError(f"window must have shape ({n_fft},), got {window.shape}")
    return window


@lru_cache(maxsize=None)
def _mats_cached(window_bytes: bytes) -> tuple[np.ndarray, np.ndarray]:
    w = np.frombuffer(window_bytes, dtype=np.float64)
    n_fft = w.shape[0]
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    C = (np.cos(ang) * w[:, None]).astype(np.float32)
    S = (-np.sin(ang) * w[:, None]).astype(np.float32)
    C.setflags(write=False)
    S.setflags(write=False)
    return C, S


def windowed_dft_mats(window: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag rDFT matrices (n_fft, n_fft//2 + 1) with the window folded
    in: for a raw frame x, re = x @ C and im = x @ S. Computed in float64,
    rounded once to float32. Read-only."""
    return _mats_cached(np.asarray(window, dtype=np.float64).tobytes())


@lru_cache(maxsize=None)
def roots_of_unity(n: int) -> np.ndarray:
    """tw[m] = (cos, -sin)(2 pi m / n), (n, 2), computed in float64 and
    rounded once to float32. Read-only."""
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    tw.setflags(write=False)
    return tw


@lru_cache(maxsize=None)
def _tables_cached(window_bytes: bytes) -> tuple[np.ndarray, np.ndarray]:
    w = np.frombuffer(window_bytes, dtype=np.float64)
    win = w.astype(np.float32)
    win.setflags(write=False)
    return win, roots_of_unity(w.shape[0])


def fft_tables(window: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's tables: the window (n_fft,) and the roots of unity
    tw[m] = (cos, -sin)(2 pi m / n_fft), (n_fft, 2), both computed in
    float64 and rounded once to float32. Read-only."""
    return _tables_cached(np.asarray(window, dtype=np.float64).tobytes())


def _to_f32(padded: torch.Tensor) -> torch.Tensor:
    """Samples as float32 in [-1, 1]: int16 scaled by 1/32768, uint8
    mu-law codes decoded."""
    if padded.dtype == torch.uint8:
        return mulaw_decode_f32(padded)
    if padded.dtype == torch.int16:
        return padded.float() * (1.0 / 32768.0)
    return padded.float()


def dft_magnitude_plain(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int
) -> torch.Tensor:
    """(Npad,) padded audio -> (T, n_bins) |DFT|, as the framed GEMM.

    Frame t is padded[t*hop : t*hop + n_fft], built as the concatenation of
    n_fft/hop consecutive hop-blocks (orcai_tpu/ops/frontend.py:154-166).
    int16 input is scaled by 1/32768 and uint8 mu-law codes are decoded
    (mulaw_decode_f32). The two matrices go to padded's device on every
    call and are not kept there.
    """
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    C, S = (
        torch.from_numpy(a.copy()).to(padded.device)
        for a in windowed_dft_mats(_check_window(window, n_fft))
    )
    x2 = _to_f32(padded).reshape(-1, hop)
    frames = torch.cat([x2[i : i + tpad] for i in range(n_fft // hop)], dim=1)
    re = frames @ C
    im = frames @ S
    return torch.sqrt(re * re + im * im)


def _point_reference(padded: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """csrc/dft_point.cu's arithmetic at n_fft 1 (hop 1): re = s w[0] with
    w[0] rounded to float32, then sqrt(re * re), (T, 1) float32; the bits of
    dft_magnitude_plain, whose im = s S[0, 0] is +-0."""
    w = float(np.float32(_check_window(window, 1)[0]))
    re = _to_f32(padded) * w
    return torch.sqrt(re * re).reshape(-1, 1)


def _fft4(re: list, im: list) -> tuple[list, list]:
    """4-point DFT, natural order: sums and differences."""
    s02r, s02i = re[0] + re[2], im[0] + im[2]
    d02r, d02i = re[0] - re[2], im[0] - im[2]
    s13r, s13i = re[1] + re[3], im[1] + im[3]
    d13r, d13i = re[1] - re[3], im[1] - im[3]
    return ([s02r + s13r, d02r + d13i, s02r - s13r, d02r - d13i],
            [s02i + s13i, d02i - d13r, s02i - s13i, d02i + d13r])


def _fft8(re: list, im: list) -> tuple[list, list]:
    """8-point DFT of eight complex tensors, outputs in natural order, with
    the kernel's operations: radix-2 on (n, n+4), the W8 twiddles, then two
    4-point DFTs giving the even and the odd outputs."""
    c = _SQRT_HALF
    ar = [re[n] + re[n + 4] for n in range(4)]
    ai = [im[n] + im[n + 4] for n in range(4)]
    br = [re[n] - re[n + 4] for n in range(4)]
    bi = [im[n] - im[n + 4] for n in range(4)]
    # b[n] *= W8^n = exp(-2 pi i n / 8)
    br[1], bi[1] = c * (br[1] + bi[1]), c * (bi[1] - br[1])
    br[2], bi[2] = bi[2], -br[2]
    br[3], bi[3] = c * (bi[3] - br[3]), -c * (br[3] + bi[3])
    er, ei = _fft4(ar, ai)  # X[0], X[2], X[4], X[6]
    odr, odi = _fft4(br, bi)  # X[1], X[3], X[5], X[7]
    out_r = [None] * 8
    out_i = [None] * 8
    for k1 in range(4):
        out_r[2 * k1], out_i[2 * k1] = er[k1], ei[k1]
        out_r[2 * k1 + 1], out_i[2 * k1 + 1] = odr[k1], odi[k1]
    return out_r, out_i


def _pair_frames(padded: torch.Tensor, n_fft: int, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames t (t even) and t + 1 of the float32 samples as two
    (ceil(T/2), n_fft) tensors; a phantom last frame of an odd count is
    zeros."""
    frames = _to_f32(padded).unfold(0, n_fft, hop)  # (tpad, n_fft) view
    if frames.shape[0] % 2:
        frames = torch.cat([frames, torch.zeros(1, n_fft, device=frames.device)])
    return frames[0::2], frames[1::2]


def _untangle(zr: torch.Tensor, zi: torch.Tensor, n_fft: int, tpad: int) -> torch.Tensor:
    """X_t[k] = (Z[k] + conj Z[(N-k) % N]) / 2 and X_t+1[k] = (Z[k] - conj
    Z[(N-k) % N]) / 2i for k <= N/2, and their magnitudes, interleaved back
    into (tpad, N/2 + 1) rows; odd N works unchanged."""
    k = torch.arange(n_fft // 2 + 1, device=zr.device)
    mirror = (n_fft - k) % n_fft
    mag_a, mag_b = _pair_magnitudes(zr[:, k], zi[:, k], zr[:, mirror], zi[:, mirror])
    return torch.stack([mag_a, mag_b], dim=1).reshape(-1, n_fft // 2 + 1)[:tpad]


def _pair_magnitudes(zr: torch.Tensor, zi: torch.Tensor, yr: torch.Tensor,
                     yi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """|X_t[k]| and |X_t+1[k]| from Z[k] = zr + i zi and its mirror Z[N-k] =
    yr + i yi."""
    return (0.5 * torch.sqrt((zr + yr) ** 2 + (zi - yi) ** 2),
            0.5 * torch.sqrt((zi + yi) ** 2 + (zr - yr) ** 2))


def _fft_pairs_reference(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int
) -> torch.Tensor:
    """The kernel's arithmetic, pass by pass, in float32 PyTorch.

    Frames t and t+1 (t even) become one complex signal z = w*x_t + i*w*x_t+1.
    Its n_fft-point FFT runs as radix-8 Stockham passes with Ns = 1, 8, 64:
    butterfly j reads z[j + r*n_fft/8], r = 0..7, multiplies by
    tw[r * (j % Ns) * n_fft / (8*Ns)], takes an 8-point DFT and writes
    z'[(j // Ns) * 8*Ns + j % Ns + r*Ns], which leaves the last pass in natural
    order. Then X_t[k] = (Z[k] + conj Z[N-k]) / 2 and
    X_t+1[k] = (Z[k] - conj Z[N-k]) / 2i, and the magnitudes.
    """
    if n_fft not in FFT_SIZES:
        raise ValueError(f"n_fft {n_fft} not supported; supported sizes: {FFT_SIZES}")
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    win, tw = (torch.from_numpy(a.copy()) for a in fft_tables(_check_window(window, n_fft)))
    xa, xb = _pair_frames(padded, n_fft, hop)
    zr, zi = xa * win, xb * win
    n_butterflies = n_fft // _RADIX
    j = torch.arange(n_butterflies)
    ns = 1
    while ns < n_fft:
        jm = j % ns
        in_r, in_i = [], []
        for r in range(_RADIX):
            vr, vi = zr[:, j + r * n_butterflies], zi[:, j + r * n_butterflies]
            if ns > 1 and r > 0:
                t = tw[r * jm * (n_fft // (_RADIX * ns))]
                vr, vi = vr * t[:, 0] - vi * t[:, 1], vr * t[:, 1] + vi * t[:, 0]
            in_r.append(vr)
            in_i.append(vi)
        out_r, out_i = _fft8(in_r, in_i)
        j0 = (j // ns) * (ns * _RADIX) + jm
        zr, zi = torch.empty_like(zr), torch.empty_like(zi)
        for r in range(_RADIX):
            zr[:, j0 + r * ns] = out_r[r]
            zi[:, j0 + r * ns] = out_i[r]
        ns *= _RADIX
    return _untangle(zr, zi, n_fft, tpad)


def _smooth(n: int, primes: tuple[int, ...] = MIXED_PRIMES) -> bool:
    """Every prime factor of n is in `primes`."""
    for r in primes:
        while n % r == 0:
            n //= r
    return n == 1


@lru_cache(maxsize=None)
def fft_plan(n_fft: int) -> tuple[int, ...]:
    """The mixed route's radices for n_fft, in the order its Stockham passes
    run: the power-of-two part 2^a in the fewest passes of radix at most 16,
    split as evenly as possible with the larger radices first, then 3, 5, 7,
    11, 13, 17, 19, 23, 29 and 31 (384 -> 16, 8, 3; 352 -> 8, 4, 11; 416 ->
    8, 4, 13; 1024 -> 16, 8, 8; 1088 -> 8, 8, 17; 1216 -> 8, 8, 19; 1472 ->
    8, 8, 23; 464 -> 16, 29; 1984 -> 8, 8, 31; 8192 -> 16, 8, 8, 8). Raises
    for an n_fft the route does not take."""
    if not 2 <= n_fft <= MIXED_MAX:
        raise ValueError(f"n_fft {n_fft}: the mixed route takes 2 to {MIXED_MAX}")
    n, a = n_fft, 0
    while n % 2 == 0:
        n //= 2
        a += 1
    passes = -(-a // 4)
    plan = [1 << (a // passes + (i < a % passes)) for i in range(passes)] if a else []
    for r in MIXED_PRIMES[1:]:
        while n % r == 0:
            plan.append(r)
            n //= r
    if n != 1:
        raise ValueError(f"n_fft {n_fft} has a prime factor outside {MIXED_PRIMES}")
    return tuple(plan)


@lru_cache(maxsize=None)
def _odd_roots(radix: int) -> tuple[np.ndarray, np.ndarray]:
    """cos and sin of 2 pi m / radix for m = 1 .. (radix - 1) / 2, float64
    rounded once to float32: the constants of csrc/dft_mixed.cu's odd
    butterflies."""
    m = np.arange(1, (radix - 1) // 2 + 1)
    ang = 2.0 * np.pi * m / radix
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# cos and sin of 2 pi m / 16 for the radix-16 twiddles W16^m, m = n2 * k1 < 10:
# float64 rounded once to float32, the zeros of cos(pi/2) and sin(pi) exact
_C16, _S16 = (np.where(np.abs(v) < 1e-12, 0.0, v).astype(np.float32)
              for v in (np.cos(2.0 * np.pi * np.arange(10) / 16),
                        np.sin(2.0 * np.pi * np.arange(10) / 16)))


def _dft_small(radix: int, re: list, im: list) -> tuple[list, list]:
    """radix-point DFT of `radix` complex tensors, outputs in natural order,
    with the kernel's operations: 2 and 4 as sums and differences, 8 by
    `_fft8`, 16 as 4 x 4 (a 4-point DFT over n1 of x[4 n1 + n2] for each
    n2, times W16^(n2 k1), a 4-point DFT over n2 giving X[k1 + 4 k2]), an odd
    radix directly over symmetric pairs: X[k] = A_k - i B_k,
    X[R-k] = A_k + i B_k with A_k = x0 + sum_n cos(2 pi nk/R) (x_n + x_R-n) and
    B_k = sum_n sin(2 pi nk/R) (x_n - x_R-n), n = 1 .. (R-1)/2."""
    if radix == 8:
        return _fft8(re, im)
    if radix == 2:
        return [re[0] + re[1], re[0] - re[1]], [im[0] + im[1], im[0] - im[1]]
    if radix == 4:
        return _fft4(re, im)
    if radix == 16:
        cols = [_fft4(re[n2::4], im[n2::4]) for n2 in range(4)]  # [n2] -> (re, im)[k1]
        out_r, out_i = [None] * 16, [None] * 16
        for k1 in range(4):
            col_r, col_i = [], []
            for n2 in range(4):
                vr, vi = cols[n2][0][k1], cols[n2][1][k1]
                if n2 and k1:  # times exp(-2 pi i m / 16)
                    c, s = float(_C16[n2 * k1]), float(_S16[n2 * k1])
                    vr, vi = vr * c + vi * s, vi * c - vr * s
                col_r.append(vr)
                col_i.append(vi)
            xr, xi = _fft4(col_r, col_i)
            for k2 in range(4):
                out_r[k1 + 4 * k2], out_i[k1 + 4 * k2] = xr[k2], xi[k2]
        return out_r, out_i
    half = (radix - 1) // 2
    cos, sin = (torch.from_numpy(a.copy()).to(re[0].device) for a in _odd_roots(radix))
    sr = [re[n] + re[radix - n] for n in range(1, half + 1)]
    si = [im[n] + im[radix - n] for n in range(1, half + 1)]
    dr = [re[n] - re[radix - n] for n in range(1, half + 1)]
    di = [im[n] - im[radix - n] for n in range(1, half + 1)]
    out_r, out_i = [None] * radix, [None] * radix
    out_r[0], out_i[0] = re[0], im[0]
    for n in range(half):
        out_r[0], out_i[0] = out_r[0] + sr[n], out_i[0] + si[n]
    for k in range(1, half + 1):
        ar, ai, br, bi = re[0], im[0], 0.0, 0.0
        for n in range(1, half + 1):
            m = n * k % radix  # cos(2 pi m / R) and sin, folded to m <= (R-1)/2
            c, sgn = (cos[m - 1], 1.0) if m <= half else (cos[radix - m - 1], -1.0)
            s = sgn * (sin[m - 1] if m <= half else sin[radix - m - 1])
            ar, ai = ar + c * sr[n - 1], ai + c * si[n - 1]
            br, bi = br + s * dr[n - 1], bi + s * di[n - 1]
        out_r[k], out_i[k] = ar + bi, ai - br
        out_r[radix - k], out_i[radix - k] = ar - bi, ai + br
    return out_r, out_i


def _stockham(zr: torch.Tensor, zi: torch.Tensor, plan: tuple[int, ...],
              tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The complex FFT of each row of zr + i zi (n = prod(plan) points) as
    csrc/dft_mixed.cu's passes: one Stockham pass per radix R of `plan`, Ns
    the product of the earlier radices. Butterfly j < n/R reads z[j + r*n/R],
    r = 0..R-1, multiplies by tw[r * (j % Ns) * n / (Ns*R)] (tw: the n roots
    of unity, `roots_of_unity`), takes an R-point DFT (`_dft_small`) and
    writes z'[(j // Ns) * Ns*R + j % Ns + r*Ns], which leaves the last pass
    in natural order."""
    n = zr.shape[1]
    ns = 1
    for radix in plan:
        nb = n // radix
        j = torch.arange(nb, device=zr.device)
        jm = j % ns
        in_r, in_i = [], []
        for r in range(radix):
            vr, vi = zr[:, j + r * nb], zi[:, j + r * nb]
            if ns > 1 and r > 0:
                t = tw[r * jm * (n // (ns * radix))]
                vr, vi = vr * t[:, 0] - vi * t[:, 1], vr * t[:, 1] + vi * t[:, 0]
            in_r.append(vr)
            in_i.append(vi)
        out_r, out_i = _dft_small(radix, in_r, in_i)
        base = (j // ns) * (ns * radix) + jm
        zr, zi = torch.empty_like(zr), torch.empty_like(zi)
        for r in range(radix):
            zr[:, base + r * ns] = out_r[r]
            zi[:, base + r * ns] = out_i[r]
        ns *= radix
    return zr, zi


def _fft_mixed_reference(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int
) -> torch.Tensor:
    """csrc/dft_mixed.cu's arithmetic in its FFT mode, pass by pass, in
    float32 PyTorch.

    Frames t and t+1 (t even) become one complex signal z = w*x_t + i*w*x_t+1.
    Its n_fft-point FFT runs the passes of fft_plan(n_fft) (`_stockham`, the
    roots from fft_tables); then the untangle (`_untangle`) and the
    magnitudes.
    """
    plan = fft_plan(n_fft)
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    win, tw = (torch.from_numpy(a.copy()) for a in fft_tables(_check_window(window, n_fft)))
    xa, xb = _pair_frames(padded, n_fft, hop)
    zr, zi = _stockham(xa * win, xb * win, plan, tw)
    return _untangle(zr, zi, n_fft, tpad)


STAGED_TRIPS = 2  # device-memory trips of an FFT on the staged layout, counted as passes


def _passes(m: int) -> int:
    """Passes that move all m values of an m-point FFT through shared
    memory: fft_plan's on the block layout (m <= MIXED_MAX), on the cluster
    layout (up to CLUSTER_MAX) the two sides' plus the exchange between
    them, on the staged layout the two sides' plus its STAGED_TRIPS through
    device memory (the scratch's write and read)."""
    if m <= MIXED_MAX:
        return len(fft_plan(m))
    n1, n2 = cluster_plan(m)[:2] if m <= CLUSTER_MAX else staged_plan(m)[:2]
    return len(fft_plan(n1)) + len(fft_plan(n2)) + (1 if m <= CLUSTER_MAX else STAGED_TRIPS)


def _smooth_range(lo: int, hi: int, primes: tuple[int, ...]) -> list[int]:
    """Every n from lo to hi whose prime factors are all in `primes`,
    ascending."""
    found = []

    def walk(n, i):
        if n >= lo:
            found.append(n)
        for j in range(i, len(primes)):
            if n * primes[j] <= hi:
                walk(n * primes[j], j)
    walk(1, 0)
    return sorted(found)


@lru_cache(maxsize=None)
def chirp_length(n_fft: int) -> int:
    """The chirp mode's convolution length: of the M from 2 n_fft - 1 to
    4 n_fft whose prime factors are all in CHIRP_PRIMES, the one of least
    M * _passes(M) (every pass moves M values through shared memory), the
    smallest on a tie. CHIRP_PRIMES leave radices 23, 29 and 31 out: an odd
    pass costs more than this count gives it, and 23 would move 8198 to
    16445 = 143 x 115 (11 * 13 x 5 * 23), a slower length on the card
    (PERF.md). Up to n_fft 4096 M stays within MIXED_MAX (the block layout);
    up to CHIRP_MAX above MIXED_MAX and within CLUSTER_MAX (the cluster
    layout); above CHIRP_MAX, up to STAGED_MAX, it takes any M up to 4 n_fft
    that staged_plan splits (the staged layout, M above CLUSTER_MAX). 470
    -> 952 = 8 * 7 * 17 (three passes), 2038 -> 4096 (not 4095 = 3^2 * 5 *
    7 * 13), 8198 -> 16456 = 2^3 * 11^2 * 17 (136 x 121, five passes with
    the exchange), 16418 -> 32851 = 247 x 133 (13 * 19 and 7 * 19, on 4
    CTAs), 24578 -> 50864 = 272 x 187 (on 8 CTAs), 40962 -> 82688 = 2^8 *
    17 * 19 (256 x 323 on the staged layout; 81928 = 2^3 * 7^2 * 11 * 19
    reads 1.6x slower there, PERF.md)."""
    if n_fft <= CHIRP_MAX:
        top = min(4 * n_fft, MIXED_MAX if n_fft <= MIXED_MAX // 2 else CLUSTER_MAX)
    elif n_fft <= STAGED_MAX:
        top = min(4 * n_fft, STAGED_M_MAX)
    else:
        raise ValueError(f"n_fft {n_fft}: the chirp mode takes 2 to {STAGED_MAX}")
    lengths = [m for m in _smooth_range(2 * n_fft - 1, top, CHIRP_PRIMES)
               if m <= CLUSTER_MAX or _staged_split(m) is not None]
    return min(lengths, key=lambda m: (m * _passes(m), m))


@lru_cache(maxsize=None)
def _chirp_cached(window_bytes: bytes, m: int) -> np.ndarray:
    w = np.frombuffer(window_bytes, dtype=np.float64)
    n_fft = w.shape[0]
    n = np.arange(n_fft, dtype=np.int64)
    a = np.exp(-1j * np.pi * ((n * n) % (2 * n_fft)).astype(np.float64) / n_fft)
    b = np.zeros(m, dtype=np.complex128)  # b[m] = conj a[|m|], circular
    b[:n_fft] = np.conj(a)
    b[m - n_fft + 1:] = np.conj(a[1:])[::-1]
    table = np.concatenate([w * a, a, np.fft.fft(b) / m])
    out = np.stack([table.real, table.imag], axis=1).astype(np.float32)
    out.setflags(write=False)
    return out


def chirp_tables(window: np.ndarray, m: int | None = None) -> np.ndarray:
    """The chirp mode's tables for an (n_fft,) window, (2 n_fft + M, 2)
    float32 (re, im), M = m or chirp_length(n_fft): w a (n_fft), a (n_fft) and
    B = FFT_M(b) / M (M), a[n] = exp(-i pi (n^2 mod 2 n_fft) / n_fft) from
    n^2 mod 2 n_fft in int64 and the angle in float64, b[m] = conj a[|m|]
    zero-padded circularly to M, B its float64 FFT; every value computed in
    float64 and rounded once. Read-only."""
    window = np.asarray(window, dtype=np.float64)
    m = m or chirp_length(window.shape[0])
    if m < 2 * window.shape[0] - 1:
        raise ValueError(f"chirp length {m} is below 2 n_fft - 1 = {2 * window.shape[0] - 1}")
    return _chirp_cached(window.tobytes(), m)


def _chirp_reference(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int
) -> torch.Tensor:
    """csrc/dft_mixed.cu's arithmetic in its chirp mode (Bluestein), pass by
    pass, in float32 PyTorch.

    With M = chirp_length(n_fft) and the tables wa, a, B of chirp_tables:
    frames t and t+1 (t even) become z = wa[n] (x_t + i x_t+1)[n] for
    n < n_fft, zeros up to M; its M-point FFT Y by the passes of fft_plan(M)
    (`_stockham`, the M roots of unity); conj(Y B) (B carries the 1/M of the
    inverse) through the same forward FFT, u; Z[k] = a[k] conj u[k], the
    n_fft-point DFT of z / wa * w; then the untangle and the magnitudes.
    """
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    m = chirp_length(n_fft)
    plan = fft_plan(m)
    table = torch.from_numpy(chirp_tables(_check_window(window, n_fft)).copy())
    wa, a, bq = table[:n_fft], table[n_fft:2 * n_fft], table[2 * n_fft:]
    tw = torch.from_numpy(roots_of_unity(m).copy())
    xa, xb = _pair_frames(padded, n_fft, hop)
    zr = torch.zeros(xa.shape[0], m)
    zi = torch.zeros(xa.shape[0], m)
    zr[:, :n_fft] = wa[:, 0] * xa - wa[:, 1] * xb
    zi[:, :n_fft] = wa[:, 0] * xb + wa[:, 1] * xa
    yr, yi = _stockham(zr, zi, plan, tw)
    vr = yr * bq[:, 0] - yi * bq[:, 1]
    vi = -(yr * bq[:, 1] + yi * bq[:, 0])
    ur, ui = _stockham(vr, vi, plan, tw)
    ur, ui = ur[:, :n_fft], ui[:, :n_fft]
    zr = a[:, 0] * ur + a[:, 1] * ui
    zi = a[:, 1] * ur - a[:, 0] * ui
    return _untangle(zr, zi, n_fft, tpad)


@lru_cache(maxsize=None)
def cluster_plan(n: int) -> tuple[int, int, int]:
    """csrc/dft_cluster.cu's four-step split of an n-point FFT, n from
    MIXED_MAX + 1 to CLUSTER_MAX with every prime factor in CLUSTER_PRIMES:
    (N1, N2, C), N1 * N2 = n with both from 2 to MIXED_MAX, the split of
    fewest passes (fft_plan(N1) and fft_plan(N2)), then the most even, the
    larger factor first (16384 -> 128 x 128, 32768 -> 256 x 128, 65536 ->
    256 x 256); C, the CTAs of a cluster, the fewest of CLUSTER_RANKS whose
    CTAs fit twice on an SM (cluster_bytes within CLUSTER_PAIR_BYTES), so
    that two frame pairs are in flight on every SM: 4 at 16384 (74 KB a
    CTA) and at 20736, 8 at 32768; where none does (above about 48000
    points), the fewest whose two buffers fit in CLUSTER_SOLO_BUFFERS, one
    CTA an SM: 8 (128 KB of buffers at 65536). Raises for an n the layout
    does not take."""
    if not MIXED_MAX < n <= CLUSTER_MAX or not _smooth(n, CLUSTER_PRIMES):
        raise ValueError(f"n {n}: the cluster layout takes {CLUSTER_PRIMES}-smooth sizes from "
                         f"{MIXED_MAX + 1} to {CLUSTER_MAX}")
    splits = [(d, n // d) for d in range(n // MIXED_MAX, MIXED_MAX + 1)
              if d >= 2 and n % d == 0 and 2 <= n // d <= MIXED_MAX]
    n1, n2 = min(splits, key=lambda s: (len(fft_plan(s[0])) + len(fft_plan(s[1])),
                                        max(s) / min(s), -s[0]))
    pair = [c for c in CLUSTER_RANKS if cluster_bytes(n1, n2, c) <= CLUSTER_PAIR_BYTES]
    return n1, n2, pair[0] if pair else next(
        c for c in CLUSTER_RANKS if 16 * n <= c * CLUSTER_SOLO_BUFFERS)


def cluster_bytes(n1: int, n2: int, ranks: int) -> int:
    """Shared memory a CTA of csrc/dft_cluster.cu takes for the split n1 x n2
    on `ranks` CTAs, as dft_cluster_plan.cuh::make_plan lays it out: the
    plan, the pass roots and the twiddles' two tables, the lookups, every
    rank's buffer address and the two buffers (N1 columns of the rank's
    columns, N2 rows of its rows, each at an odd stride)."""
    h = n1 // 2
    pair_lo, r, acc = [0], 1, 0
    for k in range(h + 1):  # the row pairs {k, n1 - k} to the ranks by their rows' count
        while r < ranks and acc >= r * n1 // ranks:
            pair_lo.append(k)
            r += 1
        acc += 1 if k == 0 or (n1 % 2 == 0 and k == h) else 2
    pair_lo += [h + 1] * (ranks + 1 - len(pair_lo))
    most = max(hi - lo + max(min(hi, n1 - h) - max(lo, 1), 0)
               for lo, hi in zip(pair_lo, pair_lo[1:]))
    zbuf = (max(n1 * ((-(-n2 // ranks)) | 1), n2 * (most | 1)) + 1) & ~1
    roots = len(pass_roots(n1, fft_plan(n1))) + len(pass_roots(n2, fft_plan(n2)))
    s = 1 << twiddle_split(n1 * n2)
    tables = ((roots + 1) & ~1) * 8 + (s + -(-(n1 * n2) // s)) * 16
    lookups = -(-((n1 + n2) * 4 + n1 * 2) // 16) * 16
    return CLUSTER_PLAN_BYTES + tables + lookups + 8 * CLUSTER_RANKS[-1] + 2 * zbuf * 8


@lru_cache(maxsize=None)
def four_step_roots(n1: int, n2: int) -> np.ndarray:
    """The four-step twiddles of an N = n1 * n2-point FFT: W_N^(k1 j) =
    exp(-2 pi i k1 j / N) at [k1 * n2 + j], k1 < n1, j < n2, (N, 2) float32
    (re, im), the roots_of_unity(N) entry of (k1 j) mod N: float64 rounded
    once. Read-only."""
    n = n1 * n2
    k1, j = np.arange(n1)[:, None], np.arange(n2)[None, :]
    table = roots_of_unity(n)[((k1 * j) % n).reshape(-1)]
    table.setflags(write=False)
    return table


def _four_step_twiddles(split: tuple[int, int], device: torch.device) -> torch.Tensor:
    """The four-step twiddles W_N^(k1 j) at [k1, j], (n1, n2, 2) float32 on
    `device`, as csrc/dft_cluster.cu and csrc/dft_staged.cu form them
    (product_twiddles: four_step_roots' bits at all but a few)."""
    n1, n2 = split
    t = product_twiddles(n1 * n2, np.arange(n1)[:, None] * np.arange(n2)[None, :])
    return torch.from_numpy(t.copy()).to(device)


def _cluster_fft(zr: torch.Tensor, zi: torch.Tensor, split: tuple[int, int]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The complex FFT of each row of zr + i zi (N = n1 * n2 points, natural
    order in and out) as csrc/dft_cluster.cu's four steps: for each column
    j < n2 the n1-point FFT of z[n2 n1' + j] over n1' (`_stockham`,
    fft_plan(n1)), giving Y[k1, j]; Y times the twiddles [k1, j]
    (`_four_step_twiddles`); for each row k1 the n2-point FFT over j
    (fft_plan(n2)), giving Z[k1 + n1 k2]."""
    n1, n2 = split
    p = zr.shape[0]
    tw1, tw2 = (torch.from_numpy(roots_of_unity(n).copy()).to(zr.device) for n in (n1, n2))
    t = _four_step_twiddles(split, zr.device)
    cols = [v.reshape(p, n1, n2).transpose(1, 2).reshape(-1, n1) for v in (zr, zi)]
    yr, yi = (v.reshape(p, n2, n1).transpose(1, 2) for v in _stockham(*cols, fft_plan(n1), tw1))
    vr = yr * t[..., 0] - yi * t[..., 1]
    vi = yr * t[..., 1] + yi * t[..., 0]
    zr, zi = _stockham(vr.reshape(-1, n2), vi.reshape(-1, n2), fft_plan(n2), tw2)
    return tuple(v.reshape(p, n1, n2).transpose(1, 2).reshape(p, -1) for v in (zr, zi))


def _cluster_fft_rows_first(vr: torch.Tensor, vi: torch.Tensor, split: tuple[int, int]
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chirp mode's second FFT on the cluster layout, natural order in
    and out, in the order its input lies after the first (v[k1 + n1 k2] on
    the CTA that owns row k1): for each k1 the n2-point FFT over k2
    (fft_plan(n2)), giving G[k1, p2]; G times the twiddles [k1, p2]; for
    each p2 the n1-point FFT over k1 (fft_plan(n1)), giving U[n2 p1 + p2]."""
    n1, n2 = split
    p = vr.shape[0]
    tw1 = torch.from_numpy(roots_of_unity(n1).copy()).to(vr.device)
    cols = [v.transpose(1, 2).reshape(-1, n1)
            for v in _rows_and_twiddles(vr, vi, split)]
    return tuple(v.reshape(p, n2, n1).transpose(1, 2).reshape(p, -1)
                 for v in _stockham(*cols, fft_plan(n1), tw1))


def _rows_and_twiddles(vr: torch.Tensor, vi: torch.Tensor, split: tuple[int, int]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first half of `_cluster_fft_rows_first`: for each k1 the
    n2-point FFT over k2, times the twiddles [k1, p2] (`_four_step_twiddles`);
    (pairs, n1, n2) tensors H[k1, p2]."""
    n1, n2 = split
    p = vr.shape[0]
    tw2 = torch.from_numpy(roots_of_unity(n2).copy()).to(vr.device)
    t = _four_step_twiddles(split, vr.device)
    rows = [v.reshape(p, n2, n1).transpose(1, 2).reshape(-1, n2) for v in (vr, vi)]
    gr, gi = (v.reshape(p, n1, n2) for v in _stockham(*rows, fft_plan(n2), tw2))
    return gr * t[..., 0] - gi * t[..., 1], gr * t[..., 1] + gi * t[..., 0]


def _four_step_reference(padded: torch.Tensor, window: np.ndarray, n_fft: int, hop: int,
                         split: tuple[int, int]) -> torch.Tensor:
    """Frames t and t+1 (t even) as one complex signal z = w*x_t + i*w*x_t+1,
    its n_fft-point FFT by the four steps of `_cluster_fft` on `split` (its
    twiddles the product ones), then the untangle and the magnitudes."""
    if split[0] * split[1] != n_fft:
        raise ValueError(f"split {split} is not of n_fft {n_fft}")
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    win = torch.from_numpy(fft_tables(_check_window(window, n_fft))[0].copy()).to(padded.device)
    xa, xb = _pair_frames(padded, n_fft, hop)
    zr, zi = _cluster_fft(xa * win, xb * win, split)
    return _untangle(zr, zi, n_fft, tpad)


def _chirp_four_step_reference(padded: torch.Tensor, window: np.ndarray, n_fft: int, hop: int,
                               m: int, split: tuple[int, int]) -> torch.Tensor:
    """`_chirp_reference` with its two M-point FFTs as four steps on
    `split`: the first by `_cluster_fft`, the product with B and the
    conjugate where its output lies, the second rows first
    (`_cluster_fft_rows_first`); then Z[k] = a[k] conj u[k], the untangle
    and the magnitudes."""
    vr, vi, a = _chirp_first_fft(padded, window, n_fft, hop, m, split)
    ur, ui = _cluster_fft_rows_first(vr, vi, split)
    ur, ui = ur[:, :n_fft], ui[:, :n_fft]
    zr = a[:, 0] * ur + a[:, 1] * ui
    zi = a[:, 1] * ur - a[:, 0] * ui
    return _untangle(zr, zi, n_fft, _frames_count(padded.shape[0], n_fft, hop))


def _chirp_first_fft(padded: torch.Tensor, window: np.ndarray, n_fft: int, hop: int, m: int,
                     split: tuple[int, int]
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chirp mode on `split` up to its second FFT: z = wa (x_t + i
    x_t+1) zero-padded to M, its FFT by `_cluster_fft`, the product with B
    and the conjugate, (pairs, M) each; and the (n_fft, 2) table a."""
    if split[0] * split[1] != m:
        raise ValueError(f"split {split} is not of M {m}")
    table = torch.from_numpy(chirp_tables(_check_window(window, n_fft), m).copy()).to(padded.device)
    wa, a, bq = table[:n_fft], table[n_fft:2 * n_fft], table[2 * n_fft:]
    xa, xb = _pair_frames(padded, n_fft, hop)
    zr = torch.zeros(xa.shape[0], m, device=padded.device)
    zi = torch.zeros(xa.shape[0], m, device=padded.device)
    zr[:, :n_fft] = wa[:, 0] * xa - wa[:, 1] * xb
    zi[:, :n_fft] = wa[:, 0] * xb + wa[:, 1] * xa
    yr, yi = _cluster_fft(zr, zi, split)
    return yr * bq[:, 0] - yi * bq[:, 1], -(yr * bq[:, 1] + yi * bq[:, 0]), a


def _fft_cluster_reference(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int,
    split: tuple[int, int] | None = None,
) -> torch.Tensor:
    """csrc/dft_cluster.cu's arithmetic in its FFT mode, step by step, in
    float32 PyTorch: `_four_step_reference` with split =
    cluster_plan(n_fft)[:2] (or the split given, which lets a test run the
    same arithmetic at a small n_fft) and the kernel's product twiddles.
    The kernel's rank count changes where each value lies, not the
    arithmetic.
    """
    return _four_step_reference(padded, window, n_fft, hop, split or cluster_plan(n_fft)[:2])


def _chirp_cluster_reference(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int,
    m: int | None = None, split: tuple[int, int] | None = None,
) -> torch.Tensor:
    """csrc/dft_cluster.cu's arithmetic in its chirp mode (Bluestein), step
    by step, in float32 PyTorch: `_chirp_four_step_reference` with M = m or
    chirp_length(n_fft) and split = cluster_plan(M)[:2] (or those given);
    the kernel takes the product where the first FFT leaves each value and
    runs the second rows first, so that no exchange comes between the two;
    its twiddles are the kernel's product ones.
    """
    m = m or chirp_length(n_fft)
    return _chirp_four_step_reference(padded, window, n_fft, hop, m, split or cluster_plan(m)[:2])


def _divisors(n: int) -> list[int]:
    divs, p, left = [1], 2, n
    while p * p <= left:
        k = 0
        while left % p == 0:
            left //= p
            k += 1
        if k:
            divs = [d * p ** e for d in divs for e in range(k + 1)]
        p += 1
    if left > 1:
        divs = divs + [d * left for d in divs]
    return sorted(divs)


def _staged_bytes(n: int, ffts: int) -> int:
    """Shared memory of a staged CTA's two buffers: `ffts` FFTs of n complex
    values, element-major with an odd stride (csrc/dft_staged.cu)."""
    return 2 * n * (ffts | 1) * 8


@lru_cache(maxsize=None)
def _staged_batch(n: int, rows: int) -> int | None:
    """How many batches of `rows` FFTs of n points one staged CTA takes: the
    most, a power of two up to STAGED_BATCH, whose buffers fit in
    STAGED_CTA_BYTES; else 1 within STAGED_CTA_MAX_BYTES; else None."""
    for g in (16, 8, 4, 2, 1):
        if g <= STAGED_BATCH and _staged_bytes(n, rows * g) <= STAGED_CTA_BYTES:
            return g
    return 1 if _staged_bytes(n, rows) <= STAGED_CTA_MAX_BYTES else None


def _staged_sides(n1: int, n2: int) -> tuple[int, int, int, int] | None:
    """(N1, N2, G1, G2) where both sides are MIXED_PRIMES-smooth from 2 to
    MIXED_MAX and a CTA takes a batch of each kernel's FFTs; else None."""
    if not (2 <= n1 <= MIXED_MAX and 2 <= n2 <= MIXED_MAX and _smooth(n1) and _smooth(n2)):
        return None
    g1, g2 = _staged_batch(n1, 1), _staged_batch(n2, 2)
    return None if g1 is None or g2 is None else (n1, n2, g1, g2)


@lru_cache(maxsize=None)
def _staged_split(n: int) -> tuple[int, int, int, int] | None:
    """staged_plan(n), or None where csrc/dft_staged.cu cannot split n."""
    if not 4 <= n <= STAGED_M_MAX or not _smooth(n):
        return None
    plans = [p for d in _divisors(n) if (p := _staged_sides(d, n // d)) is not None]
    if not plans:
        return None
    return min(plans, key=lambda p: (len(fft_plan(p[0])) + len(fft_plan(p[1])),
                                     -min(p[2], 2 * p[3]), p[0]))


def staged_plan(n: int, split: tuple[int, int] | None = None) -> tuple[int, int, int, int]:
    """csrc/dft_staged.cu's four-step split of an n-point FFT (n up to
    STAGED_M_MAX, every prime factor in MIXED_PRIMES): (N1, N2, G1, G2),
    N1 * N2 = n with both from 2 to MIXED_MAX. Kernel 1 runs the N1-point
    FFTs of G1 adjacent columns j < N2 a CTA, kernel 2 the N2-point FFTs of
    G2 adjacent row pairs {k1, N1 - k1} a CTA, so that each reads and writes
    device memory in runs of adjacent values. G1 and G2 are the most, a
    power of two up to STAGED_BATCH, whose two buffers of shared memory fit
    in STAGED_CTA_BYTES (two CTAs an SM), else 1 within STAGED_CTA_MAX_BYTES.
    Of the splits, the one of fewest passes (fft_plan(N1) and fft_plan(N2)),
    then of the largest batch of columns or rows the smaller of G1 and 2 G2
    lets each CTA take, then the shorter column side (131072 -> 256 x 512,
    G1 16, G2 4; 98304 -> 256 x 384; 82688 -> 256 x 323, G2 8). The rule is
    the card's: at 131072 on 2048 frames 256 x 512 read 3.21 ms, 512 x 256
    3.30, 128 x 1024 3.30, 1024 x 128 3.66, 64 x 2048 3.70 and 32 x 4096,
    one long row pair a CTA, 4.70 (tools/bench_dft_plans.py --staged,
    PERF.md). `split` (N1, N2) takes that split instead, for the tools and
    the tests. Raises for an n the kernels do not take."""
    plan = _staged_split(n) if split is None else (
        _staged_sides(*split) if split[0] * split[1] == n and n <= STAGED_M_MAX else None)
    if plan is None:
        raise ValueError(f"n {n}: the staged layout takes {MIXED_PRIMES}-smooth sizes up to "
                         f"{STAGED_M_MAX} split as N1 x N2, both from 2 to {MIXED_MAX}, whose "
                         f"buffers fit in {STAGED_CTA_MAX_BYTES} bytes" +
                         (f" (split {split})" if split else ""))
    return plan


def staged_mode(n_fft: int) -> str:
    """The staged route's mode at n_fft: "fft" where staged_plan splits
    n_fft itself, "chirp" otherwise (an n_fft with a prime factor above 31,
    or one no split of whose fits)."""
    return "fft" if _staged_split(n_fft) is not None else "chirp"


# a row side compiled whole beside the powers of two, as (its radices, G2):
# 98304's rows, which the card singled out (dft_staged_plan.cuh::extra_row).
# It serves that one size of the FFT mode's reach, and no other
STAGED_EXTRA_ROWS = (((16, 8, 3), 4),)


def staged_sides_compiled(n: int, split: tuple[int, int] | None = None,
                          chirp: bool = False) -> tuple[bool, bool]:
    """Whether csrc/dft_staged.cu runs the column side (N1) and the row side
    (N2) of staged_plan(n, split) on a kernel compiled whole: in the FFT
    mode where the side's radices (fft_plan) are all powers of two, in two
    passes or more (dft_staged_plan.cuh::powers_of_two), or the row side
    with its G2 is one of STAGED_EXTRA_ROWS; with `chirp` (the chirp mode on
    a length n) the column side by the same rule, for its kernels 1 and 3,
    and never the rows, whose kernel runs two FFTs."""
    n1, n2, _, g2 = staged_plan(n, split)
    pow2 = [len(fft_plan(side)) >= 2 and all(r & (r - 1) == 0 for r in fft_plan(side))
            for side in (n1, n2)]
    if chirp:
        return pow2[0], False
    return pow2[0], pow2[1] or (fft_plan(n2), g2) in STAGED_EXTRA_ROWS


def staged_chunk_pairs(n: int) -> int:
    """Frame pairs of a staged chunk for an n-point FFT: as many as whose
    scratch of n complex values each fits in STAGED_CHUNK_BYTES, at least
    one."""
    return max(1, STAGED_CHUNK_BYTES // (8 * n))


def _staged_reference(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int,
    split: tuple[int, int] | None = None,
) -> torch.Tensor:
    """csrc/dft_staged.cu's arithmetic in its FFT mode, step by step, in
    float32 PyTorch: `_four_step_reference` with split = staged_plan(n_fft)
    [:2] (or the split given): kernel 1's N1-point column FFTs and the
    four-step twiddles W_N^(k1 j) (the kernel's product_twiddles), kernel
    2's N2-point row FFTs, the untangle. The batches, the chunks and a side
    compiled whole change where each value lies and when, not the
    arithmetic.
    """
    return _four_step_reference(padded, window, n_fft, hop, split or staged_plan(n_fft)[:2])


def _chirp_staged_reference(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int,
    m: int | None = None, split: tuple[int, int] | None = None,
) -> torch.Tensor:
    """csrc/dft_staged.cu's arithmetic in its chirp mode (Bluestein), step by
    step, in float32 PyTorch: `_chirp_four_step_reference` with M = m or
    chirp_length(n_fft) and split = staged_plan(M)[:2] (or those given):
    kernel 1 the first FFT's columns, kernel 2 its rows, the product with B
    and the second FFT's rows with W_M^(k1 p2), kernel 3 its columns, Z[k] =
    a[k] conj u[k] and the untangle (`_chirp_staged_fold_reference` walks
    kernel 3's column groups as the kernel does); both FFTs' twiddles are
    the kernels' product_twiddles.
    """
    m = m or chirp_length(n_fft)
    return _chirp_four_step_reference(padded, window, n_fft, hop, m, split or staged_plan(m)[:2])


def staged_fold(n_fft: int, m: int, split: tuple[int, int] | None = None) -> tuple[int, int, int]:
    """(G3, f, e) of the staged chirp mode's kernel 3 at n_fft on M = m
    split as staged_plan(m, split) = (N1, N2, ...). Its CTAs own column
    pairs: the mirror n_fft - k of a bin k = N2 p1 + p2 lies in column (r -
    p2) mod N2 (r = n_fft mod N2), so with 2 f + e = r (mod N2), e 0 or 1,
    the columns f + d and f + e - d (mod N2) pair up; f = r / 2 where r is
    even, (r + N2) / 2 where r is odd and N2 odd (e = 0: d and -d, one
    column alone at d = 0, and one more at d = N2 / 2 where N2 is even),
    (r - 1) / 2 where r is odd and N2 even (e = 1: d and 1 - d, none
    alone). G3, the column pairs a CTA, is the most, a power of two up to
    STAGED_BATCH, whose two buffers of 2 G3 N1-point FFTs fit in
    STAGED_CTA_BYTES (_staged_batch)."""
    n1, n2, _, _ = staged_plan(m, split)
    r = n_fft % n2
    f = r // 2 if r % 2 == 0 or n2 % 2 == 0 else (r + n2) // 2
    g3 = _staged_batch(n1, 2)
    if g3 is None:
        raise ValueError(f"M {m}: no batch of column pairs of {n1} points fits")
    return g3, f, (r - 2 * f) % n2


def staged_mirror_groups(n_fft: int, m: int | None = None, split: tuple[int, int] | None = None
                         ) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """The column groups of the staged chirp mode's kernel 3, one a CTA of a
    frame pair: (its columns f + d, mod N2, for G3 consecutive
    representatives d from e to (N2 + e) // 2; the partners f + e - d of
    those d that are not their own, in the same order) with (G3, f, e) of
    staged_fold(n_fft, M, split), M = m or chirp_length(n_fft). Every column
    lies in one group, with its partner."""
    m = m or chirp_length(n_fft)
    n2 = staged_plan(m, split)[1]
    g3, f, e = staged_fold(n_fft, m, split)
    top = (n2 + e) // 2
    groups = []
    for lo in range(e, top + 1, g3):
        ds = range(lo, min(lo + g3, top + 1))
        groups.append((tuple((f + d) % n2 for d in ds),
                       tuple((f + e - d) % n2 for d in ds if (2 * d - e) % n2)))
    return groups


def _chirp_staged_fold_reference(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int,
    m: int | None = None, split: tuple[int, int] | None = None,
) -> torch.Tensor:
    """`_chirp_staged_reference` with its last step as csrc/dft_staged.cu's
    kernel 3 walks it: for each group of staged_mirror_groups, the N1-point
    FFTs of its columns of H (kernel 2's rows times W_M^(k1 p2)), then for
    each row p1 <= (n_fft/2) / N2 and local column l of column p2, the bin k
    = N2 p1 + p2 <= n_fft / 2 with its mirror n_fft - k at row q - p1 (q -
    p1 - 1 where p2 > r; q, r = divmod(n_fft, N2)) of the partner column,
    bin 0 its own: Z = a conj u of both, untangled. The same arithmetic in
    another order, so the same bits."""
    m = m or chirp_length(n_fft)
    n1, n2 = split or staged_plan(m)[:2]
    vr, vi, a = _chirp_first_fft(padded, window, n_fft, hop, m, (n1, n2))
    hr, hi = _rows_and_twiddles(vr, vi, (n1, n2))
    pairs = hr.shape[0]
    tw1 = torch.from_numpy(roots_of_unity(n1).copy()).to(padded.device)
    q, r = divmod(n_fft, n2)
    n_bins = n_fft // 2 + 1
    out = torch.full((pairs, 2, n_bins), float("nan"), device=padded.device)
    for cols_a, cols_b in staged_mirror_groups(n_fft, m, (n1, n2)):
        cols = cols_a + cols_b
        place = {c: l for l, c in enumerate(cols)}
        ur, ui = (v.reshape(pairs, len(cols), n1)
                  for v in _stockham(*(h[:, :, list(cols)].transpose(1, 2).reshape(-1, n1)
                                       for h in (hr, hi)), fft_plan(n1), tw1))
        ks, at, mirrors, at_m = [], [], [], []
        for p1 in range((n_fft // 2) // n2 + 1):
            for l, p2 in enumerate(cols):
                k = p1 * n2 + p2
                if k > n_fft // 2:
                    continue
                ks.append(k)
                at.append((l, p1))
                mirrors.append(0 if k == 0 else n_fft - k)
                at_m.append((l, 0) if k == 0 else
                            (place[(r - p2) % n2], q - p1 if p2 <= r else q - p1 - 1))
        (lk, pk), (lm, pm) = (torch.tensor(v, device=padded.device).T for v in (at, at_m))
        ck, cm = a[ks], a[mirrors]
        zr = ck[:, 0] * ur[:, lk, pk] + ck[:, 1] * ui[:, lk, pk]
        zi = ck[:, 1] * ur[:, lk, pk] - ck[:, 0] * ui[:, lk, pk]
        yr = cm[:, 0] * ur[:, lm, pm] + cm[:, 1] * ui[:, lm, pm]
        yi = cm[:, 1] * ur[:, lm, pm] - cm[:, 0] * ui[:, lm, pm]
        out[:, 0, ks], out[:, 1, ks] = _pair_magnitudes(zr, zi, yr, yi)
    return out.reshape(-1, n_bins)[:_frames_count(padded.shape[0], n_fft, hop)]


# exchange layouts a + ((a >> s) << g); (0, 0) leaves a as it is
_PADS = ((0, 0), *((s, g) for s in range(2, 9) for g in range(s - 1)))


def _pad_address(addr: np.ndarray, pad: tuple[int, int]) -> np.ndarray:
    s, g = pad
    return addr + ((addr >> s) << g) if s else addr


def _wavefronts(addr: np.ndarray) -> int:
    """Shared-memory wavefronts of warp-wide 8-byte accesses, one row of 32
    lane addresses (float2 units, -1 for an idle lane) per instruction: each
    half-warp takes as many as the most distinct addresses that share a
    bank pair (address mod 16); a repeated address is one broadcast."""
    halves = np.sort(addr.reshape(-1, 16), axis=1)
    first = np.ones_like(halves, dtype=bool)
    first[:, 1:] = halves[:, 1:] != halves[:, :-1]
    keep = first & (halves >= 0)
    counts = np.zeros((halves.shape[0], 16), dtype=np.int64)
    np.add.at(counts, (np.nonzero(keep)[0], halves[keep] % 16), 1)
    return int(counts.max(axis=1).sum())


def _exchange_accesses(n_fft: int, plan: tuple[int, ...]) -> list[tuple[np.ndarray, np.ndarray]]:
    """For each pass of `plan`: (its writes, the reads of the buffer it
    writes by the next pass or the untangle), as rows of 32 lane addresses,
    -1 for an idle lane. Lane l takes butterflies (and bins) l, l + 32, ..."""
    def rows(count):
        idx = np.arange(-(-count // 32) * 32).reshape(-1, 32)
        return idx, idx >= count

    passes, ns = [], 1
    for radix in plan:
        nb = n_fft // radix
        j, idle = rows(nb)
        r = np.arange(radix)[None, :, None]
        reads = np.where(idle[:, None, :], -1, j[:, None, :] + r * nb)
        writes = np.where(idle[:, None, :], -1, (j // ns * ns * radix + j % ns)[:, None, :] + r * ns)
        passes.append((reads.reshape(-1, 32), writes.reshape(-1, 32)))
        ns *= radix
    k, idle = rows(n_fft // 2 + 1)
    untangle = np.concatenate([np.where(idle, -1, k), np.where(idle, -1, (n_fft - k) % n_fft)])
    nexts = [reads for reads, _ in passes[1:]] + [untangle]
    return [(writes, nxt) for (_, writes), nxt in zip(passes, nexts)]


@lru_cache(maxsize=None)
def exchange_pads(n_fft: int, plan: tuple[int, ...] | None = None) -> tuple[tuple[int, int], ...]:
    """For each pass of `plan` (default fft_plan(n_fft)), the layout (s, g)
    of the exchange buffer it writes, a complex value z[a] at
    a + ((a >> s) << g) ((0, 0): at a): of _PADS the one of fewest
    wavefronts over that pass's writes and the next reads
    (`_exchange_accesses`), the least padding on a tie."""
    def cost(accesses, pad):
        return sum(_wavefronts(np.where(a >= 0, _pad_address(a, pad), -1)) for a in accesses)

    return tuple(
        min(_PADS, key=lambda pad: (cost(acc, pad), (n_fft >> pad[0]) << pad[1] if pad[0] else 0))
        for acc in _exchange_accesses(n_fft, plan or fft_plan(n_fft)))


def pack_plan(plan: tuple[int, ...], pads: tuple[tuple[int, int], ...]):
    """A plan as the mixed kernel takes it, int32 on the host:
    [P, R_1..R_P, s_1..s_P, g_1..g_P] (radices, then exchange layouts)."""
    values = (len(plan), *plan, *(s for s, _ in pads), *(g for _, g in pads))
    return (ctypes.c_int * len(values))(*values)


@lru_cache(maxsize=None)
def _plan_array(n: int):
    """fft_plan(n) with exchange_pads(n), packed (pack_plan)."""
    return pack_plan(fft_plan(n), exchange_pads(n))


@lru_cache(maxsize=None)
def pass_roots(n: int, plan: tuple[int, ...]) -> np.ndarray:
    """The roots of unity of an n-point FFT in the order csrc/dft_mixed.cu's
    passes read them: for each pass p > 0 of radix R, Ns the product of the
    earlier radices, tw[r * jm * n / (Ns*R)] at [r - 1][jm], r = 1..R-1,
    jm < Ns (tw = roots_of_unity(n)); (sum of (R-1) Ns, 2) float32, one
    unread row for a one-pass plan. Read-only."""
    tw, parts, ns = roots_of_unity(n), [], plan[0]
    for radix in plan[1:]:
        r, jm = np.arange(1, radix)[:, None], np.arange(ns)[None, :]
        parts.append(tw[(r * jm * (n // (ns * radix))).reshape(-1)])
        ns *= radix
    table = np.concatenate(parts) if parts else np.zeros((1, 2), np.float32)
    table.setflags(write=False)
    return table


def twiddle_split(n: int) -> int:
    """s of the split S = 2^s of csrc/dft_cluster.cu's four-step twiddles
    at n points (dft_cluster_plan.cuh::twiddle_split): the least s with
    4^s >= n."""
    return next(s for s in range(32) if 4 ** s >= n)


@lru_cache(maxsize=None)
def twiddle_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The two tables of float64 roots whose products are csrc/dft_cluster.cu's
    four-step twiddles W_n^m: lo[l] = W_n^l for l < S and hi[h] = W_n^(h S)
    for h < ceil(n / S), S = 2^twiddle_split(n), each (.., 2) float64 (re,
    im) as roots_of_unity computes them before its rounding. Read-only."""
    s = 1 << twiddle_split(n)
    tables = []
    for m in (np.arange(s), np.arange(-(-n // s)) * s):
        ang = 2.0 * np.pi * m / n
        table = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
        table.setflags(write=False)
        tables.append(table)
    return tables[0], tables[1]


def product_twiddles(n: int, m: np.ndarray) -> np.ndarray:
    """W_n^m for integers 0 <= m < n as csrc/dft_cluster.cu computes them:
    hi[m // S] * lo[m % S] of twiddle_tables(n) in float64 without a fused
    multiply-add, rounded once to float32; (*m.shape, 2)."""
    lo, hi = twiddle_tables(n)
    a, b = hi[m >> twiddle_split(n)], lo[m & ((1 << twiddle_split(n)) - 1)]
    return np.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                     a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]], axis=-1).astype(np.float32)


@lru_cache(maxsize=None)
def cluster_tables(n: int, split: tuple[int, int] | None = None) -> np.ndarray:
    """csrc/dft_cluster.cu's roots for an n-point FFT split as cluster_plan(n)
    (or as `split`, N1 x N2): pass_roots of fft_plan(N1), pass_roots of
    fft_plan(N2), a zero row where their count is odd, then lo and hi of
    twiddle_tables(n) with each float64 (re, im) pair as four float32
    words, as the kernel copies them to shared memory; (rows, 2) float32.
    Read-only."""
    n1, n2 = split or cluster_plan(n)[:2]
    roots = [pass_roots(n1, fft_plan(n1)), pass_roots(n2, fft_plan(n2))]
    if (len(roots[0]) + len(roots[1])) % 2:
        roots.append(np.zeros((1, 2), np.float32))
    words = [t.view(np.float32).reshape(-1, 2) for t in twiddle_tables(n)]
    table = np.concatenate([*roots, *words])
    table.setflags(write=False)
    return table


@lru_cache(maxsize=None)
def _cluster_plan_array(n: int):
    """cluster_plan(n) as csrc/dft_cluster.cu takes it, int32 on the host:
    [C, N1, N2, len1, len2, P1, radices of N1, P2, radices of N2], len1 and
    len2 the rows of the two pass_roots in cluster_tables(n)."""
    n1, n2, ranks = cluster_plan(n)
    plan1, plan2 = fft_plan(n1), fft_plan(n2)
    values = (ranks, n1, n2, len(pass_roots(n1, plan1)), len(pass_roots(n2, plan2)),
              len(plan1), *plan1, len(plan2), *plan2)
    return (ctypes.c_int * len(values))(*values)


@lru_cache(maxsize=None)
def staged_tables(n: int, split: tuple[int, int] | None = None) -> np.ndarray:
    """csrc/dft_staged.cu's roots for an n-point FFT split as staged_plan(n,
    split), in either mode: pass_roots of fft_plan(N1) and of fft_plan(N2),
    read from device memory through L1, a zero row where their count is
    odd, then the two float64 tables of twiddle_tables(n) as cluster_tables
    lays them out, whose products are the four-step twiddles
    (product_twiddles; a compiled kernel 1, and the chirp mode's kernel 2
    where they fit, copy them to shared memory). Read-only."""
    return cluster_tables(n, staged_plan(n, split)[:2])


@lru_cache(maxsize=None)
def _staged_plan_array(n: int, split: tuple[int, int] | None = None, chirp_n: int | None = None,
                       batches: tuple[int, int, int] | None = None):
    """staged_plan(n, split) as csrc/dft_staged.cu takes it, int32 on the
    host: [N1, N2, G1, G2, len1, len2, P1, radices of N1, P2, radices of
    N2], len1 and len2 the rows of the two pass_roots in staged_tables; in
    the chirp mode at n_fft chirp_n (n the convolution length) then [G3, f]
    of staged_fold(chirp_n, n, split). `batches` (G1, G2, G3) takes those
    batches instead, for the tools."""
    n1, n2, g1, g2 = staged_plan(n, split)
    plan1, plan2 = fft_plan(n1), fft_plan(n2)
    fold = staged_fold(chirp_n, n, split)[:2] if chirp_n else ()
    if batches:
        g1, g2 = batches[:2]
        fold = (batches[2], *fold[1:]) if chirp_n else ()
    values = (n1, n2, g1, g2, len(pass_roots(n1, plan1)), len(pass_roots(n2, plan2)),
              len(plan1), *plan1, len(plan2), *plan2, *fold)
    return (ctypes.c_int * len(values))(*values)


def _chirp_kernel(n_fft: int) -> str:
    """The kernel of the chirp mode at n_fft: "mixed" (the block layout of
    csrc/dft_mixed.cu) where chirp_length(n_fft) is within MIXED_MAX,
    "cluster" (csrc/dft_cluster.cu) above it. On the block layout an M of
    4096 or 8192 (2038, 4078; `block_compiled`) runs a kernel compiled
    whole, three frame pairs in flight on an SM at 4096: its first pass
    reads and sums only the nonzero half of its zero-padded input, the
    product with B stays in registers between the two FFTs where their
    first and last radix agree, and the second FFT's last pass writes only
    the outputs below M/2 that the untangle reads (`_chirp_reference`
    computes every value; the values the kernel keeps are the same). Any
    other M (470's 952) runs the generic block kernel."""
    return "mixed" if chirp_length(n_fft) <= MIXED_MAX else "cluster"


@lru_cache(maxsize=None)
def _route_tables(route: str, window_bytes: bytes, device: torch.device):
    """A route's two tables for this window as tensors on `device`, uploaded
    once and kept: the FFT route's window and roots of unity (fft_tables),
    the mixed route's window and pass-ordered roots (pass_roots), the
    cluster route's window and cluster_tables, the chirp route's
    chirp_tables and the roots of its M (pass_roots, or cluster_tables above
    MIXED_MAX), the staged route's window (its chirp mode: chirp_tables)
    and staged_tables of its FFT, the GEMM route's window-folded C and S
    (windowed_dft_mats, 4 N (N/2 + 1) bytes, which is why the route takes
    no size a user sets: 6.7 GB at 40962, 2.2 TB above STAGED_MAX)."""
    n_fft = len(window_bytes) // 8
    if route == "gemm":
        arrays = _mats_cached(window_bytes)
    elif route == "fft":
        arrays = _tables_cached(window_bytes)
    elif route == "mixed":
        arrays = (_tables_cached(window_bytes)[0], pass_roots(n_fft, fft_plan(n_fft)))
    elif route == "cluster":
        arrays = (_tables_cached(window_bytes)[0], cluster_tables(n_fft))
    elif route == "staged" and staged_mode(n_fft) == "fft":
        arrays = (_tables_cached(window_bytes)[0], staged_tables(n_fft))
    elif route == "staged":
        m = chirp_length(n_fft)
        arrays = (_chirp_cached(window_bytes, m), staged_tables(m))
    else:
        m = chirp_length(n_fft)
        roots = pass_roots(m, fft_plan(m)) if m <= MIXED_MAX else cluster_tables(m)
        arrays = (_chirp_cached(window_bytes, m), roots)
    return tuple(torch.from_numpy(a.copy()).to(device) for a in arrays)


def _build_variant(kernel: str, n: int, dtype: torch.dtype,
                   split: tuple[int, int] | None = None) -> tuple[int, int | None] | None:
    """The build of a kernel's library (ops/_build.py::VARIANTS) that runs
    an FFT of n points on `dtype` samples: (of the builds' odd radices the
    least at or above the largest odd radix of its plan, fft_plan(n) for
    "mixed", cluster_plan(n)'s two sides for "cluster", staged_plan(n,
    split)'s for "staged"; the dtype's code, None for "staged", whose builds
    take every sample type); None for the kernels built once."""
    if kernel == "mixed":
        radices = fft_plan(n)
    elif kernel in ("cluster", "staged"):
        n1, n2 = cluster_plan(n)[:2] if kernel == "cluster" else staged_plan(n, split)[:2]
        radices = fft_plan(n1) + fft_plan(n2)
    else:
        return None
    odd = max(r for r in (1, *radices) if r % 2)
    builds = sorted({r for r, _ in _build.VARIANTS[f"dft_{kernel}"]})
    return next(r for r in builds if r >= odd), None if kernel == "staged" else _DTYPE_CODES[dtype]


@lru_cache(maxsize=None)
def _kernel(kernel: str, variant: tuple[int, int | None] | None = None):
    """The C entry point of a kernel's library (its build for `variant`,
    _build_variant), returning a CUDA error code.
    "fft" and "gemm": (audio, dtype, table_a, table_b, out, n_frames, n_fft,
    hop, stream), the FFT route's tables the window and the roots of unity,
    the GEMM route's the window-folded C and S. "mixed" (csrc/dft_mixed.cu)
    and "cluster" (csrc/dft_cluster.cu), each in an FFT and a chirp mode:
    (audio, dtype, window, roots, chirp, plan, out, n_frames, n_fft, hop,
    stream), roots from pass_roots (mixed) or cluster_tables (cluster), chirp
    from chirp_tables (null in the FFT mode, whose plan is of n_fft; the
    chirp mode's is of chirp_length(n_fft) and its window is not read), plan
    from _plan_array or _cluster_plan_array. "staged" (csrc/dft_staged.cu)
    the same with, after the plan (_staged_plan_array), its scratch and the
    frame pairs of a chunk, and last a pointer to the count of kernels it
    launched: (..., plan, scratch, chunk_pairs, out, ..., stream, launched).
    "point" (csrc/dft_point.cu): (audio, dtype, w[0] as float32, out,
    n_frames, stream)."""
    lib, name = {"fft": ("dft_magnitude", "orcai_dft_magnitude"),
                 "mixed": ("dft_mixed", "orcai_dft_mixed"),
                 "cluster": ("dft_cluster", "orcai_dft_cluster"),
                 "staged": ("dft_staged", "orcai_dft_staged"),
                 "point": ("dft_point", "orcai_dft_point"),
                 "gemm": ("dft_gemm", "orcai_dft_gemm")}[kernel]
    return _bind(kernel, getattr(_build.load(lib, variant), name))


def _bind(kernel: str, fn):
    """fn, the C entry point of `kernel` (_kernel), with its argument and
    return types set."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if kernel == "point":
        fn.argtypes = [ptr, i32, ctypes.c_float, ptr, ctypes.c_longlong, ptr]
        fn.restype = i32
        return fn
    chirp = [ptr, ctypes.POINTER(ctypes.c_int)] if kernel in ("mixed", "cluster", "staged") else []
    scratch = [ptr, i32] if kernel == "staged" else []
    launched = [ctypes.POINTER(i32)] if kernel == "staged" else []
    fn.argtypes = [ptr, i32, ptr, ptr, *chirp, *scratch, ptr, i32, i32, i32, ptr, *launched]
    fn.restype = ctypes.c_int
    return fn


def dft_route(n_fft: int) -> str:
    """The CUDA route of an n_fft: "fft" for FFT_SIZES; "mixed" for any
    other n_fft from 2 to MIXED_MAX (8192) whose prime factors are in
    MIXED_PRIMES (1216 = 2^6 * 19, 1472 = 2^6 * 23, 1856 = 2^6 * 29, 1984 =
    2^6 * 31); "cluster" for an n_fft from MIXED_MAX + 1 to CLUSTER_MAX
    (81920; 65536 on 8 CTAs) whose prime factors are in CLUSTER_PRIMES;
    "chirp" for an n_fft from 2 to CHIRP_MAX (40960) with a prime factor
    above 31 (16418 and 24578 on the cluster layout); "staged" for any other
    n_fft from MIXED_MAX + 1 to STAGED_MAX (2^20; staged_mode: 14848 = 2^9
    * 29, 98304 and 131072 in its FFT mode, 40962 in its chirp mode);
    "point" for n_fft 1. Raises above STAGED_MAX, where the GEMM's tables
    (4 N (N/2 + 1) bytes) would be all that is left and no card holds
    them."""
    if n_fft in FFT_SIZES:
        return "fft"
    if 2 <= n_fft <= MIXED_MAX and _smooth(n_fft):
        return "mixed"
    if MIXED_MAX < n_fft <= CLUSTER_MAX and _smooth(n_fft, CLUSTER_PRIMES):
        return "cluster"
    if 2 <= n_fft <= CHIRP_MAX and not (n_fft > MIXED_MAX and _smooth(n_fft)):
        return "chirp"
    if n_fft > STAGED_MAX:
        raise ValueError(f"n_fft {n_fft}: above {STAGED_MAX} only the GEMM route is left, whose "
                         f"tables take {4 * n_fft * (n_fft // 2 + 1) / 1e12:.1f} TB; no card "
                         "holds them")
    return "staged" if MIXED_MAX < n_fft else "point"


def active_clusters(n_fft: int, dtype: torch.dtype = torch.int16) -> int:
    """How many thread block clusters of csrc/dft_cluster.cu's kernel at
    n_fft (the cluster route, or the chirp mode on the cluster layout) the
    current CUDA device holds at once: cudaOccupancyMaxActiveClusters for
    clusters of cluster_plan's C CTAs, the size of the kernel's persistent
    grid in clusters (cluster_layout's "clusters"). Raises where a launch
    would fail (none fits)."""
    return cluster_layout(n_fft, n_fft, dtype)["clusters"]


def cluster_layout(n_fft: int, hop: int, dtype: torch.dtype = torch.int16,
                   library: ctypes.CDLL | None = None) -> dict:
    """What csrc/dft_cluster.cu launches at n_fft / hop on `dtype` samples
    (the cluster route, or the chirp mode on the cluster layout) on the
    current CUDA device: CTAs a cluster, threads a CTA, CTAs resident on an
    SM, clusters resident on the card (its persistent grid), dynamic shared
    memory a CTA, registers and local (spilled) memory a thread, and whether
    its plan runs a kernel compiled whole. `library` asks another build of
    the source (a tool's) in place of ops/_build's. Launches nothing; raises
    where a launch would fail."""
    route = dft_route(n_fft)
    chirp = route == "chirp" and _chirp_kernel(n_fft) == "cluster"
    if route != "cluster" and not chirp:
        raise ValueError(f"n_fft {n_fft} does not take the cluster layout")
    n = chirp_length(n_fft) if chirp else n_fft
    fn = (library or _build.load("dft_cluster", _build_variant("cluster", n, dtype))
          ).orcai_dft_cluster_layout
    i32 = ctypes.c_int
    fn.argtypes = [i32, ctypes.POINTER(i32), i32, i32, i32, ctypes.POINTER(i32)]
    fn.restype = i32
    info = (i32 * 8)()
    plan = _cluster_plan_array(n)
    err = fn(_DTYPE_CODES[dtype], plan, n_fft, hop, int(chirp), info)
    if err != 0:
        raise RuntimeError(f"dft_magnitude at n_fft {n_fft}: no cluster of {plan[0]} CTAs "
                           f"fits (CUDA error {err})")
    ranks, threads, ctas, clusters, smem, registers, local, compiled = info
    return {"ranks": ranks, "threads": threads, "ctas_per_sm": ctas, "clusters": clusters,
            "smem_bytes": smem, "registers": registers, "local_bytes": local,
            "compiled": bool(compiled)}


STAGED_KERNELS = {"fft": ("columns", "rows"), "chirp": ("columns", "rows", "columns_untangle")}


def staged_layout(n_fft: int, dtype: torch.dtype = torch.int16,
                  library: ctypes.CDLL | None = None) -> dict:
    """What csrc/dft_staged.cu launches at n_fft on `dtype` samples on the
    current CUDA device (its FFT mode, or its chirp mode on chirp_length):
    for each of the mode's kernels (STAGED_KERNELS) threads a CTA, CTAs
    resident on an SM, dynamic shared memory a CTA, registers and local
    (spilled) memory a thread, and whether it is compiled whole. `library`
    asks another build of the source (a tool's) in place of ops/_build's.
    Launches nothing; raises where a launch would fail."""
    if dft_route(n_fft) != "staged":
        raise ValueError(f"n_fft {n_fft} does not take the staged route")
    mode = staged_mode(n_fft)
    n = n_fft if mode == "fft" else chirp_length(n_fft)
    fn = (library or _build.load("dft_staged", _build_variant("staged", n, dtype))
          ).orcai_dft_staged_layout
    i32 = ctypes.c_int
    fn.argtypes = [i32, ctypes.POINTER(i32), i32, i32, ctypes.POINTER(i32)]
    fn.restype = i32
    info = (i32 * 18)()
    err = fn(_DTYPE_CODES[dtype], _staged_plan_array(n, None, n_fft if mode == "chirp" else None),
             n_fft, int(mode == "chirp"), info)
    if err != 0:
        raise RuntimeError(f"dft_magnitude at n_fft {n_fft}: the staged kernels do not launch "
                           f"(CUDA error {err})")
    keys = ("threads", "ctas_per_sm", "smem_bytes", "registers", "local_bytes", "compiled")
    return {"mode": mode, **{name: {k: (bool(v) if k == "compiled" else v)
                                    for k, v in zip(keys, info[6 * i:6 * i + 6])}
                             for i, name in enumerate(STAGED_KERNELS[mode])}}


MIXED_LAYOUTS = ("warp", "block", "compiled")  # csrc/dft_mixed.cu's layouts, by the code it reports
# csrc/dft_mixed.cu's BLOCK_COMPILED, the block layout's plans compiled
# whole: (the FFT's size, n_fft or the chirp mode's M; the chirp mode) ->
# (threads of a group, which owns a frame pair; groups a block)
MIXED_BLOCK_COMPILED = {(4096, False): (256, 3), (4096, True): (256, 3),
                        (8192, False): (512, 1), (8192, True): (512, 1)}


def block_compiled(n_fft: int) -> tuple[int, int] | None:
    """(threads a group, groups a block) where csrc/dft_mixed.cu's block
    layout runs n_fft on a plan compiled whole: its FFT, n_fft on the mixed
    route or chirp_length(n_fft) in the chirp mode, of a power of two above
    the warp layout's reach (MIXED_BLOCK_COMPILED: 4096 and 8192; 2038 on
    M = 4096, 4078 on 8192); None for any other n_fft."""
    route = dft_route(n_fft)
    if route == "chirp" and _chirp_kernel(n_fft) == "mixed":
        return MIXED_BLOCK_COMPILED.get((chirp_length(n_fft), True))
    return MIXED_BLOCK_COMPILED.get((n_fft, False)) if route == "mixed" else None


def mixed_layout(n_fft: int, hop: int, dtype: torch.dtype = torch.int16,
                 library: ctypes.CDLL | None = None) -> dict:
    """What csrc/dft_mixed.cu launches at n_fft / hop on `dtype` samples (the
    mixed route, the chirp mode where it runs on the block layout, or
    FFT_SIZES, where the FFT route runs and the kernel is called directly) on the
    current CUDA device: its layout (MIXED_LAYOUTS), threads a block, blocks
    resident on an SM and the warps they make, frame pairs in flight on an
    SM (a warp's each in the warp and compiled layouts; in the block layout
    one a block, or one a group of a block compiled whole), whether its plan
    is compiled whole (the compiled layout; the block layout at
    block_compiled's sizes), frames a group, dynamic shared memory a block,
    registers and local (spilled) memory a thread. `library` asks another
    build of the source (a tool's) in place of ops/_build's. Launches
    nothing; raises where a launch would fail."""
    route = dft_route(n_fft)
    chirp = route == "chirp" and _chirp_kernel(n_fft) == "mixed"
    if route not in ("mixed", "fft") and not chirp:  # FFT_SIZES: the kernel called directly
        raise ValueError(f"n_fft {n_fft} does not take csrc/dft_mixed.cu")
    n = chirp_length(n_fft) if chirp else n_fft
    fn = (library or _build.load("dft_mixed", _build_variant("mixed", n, dtype))
          ).orcai_dft_mixed_layout
    i32 = ctypes.c_int
    fn.argtypes = [i32, ctypes.POINTER(i32), i32, i32, i32, ctypes.POINTER(i32)]
    fn.restype = i32
    info = (i32 * 9)()
    err = fn(_DTYPE_CODES[dtype], _plan_array(n), n_fft, hop, int(chirp), info)
    if err != 0:
        raise RuntimeError(f"dft_magnitude at n_fft {n_fft}: no layout of csrc/dft_mixed.cu "
                           f"launches (CUDA error {err})")
    layout, threads, blocks, frames, smem, registers, local, pairs, compiled = info
    return {"layout": MIXED_LAYOUTS[layout], "threads": threads, "blocks_per_sm": blocks,
            "resident_warps": blocks * threads // 32, "pairs_per_sm": pairs,
            "compiled": bool(compiled), "group_frames": frames, "smem_bytes": smem,
            "registers": registers, "local_bytes": local}


def _launch_staged(padded: torch.Tensor, window: np.ndarray, out: torch.Tensor, n_fft: int,
                   hop: int, *, m: int | None = None, split: tuple[int, int] | None = None,
                   chunk_pairs: int | None = None,
                   batches: tuple[int, int, int] | None = None,
                   library: ctypes.CDLL | None = None) -> int:
    """csrc/dft_staged.cu's kernels on the CUDA tensor `padded` into `out`,
    on the current stream: the FFT mode at staged_mode(n_fft) "fft", else
    (or with a convolution length m given) the chirp mode on M = m or
    chirp_length(n_fft); split (N1, N2) of staged_plan, chunk_pairs frame
    pairs a chunk (staged_chunk_pairs), batches (G1, G2, G3) in place of
    the plan's (_staged_plan_array); `library` another build of the source
    (a tool's) in place of ops/_build's. The scratch, chunk_pairs FFTs of M
    complex values, comes from the caching allocator on the audio's device.
    Returns the CUDA error code; counts no call (dft_magnitude counts its
    calls), so a tool can call it beside the route. `_launch_staged.kernels`
    holds the kernels the last call launched: 2 a chunk in the FFT mode, 3
    in the chirp mode."""
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    chirp = m is not None or staged_mode(n_fft) == "chirp"
    n = (m or chirp_length(n_fft)) if chirp else n_fft
    window = _check_window(window, n_fft)
    if split is None and (m is None or m == chirp_length(n_fft)):
        table, roots = _route_tables("staged", window.tobytes(), padded.device)
    else:
        table = torch.from_numpy(
            (chirp_tables(window, n) if chirp else fft_tables(window)[0]).copy()).to(padded.device)
        roots = torch.from_numpy(staged_tables(n, split).copy()).to(padded.device)
    pairs = max(1, min(chunk_pairs or staged_chunk_pairs(n), (tpad + 1) // 2))
    scratch = torch.empty(pairs * n * 2, dtype=torch.float32, device=padded.device)
    tables = ((None, roots.data_ptr(), table.data_ptr()) if chirp
              else (table.data_ptr(), roots.data_ptr(), None))
    launched = ctypes.c_int(0)
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        fn = (_bind("staged", library.orcai_dft_staged) if library is not None
              else _kernel("staged", _build_variant("staged", n, padded.dtype, split)))
        err = fn(
            padded.data_ptr(), _DTYPE_CODES[padded.dtype], *tables,
            _staged_plan_array(n, split, n_fft if chirp else None, batches), scratch.data_ptr(),
            pairs, out.data_ptr(), tpad, n_fft, hop, stream, ctypes.byref(launched))
    _launch_staged.kernels = launched.value
    return err


_launch_staged.kernels = 0


def dft_magnitude(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int
) -> torch.Tensor:
    """(Npad,) padded audio -> (T, n_fft//2 + 1) windowed |DFT|, float32.

    `padded` holds (T - 1) * hop + n_fft samples, float32, int16 (scaled
    to [-1, 1]) or uint8 mu-law codes; `window` is the (n_fft,) float64
    analysis window on the host; hop must divide n_fft. A CUDA tensor goes
    to the kernel of dft_route(n_fft); a CPU tensor goes to
    dft_magnitude_plain. Anything else raises.
    """
    if padded.device.type == "cpu":
        return dft_magnitude_plain(padded, window, n_fft=n_fft, hop=hop)
    window = _check_window(window, n_fft)
    if padded.dim() != 1 or padded.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"dft_magnitude: audio must be 1-D float32, int16 or uint8, got "
            f"{tuple(padded.shape)} {padded.dtype}"
        )
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    route = kernel = dft_route(n_fft)
    if not padded.is_contiguous():
        raise ValueError("dft_magnitude: audio must be contiguous")
    if padded.device.type != "cuda":
        raise ValueError(f"dft_magnitude: unsupported device {padded.device}")
    out = torch.empty((tpad, n_fft // 2 + 1), dtype=torch.float32, device=padded.device)
    if route == "point":
        with torch.cuda.device(padded.device):
            err = _kernel("point")(padded.data_ptr(), _DTYPE_CODES[padded.dtype],
                                   float(np.float32(window[0])), out.data_ptr(), tpad,
                                   torch.cuda.current_stream(padded.device).cuda_stream)
    elif route == "staged":
        err = _launch_staged(padded, window, out, n_fft, hop)
        dft_magnitude.staged_kernels[staged_mode(n_fft)] += _launch_staged.kernels
    else:
        a, b = _route_tables(route, window.tobytes(), padded.device)
        n = n_fft  # the FFT's points: n_fft, or the chirp mode's convolution length
        if route == "mixed":
            tables = (a.data_ptr(), b.data_ptr(), None, _plan_array(n_fft))
        elif route == "cluster":
            tables = (a.data_ptr(), b.data_ptr(), None, _cluster_plan_array(n_fft))
        elif route == "chirp":
            kernel, n = _chirp_kernel(n_fft), chirp_length(n_fft)
            plan = _plan_array(n) if kernel == "mixed" else _cluster_plan_array(n)
            tables = (None, b.data_ptr(), a.data_ptr(), plan)
        else:
            tables = (a.data_ptr(), b.data_ptr())
        with torch.cuda.device(padded.device):
            stream = torch.cuda.current_stream(padded.device).cuda_stream
            err = _kernel(kernel, _build_variant(kernel, n, padded.dtype))(
                padded.data_ptr(), _DTYPE_CODES[padded.dtype], *tables, out.data_ptr(), tpad,
                n_fft, hop, stream,
            )
    if err != 0:
        raise RuntimeError(
            f"dft_magnitude ({route} route) kernel launch failed: CUDA error {err}")
    dft_magnitude.launches += 1
    dft_magnitude.route_launches[route] += 1
    return out


dft_magnitude.launches = 0
dft_magnitude.route_launches = dict.fromkeys(ROUTES, 0)
# the staged route's calls each launch its kernels chunk by chunk: their
# count by mode (2 a chunk in the FFT mode, 3 in the chirp mode)
dft_magnitude.staged_kernels = {"fft": 0, "chirp": 0}
