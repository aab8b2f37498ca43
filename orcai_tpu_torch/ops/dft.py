"""Windowed rDFT magnitude of hop-framed audio (kernel B1).

Counterpart of orcai_tpu/ops/pallas_dft.py. The function is
|rDFT(window * frame)| of every frame of float32, int16 (scaled by 1/32768)
or uint8 mu-law audio (the mulaw8 wire's codes, decoded as
ops/wire_codec.py::mulaw_decode_f32 does), at any n_fft that hop divides.

`dft_magnitude` takes one of two CUDA routes for a CUDA tensor and runs the
plain PyTorch version, `dft_magnitude_plain`, for a CPU tensor:

- the FFT route, csrc/dft_magnitude.cu, at n_fft in FFT_SIZES (512, the
  reference geometry): a batched FFT in shared memory, two real frames on
  one 512-point complex FFT (three radix-8 Stockham passes), untangled
  afterwards. `_fft_pairs_reference` is that arithmetic step by step in
  PyTorch, with the kernel's tables (`fft_tables`) and index maps, so the
  algorithm is testable where no card is;
- the GEMM route, csrc/dft_gemm.cu, at every other n_fft (the spectral
  wires' 384 and 352 among them): the reference's own algorithm, a tiled
  IEEE fp32 GEMM of the frames, read straight from the audio, with the
  window-folded cos/sin matrices (`windowed_dft_mats`).

The plain version computes the reference's GEMM with torch.matmul.
`dft_magnitude.launches` counts every kernel launch and
`dft_magnitude.route_launches` splits them by route.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from orcai_tpu_torch.ops import _build
from orcai_tpu_torch.ops.wire_codec import mulaw_decode_f32

FFT_SIZES = (512,)  # the sizes csrc/dft_magnitude.cu is instantiated for
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
def _tables_cached(window_bytes: bytes) -> tuple[np.ndarray, np.ndarray]:
    w = np.frombuffer(window_bytes, dtype=np.float64)
    n_fft = w.shape[0]
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    win = w.astype(np.float32)
    tw.setflags(write=False)
    win.setflags(write=False)
    return win, tw


def fft_tables(window: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's tables: the window (n_fft,) and the roots of unity
    tw[m] = (cos, -sin)(2 pi m / n_fft), (n_fft, 2), both computed in
    float64 and rounded once to float32. Read-only."""
    return _tables_cached(np.asarray(window, dtype=np.float64).tobytes())


@lru_cache(maxsize=None)
def _tables_on_device(window_bytes: bytes, device: torch.device):
    """The FFT kernel's tables for this window as tensors on `device`,
    uploaded once (6 KB for n_fft 512) and kept."""
    return tuple(torch.from_numpy(a.copy()).to(device) for a in _tables_cached(window_bytes))


@lru_cache(maxsize=None)
def _mats_on_device(window_bytes: bytes, device: torch.device):
    """The GEMM kernel's window-folded C, S for this window on `device`,
    uploaded once (0.6 MB for n_fft 384) and kept."""
    return tuple(torch.from_numpy(a.copy()).to(device) for a in _mats_cached(window_bytes))


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

    def fft4(xr, xi):
        s02r, s02i = xr[0] + xr[2], xi[0] + xi[2]
        d02r, d02i = xr[0] - xr[2], xi[0] - xi[2]
        s13r, s13i = xr[1] + xr[3], xi[1] + xi[3]
        d13r, d13i = xr[1] - xr[3], xi[1] - xi[3]
        return (
            [s02r + s13r, d02r + d13i, s02r - s13r, d02r - d13i],
            [s02i + s13i, d02i - d13r, s02i - s13i, d02i + d13r],
        )

    er, ei = fft4(ar, ai)  # X[0], X[2], X[4], X[6]
    odr, odi = fft4(br, bi)  # X[1], X[3], X[5], X[7]
    out_r = [None] * 8
    out_i = [None] * 8
    for k1 in range(4):
        out_r[2 * k1], out_i[2 * k1] = er[k1], ei[k1]
        out_r[2 * k1 + 1], out_i[2 * k1 + 1] = odr[k1], odi[k1]
    return out_r, out_i


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
    frames = _to_f32(padded).unfold(0, n_fft, hop)  # (tpad, n_fft) view
    if tpad % 2:
        frames = torch.cat([frames, torch.zeros(1, n_fft)])
    zr = frames[0::2] * win
    zi = frames[1::2] * win
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
    k = torch.arange(n_fft // 2 + 1)
    mirror = (n_fft - k) % n_fft
    yr, yi = zr[:, mirror], zi[:, mirror]
    zr, zi = zr[:, k], zi[:, k]
    mag_a = 0.5 * torch.sqrt((zr + yr) ** 2 + (zi - yi) ** 2)
    mag_b = 0.5 * torch.sqrt((zi + yi) ** 2 + (zr - yr) ** 2)
    return torch.stack([mag_a, mag_b], dim=1).reshape(-1, n_fft // 2 + 1)[:tpad]


@lru_cache(maxsize=None)
def _kernel(route: str):
    """The C entry point of a route's library: (audio, dtype, table_a,
    table_b, out, n_frames, n_fft, hop, stream) -> CUDA error code. The FFT
    route's tables are the window and the roots of unity, the GEMM route's
    the window-folded C and S."""
    lib, name = {"fft": ("dft_magnitude", "orcai_dft_magnitude"),
                 "gemm": ("dft_gemm", "orcai_dft_gemm")}[route]
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def dft_route(n_fft: int) -> str:
    """The CUDA route of an n_fft: "fft" for FFT_SIZES, "gemm" otherwise."""
    return "fft" if n_fft in FFT_SIZES else "gemm"


def dft_magnitude(
    padded: torch.Tensor, window: np.ndarray, *, n_fft: int, hop: int
) -> torch.Tensor:
    """(Npad,) padded audio -> (T, n_fft//2 + 1) windowed |DFT|, float32.

    `padded` holds (T - 1) * hop + n_fft samples, float32, int16 (scaled
    to [-1, 1]) or uint8 mu-law codes; `window` is the (n_fft,) float64
    analysis window on the host; hop must divide n_fft. A CUDA tensor goes
    to the FFT kernel at n_fft in FFT_SIZES and to the GEMM kernel at any
    other n_fft; a CPU tensor goes to dft_magnitude_plain. Anything else
    raises.
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
    if not padded.is_contiguous():
        raise ValueError("dft_magnitude: audio must be contiguous")
    if padded.device.type != "cuda":
        raise ValueError(f"dft_magnitude: unsupported device {padded.device}")
    route = dft_route(n_fft)
    tables = _tables_on_device if route == "fft" else _mats_on_device
    a, b = tables(window.tobytes(), padded.device)
    out = torch.empty((tpad, n_fft // 2 + 1), dtype=torch.float32, device=padded.device)
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        err = _kernel(route)(
            padded.data_ptr(), _DTYPE_CODES[padded.dtype], a.data_ptr(),
            b.data_ptr(), out.data_ptr(), tpad, n_fft, hop, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dft_magnitude ({route} route) kernel launch failed: CUDA error {err}")
    dft_magnitude.launches += 1
    dft_magnitude.route_launches[route] += 1
    return out


dft_magnitude.launches = 0
dft_magnitude.route_launches = {"fft": 0, "gemm": 0}
