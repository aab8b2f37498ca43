"""Hann-windowed rDFT magnitude of hop-framed audio (kernel B1).

Counterpart of orcai_tpu/ops/pallas_dft.py. `dft_magnitude` launches the
CUDA kernel csrc/dft_magnitude.cu for a CUDA tensor and runs the plain
PyTorch version, `dft_magnitude_plain`, for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from orcai_tpu_torch.ops import _build


def _frames_count(n_samples: int, n_fft: int, hop: int) -> int:
    if n_fft % hop != 0:
        raise ValueError(f"hop {hop} must divide n_fft {n_fft}")
    if n_samples < n_fft or (n_samples - n_fft) % hop != 0:
        raise ValueError(
            f"padded audio of {n_samples} samples is not (T - 1) * {hop} + "
            f"{n_fft} for any frame count T"
        )
    return (n_samples - n_fft) // hop + 1


def dft_magnitude_plain(
    padded: torch.Tensor, C: torch.Tensor, S: torch.Tensor, *, n_fft: int, hop: int
) -> torch.Tensor:
    """(Npad,) padded audio -> (T, n_bins) |DFT|, as the framed GEMM.

    Frame t is padded[t*hop : t*hop + n_fft], built as the concatenation of
    n_fft/hop consecutive hop-blocks (orcai_tpu/ops/frontend.py:154-166).
    int16 input is scaled by 1/32768.
    """
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    x = padded.float() * (1.0 / 32768.0) if padded.dtype == torch.int16 else padded.float()
    x2 = x.reshape(-1, hop)
    frames = torch.cat([x2[i : i + tpad] for i in range(n_fft // hop)], dim=1)
    re = frames @ C
    im = frames @ S
    return torch.sqrt(re * re + im * im)


def _kernel():
    fn = _build.load("dft_magnitude").orcai_dft_magnitude
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def dft_magnitude(
    padded: torch.Tensor, C: torch.Tensor, S: torch.Tensor, *, n_fft: int, hop: int
) -> torch.Tensor:
    """(Npad,) padded audio -> (T, n_bins) windowed |DFT|, float32.

    `padded` holds (T - 1) * hop + n_fft samples, float32 or int16 (scaled
    to [-1, 1]); C/S are the (n_fft, n_bins) cos/sin matrices with the
    window folded in (ops/frontend.py::_dft_mats). A CUDA tensor goes to
    the kernel, a CPU tensor to dft_magnitude_plain.
    """
    if padded.device.type == "cpu":
        return dft_magnitude_plain(padded, C, S, n_fft=n_fft, hop=hop)
    if padded.device.type != "cuda":
        raise ValueError(f"dft_magnitude: unsupported device {padded.device}")
    tpad = _frames_count(padded.shape[0], n_fft, hop)
    if padded.dim() != 1 or padded.dtype not in (torch.float32, torch.int16):
        raise ValueError(
            f"dft_magnitude: audio must be 1-D float32 or int16, got "
            f"{tuple(padded.shape)} {padded.dtype}"
        )
    n_bins = C.shape[1] if C.dim() == 2 else -1
    for name, m in (("C", C), ("S", S)):
        if m.dtype != torch.float32 or tuple(m.shape) != (n_fft, n_bins):
            raise ValueError(f"dft_magnitude: {name} must be float32 ({n_fft}, n_bins)")
        if m.device != padded.device or not m.is_contiguous():
            raise ValueError(f"dft_magnitude: {name} must be contiguous on {padded.device}")
    if not padded.is_contiguous():
        raise ValueError("dft_magnitude: audio must be contiguous")
    out = torch.empty((tpad, n_bins), dtype=torch.float32, device=padded.device)
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        err = _kernel()(
            padded.data_ptr(), int(padded.dtype == torch.int16), C.data_ptr(),
            S.data_ptr(), out.data_ptr(), tpad, n_fft, hop, n_bins, stream,
        )
    if err != 0:
        raise RuntimeError(f"dft_magnitude kernel launch failed: CUDA error {err}")
    dft_magnitude.launches += 1
    return out


dft_magnitude.launches = 0
