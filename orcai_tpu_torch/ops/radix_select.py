"""Exact order statistics by radix selection on digit histograms (kernel B2).

Counterpart of orcai_tpu/ops/pallas_hist.py. Non-negative float32 bit
patterns are monotone as uint32, so the k-th smallest of n magnitudes is
found digit by digit: three histogram sweeps over 11/11/10-bit digits of
the bit patterns, each keeping only the elements whose higher digits
match the target's, pick the target's digit from a cumulative count.

`digit_histograms` launches the CUDA kernel csrc/digit_hist.cu for a CUDA
tensor and runs the plain PyTorch version, `digit_histograms_plain` (a
masked bincount), for a CPU tensor. `select_order_statistics` chains three
of them with device-side picks (cumsum, compare, sum): no .item() and no
host sync between the sweeps.
"""

from __future__ import annotations

import ctypes

import torch

from orcai_tpu_torch.ops import _build

_BLOCKS_PER_SM = 4  # 512-thread blocks with 16 KB of shared memory each


def digit_histograms_plain(
    flat: torch.Tensor,
    n_valid: torch.Tensor,
    prefixes: torch.Tensor,
    digit_shift: int,
    digit_bits: int,
    prefix_shift: int | None,
) -> torch.Tensor:
    """Masked bincount form of digit_histograms; (2, 2**digit_bits) int32."""
    n_bins = 1 << digit_bits
    nv = min(int(n_valid.reshape(-1)[0]), flat.shape[0])
    # logical shifts of the uint32 bit patterns, in int64
    bits = flat[:nv].contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    digit = (bits >> digit_shift) & (n_bins - 1)
    out = torch.zeros((2, n_bins), dtype=torch.int32, device=flat.device)
    if prefix_shift is None:
        out[0] = torch.bincount(digit, minlength=n_bins).to(torch.int32)
        return out
    prefix = bits >> prefix_shift
    p = prefixes.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    for t in range(2):
        sel = digit[prefix == p[t]]
        out[t] = torch.bincount(sel, minlength=n_bins).to(torch.int32)
    return out


def _kernel():
    fn = _build.load("digit_hist").orcai_digit_histograms
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def digit_histograms(
    flat: torch.Tensor,
    n_valid: torch.Tensor,
    prefixes: torch.Tensor,
    digit_shift: int,
    digit_bits: int,
    prefix_shift: int | None,
) -> torch.Tensor:
    """(flat f32, n_valid (1,) int32, prefixes (2,) int32) -> (2, 2**bits).

    Counts, for each of two targets t, the elements with index < n_valid
    whose float32 bit pattern satisfies (bits >> prefix_shift) ==
    prefixes[t] (only t = 0, unconditionally, when prefix_shift is None),
    binned by (bits >> digit_shift) & (2**digit_bits - 1). int32 counts.
    `flat` needs no padding; validity is bounded by n_valid alone.
    """
    if not 1 <= digit_bits <= 11:
        raise ValueError(f"digit_bits must be in 1..11, got {digit_bits}")
    if flat.device.type == "cpu":
        return digit_histograms_plain(
            flat, n_valid, prefixes, digit_shift, digit_bits, prefix_shift
        )
    if flat.device.type != "cuda":
        raise ValueError(f"digit_histograms: unsupported device {flat.device}")
    if flat.dim() != 1 or flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("digit_histograms: flat must be contiguous 1-D float32")
    for name, t, numel in (("n_valid", n_valid, 1), ("prefixes", prefixes, 2)):
        if (t.dtype != torch.int32 or t.numel() != numel
                or t.device != flat.device or not t.is_contiguous()):
            raise ValueError(
                f"digit_histograms: {name} must be {numel} contiguous int32 on "
                f"{flat.device}"
            )
    out = torch.zeros((2, 1 << digit_bits), dtype=torch.int32, device=flat.device)
    n_sm = torch.cuda.get_device_properties(flat.device).multi_processor_count
    grid = max(1, min(_BLOCKS_PER_SM * n_sm, -(-flat.shape[0] // 512)))
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = _kernel()(
            flat.data_ptr(), flat.shape[0], n_valid.data_ptr(),
            prefixes.data_ptr(), digit_shift, digit_bits,
            -1 if prefix_shift is None else prefix_shift, out.data_ptr(),
            grid, stream,
        )
    if err != 0:
        raise RuntimeError(f"digit_histograms kernel launch failed: CUDA error {err}")
    digit_histograms.launches += 1
    return out


digit_histograms.launches = 0


def _pick(hist: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The k-th order statistic's digit in one histogram, and k within it.

    Device-side, as orcai_tpu/ops/pallas_hist.py::_pick: b is the number of
    bins whose cumulative count is <= k; k drops the counts below bin b.
    """
    cum = torch.cumsum(hist.to(torch.int64), 0)
    b = (cum < k + 1).sum().reshape(1)
    prev = torch.where(
        b > 0, cum.index_select(0, (b - 1).clamp(min=0)), torch.zeros_like(b)
    )
    return b, k - prev


def select_order_statistics(
    flat: torch.Tensor,
    n_valid: torch.Tensor,
    k_lo: torch.Tensor,
    k_hi: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (k_lo-th, k_hi-th) smallest of the first n_valid float32 values.

    Values must be non-negative and finite. n_valid is a (1,) int32 tensor
    and k_lo/k_hi are (1,) int64 tensors, all on flat's device; returns two
    (1,) float32 tensors there. Three digit_histograms sweeps, 11/11/10 bits.
    """
    k_lo = k_lo.reshape(1).to(torch.int64)
    k_hi = k_hi.reshape(1).to(torch.int64)
    zeros2 = torch.zeros(2, dtype=torch.int32, device=flat.device)
    h0 = digit_histograms(flat, n_valid, zeros2, 21, 11, None)
    b_lo, k_lo = _pick(h0[0], k_lo)
    b_hi, k_hi = _pick(h0[0], k_hi)

    h1 = digit_histograms(
        flat, n_valid, torch.cat([b_lo, b_hi]).to(torch.int32), 10, 11, 21
    )
    b1_lo, k_lo = _pick(h1[0], k_lo)
    b1_hi, k_hi = _pick(h1[1], k_hi)
    p_lo = (b_lo << 11) | b1_lo
    p_hi = (b_hi << 11) | b1_hi

    h2 = digit_histograms(
        flat, n_valid, torch.cat([p_lo, p_hi]).to(torch.int32), 0, 10, 10
    )
    b2_lo, _ = _pick(h2[0], k_lo)
    b2_hi, _ = _pick(h2[1], k_hi)

    bits_lo = ((p_lo << 10) | b2_lo).to(torch.int32)
    bits_hi = ((p_hi << 10) | b2_hi).to(torch.int32)
    return bits_lo.view(torch.float32), bits_hi.view(torch.float32)


def select_order_statistics_plain(
    flat: torch.Tensor,
    n_valid: torch.Tensor,
    k_lo: torch.Tensor,
    k_hi: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same order statistics from one sort of the valid prefix."""
    nv = int(n_valid.reshape(-1)[0])
    s = torch.sort(flat[:nv]).values
    return s[k_lo.reshape(1).long()], s[k_hi.reshape(1).long()]
