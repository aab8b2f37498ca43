"""Exact order statistics by radix selection on digit histograms (kernel B2).

Counterpart of orcai_tpu/ops/pallas_hist.py. Non-negative float32 bit
patterns are monotone as uint32, so the k-th smallest of n magnitudes is
found digit by digit: three histogram sweeps over 11/11/10-bit digits of
the bit patterns, each keeping only the elements whose higher digits
match the target's, and after each sweep a pick of the target's digit
from the cumulative counts.

`digit_histograms` (a sweep), `radix_pick` (a pick; on CUDA from the
streaming path's int64 counts) and `select_levels` (a whole selection,
each level's sweep picking its own digits) launch the CUDA kernels of
csrc/digit_hist.cu for CUDA tensors and run their plain PyTorch versions
(`digit_histograms_plain`, a masked bincount; `radix_pick_plain`, cumsum,
compare and sum; `select_levels_plain`, the two level by level) for CPU
tensors. On CUDA `select_order_statistics` is one zeroing and one launch
on the stream, with no other launch, no .item() and no host sync;
`select_order_statistics_at` takes n_valid and the ranks as host
integers, which go to the kernel as values.
"""

from __future__ import annotations

import ctypes

import torch

from orcai_tpu_torch.ops import _build

# (digit_shift, digit_bits, prefix_shift) of the three sweeps
_LEVELS = ((21, 11, None), (10, 11, 21), (0, 10, 10))
_MAX_BINS = 2048
_BLOCKS_PER_SM = 4  # 512-thread blocks of the persistent histogram grid


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


def _kernel(name: str):
    lib = _build.load("digit_hist")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {
            "orcai_digit_histograms": [p, q, p, p, i, i, i, p, i, p],
            "orcai_select": [p, q, p, q, p, p, q, q, p, i, p],
            "orcai_radix_pick": [p, i, i, p, p, q, q, p, p, p, p],
        }[name]
        fn.restype = ctypes.c_int
    return fn


def _grid(flat: torch.Tensor) -> int:
    """Blocks of the persistent histogram grid for `flat`."""
    n_sm = torch.cuda.get_device_properties(flat.device).multi_processor_count
    return max(1, min(_BLOCKS_PER_SM * n_sm, -(-flat.shape[0] // 8192)))


def _launch_hist(
    flat: torch.Tensor,
    n_valid_ptr: int,
    prefixes_ptr: int,
    digit_shift: int,
    digit_bits: int,
    prefix_shift: int | None,
    out_ptr: int,
) -> None:
    """One sweep of the kernel over `flat` into zeroed counts at out_ptr."""
    with torch.cuda.device(flat.device):
        err = _kernel("orcai_digit_histograms")(
            flat.data_ptr(), flat.shape[0], n_valid_ptr, prefixes_ptr,
            digit_shift, digit_bits, -1 if prefix_shift is None else prefix_shift,
            out_ptr, _grid(flat),
            torch.cuda.current_stream(flat.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"digit_histograms kernel launch failed: CUDA error {err}")
    digit_histograms.launches += 1


def _check_cuda_flat(name: str, flat: torch.Tensor) -> None:
    if flat.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {flat.device}")
    if flat.dim() != 1 or flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError(f"{name}: flat must be contiguous 1-D float32")


def _check_small(name: str, what: str, t: torch.Tensor, dtype, numel, device) -> None:
    if t.dtype != dtype or t.numel() != numel or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be {numel} contiguous {dtype} on {device}")


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
    `flat` needs no padding and no alignment beyond its own 4 bytes (a
    view that starts inside a buffer is fine); validity is bounded by
    n_valid alone.
    """
    if not 1 <= digit_bits <= 11:
        raise ValueError(f"digit_bits must be in 1..11, got {digit_bits}")
    if flat.device.type == "cpu":
        return digit_histograms_plain(
            flat, n_valid, prefixes, digit_shift, digit_bits, prefix_shift
        )
    _check_cuda_flat("digit_histograms", flat)
    _check_small("digit_histograms", "n_valid", n_valid, torch.int32, 1, flat.device)
    _check_small("digit_histograms", "prefixes", prefixes, torch.int32, 2, flat.device)
    out = torch.zeros((2, 1 << digit_bits), dtype=torch.int32, device=flat.device)
    _launch_hist(flat, n_valid.data_ptr(), prefixes.data_ptr(), digit_shift,
                 digit_bits, prefix_shift, out.data_ptr())
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


def radix_pick_plain(
    hists: torch.Tensor, ranks: torch.Tensor, prefixes: torch.Tensor,
    digit_bits: int, shared_row: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """radix_pick as two `_pick`s and the shift-and-or around them."""
    new_prefixes, new_ranks = [], []
    for t in range(2):
        b, k = _pick(hists[0 if shared_row else t], ranks[t : t + 1].to(torch.int64))
        new_prefixes.append((prefixes[t : t + 1].to(torch.int64) << digit_bits) | b)
        new_ranks.append(k)
    return torch.cat(new_prefixes).to(torch.int32), torch.cat(new_ranks)


def _rank_args(name: str, ranks, device) -> tuple[int | None, int | None, int, int]:
    """(k_lo pointer, k_hi pointer, k_lo value, k_hi value) for a kernel:
    pointers into a (2,) int64 tensor on `device`; values, and no pointers,
    for ranks on the host (a (2,) tensor on the CPU, or two integers)."""
    if isinstance(ranks, torch.Tensor) and ranks.device.type != "cpu":
        _check_small(name, "ranks", ranks, torch.int64, 2, device)
        return ranks.data_ptr(), ranks.data_ptr() + 8, 0, 0
    lo, hi = (int(k) for k in ranks)
    return None, None, lo, hi


def _launch_pick(
    device, hists_ptr: int, digit_bits: int, shared_row: bool, rank_args: tuple,
    prefixes_in_ptr: int, prefixes_out_ptr: int, k_out_ptr: int,
) -> None:
    with torch.cuda.device(device):
        err = _kernel("orcai_radix_pick")(
            hists_ptr, digit_bits, int(shared_row), *rank_args,
            prefixes_in_ptr, prefixes_out_ptr, k_out_ptr,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"radix_pick kernel launch failed: CUDA error {err}")
    radix_pick.launches += 1


def radix_pick(
    hists: torch.Tensor, ranks: torch.Tensor, prefixes: torch.Tensor,
    digit_bits: int, shared_row: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One level's pick for both targets: (next prefixes, ranks inside).

    hists (2, 2**digit_bits) are a level's counts (both targets read row 0
    when shared_row, as at the unprefixed level), ranks (2,) int64 the
    targets' ranks among the counted elements, prefixes (2,) int32 the
    digits found so far. For each target, b is the number of bins whose
    cumulative count is <= rank; returns ((prefix << digit_bits) | b as
    int32, rank - cum[b - 1] as int64). CUDA counts, int64 as the streaming
    path sums them, go to the kernel (the ranks may stay on the host: their
    values then go to it as arguments); CPU counts, int32 or int64, to
    radix_pick_plain.
    """
    if not 1 <= digit_bits <= 11:
        raise ValueError(f"digit_bits must be in 1..11, got {digit_bits}")
    if hists.device.type == "cpu":
        return radix_pick_plain(hists, ranks, prefixes, digit_bits, shared_row)
    if hists.device.type != "cuda":
        raise ValueError(f"radix_pick: unsupported device {hists.device}")
    _check_small("radix_pick", "hists", hists, torch.int64, 2 << digit_bits, hists.device)
    _check_small("radix_pick", "prefixes", prefixes, torch.int32, 2, hists.device)
    rank_args = _rank_args("radix_pick", ranks, hists.device)
    new_prefixes = torch.empty_like(prefixes)
    new_ranks = torch.empty(2, dtype=torch.int64, device=hists.device)
    _launch_pick(
        hists.device, hists.data_ptr(), digit_bits, shared_row, rank_args,
        prefixes.data_ptr(), new_prefixes.data_ptr(), new_ranks.data_ptr(),
    )
    return new_prefixes, new_ranks


radix_pick.launches = 0


# the selection's scratch, in int32 words, as csrc/digit_hist.cu lays it
# out: each level's (2, 2048) counts; the prefixes (4, 2), slot l the digits
# found before level l; the int64 ranks (4, 2), slot l the ranks level l
# picks (slot 0 unused: level 0 takes the caller's); a ticket a level
_O_PREFIX = 3 * 2 * _MAX_BINS
_O_RANK = _O_PREFIX + 8
_O_TICKET = _O_RANK + 16
_SCRATCH_WORDS = _O_TICKET + 4


def select_levels_plain(
    flat: torch.Tensor, n_valid, k_lo, k_hi
) -> tuple[list[torch.Tensor], list[torch.Tensor], list[torch.Tensor]]:
    """select_levels as digit_histograms_plain and radix_pick_plain, level
    by level."""
    dev = flat.device
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev).reshape(1)
    ranks = torch.cat([torch.as_tensor(k, dtype=torch.int64, device=dev).reshape(1)
                       for k in (k_lo, k_hi)])
    prefixes = torch.zeros(2, dtype=torch.int32, device=dev)
    counts, level_prefixes, level_ranks = [], [], []
    for shift, bits, pshift in _LEVELS:
        hists = digit_histograms_plain(flat, nv, prefixes, shift, bits, pshift)
        prefixes, ranks = radix_pick_plain(hists, ranks, prefixes, bits, pshift is None)
        counts.append(hists)
        level_prefixes.append(prefixes)
        level_ranks.append(ranks)
    return counts, level_prefixes, level_ranks


def _launch_select(flat: torch.Tensor, n_valid, k_lo, k_hi, scratch: torch.Tensor) -> None:
    """A selection into the zeroed scratch, in one cooperative launch.
    n_valid is a (1,) int32 tensor on flat's device or a host integer, k_lo
    and k_hi (1,) int64 tensors there or host integers; host integers go to
    the kernel as values."""
    if isinstance(n_valid, torch.Tensor):
        nv_args = (n_valid.data_ptr(), 0)
    else:
        nv_args = (None, int(n_valid))
    if isinstance(k_lo, torch.Tensor):
        rank_args = (k_lo.data_ptr(), k_hi.data_ptr(), 0, 0)
    else:
        rank_args = (None, None, int(k_lo), int(k_hi))
    with torch.cuda.device(flat.device):
        err = _kernel("orcai_select")(
            flat.data_ptr(), flat.shape[0], *nv_args, *rank_args, scratch.data_ptr(),
            _grid(flat), torch.cuda.current_stream(flat.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"select_levels kernel launch failed: CUDA error {err}")
    select_levels.launches += 1


def _select_cuda(flat: torch.Tensor, n_valid, k_lo, k_hi) -> torch.Tensor:
    """The selection's zeroed scratch after its one launch."""
    name = "select_order_statistics"
    _check_cuda_flat(name, flat)
    if isinstance(n_valid, torch.Tensor):
        _check_small(name, "n_valid", n_valid, torch.int32, 1, flat.device)
    if isinstance(k_lo, torch.Tensor):
        _check_small(name, "k_lo", k_lo, torch.int64, 1, flat.device)
        _check_small(name, "k_hi", k_hi, torch.int64, 1, flat.device)
    scratch = torch.zeros(_SCRATCH_WORDS, dtype=torch.int32, device=flat.device)
    _launch_select(flat, n_valid, k_lo, k_hi, scratch)
    return scratch


def select_levels(
    flat: torch.Tensor, n_valid, k_lo, k_hi
) -> tuple[list[torch.Tensor], list[torch.Tensor], list[torch.Tensor]]:
    """Every level of the selection of the k_lo-th and k_hi-th smallest of
    the first n_valid float32 values: ([counts (2, 2**bits) int32],
    [prefixes (2,) int32 after the level], [ranks (2,) int64 inside the
    picked bins]), a list entry a level. n_valid is a (1,) int32 tensor or a
    host integer, k_lo and k_hi (1,) int64 tensors or host integers. On
    CUDA one zeroing and one launch: each level's sweep picks its digits in
    its last block, and the levels wait for each other at a grid-wide
    barrier; the lists are views of its scratch. A CPU tensor goes to
    select_levels_plain. A host n_valid must be below 2**31, as the int32
    tensor form's is: the counts and the pick's sums are int32.
    """
    if not isinstance(n_valid, torch.Tensor) and int(n_valid) >= 1 << 31:
        raise ValueError(f"select_levels: n_valid must be below 2**31, got {int(n_valid)}")
    if flat.device.type == "cpu":
        return select_levels_plain(flat, n_valid, k_lo, k_hi)
    scratch = _select_cuda(flat, n_valid, k_lo, k_hi)
    ranks = scratch[_O_RANK:_O_TICKET].view(torch.int64)
    counts = [scratch[level * 2 * _MAX_BINS :][: 2 << bits].view(2, -1)
              for level, (_, bits, _) in enumerate(_LEVELS)]
    prefixes = [scratch[_O_PREFIX + 2 * level : _O_PREFIX + 2 * level + 2]
                for level in range(1, 4)]
    return counts, prefixes, [ranks[2 * level : 2 * level + 2] for level in range(1, 4)]


select_levels.launches = 0


def select_order_statistics(
    flat: torch.Tensor,
    n_valid: torch.Tensor,
    k_lo: torch.Tensor,
    k_hi: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (k_lo-th, k_hi-th) smallest of the first n_valid float32 values.

    Values must be non-negative and finite. n_valid is a (1,) int32 tensor
    and k_lo/k_hi are (1,) int64 tensors, all on flat's device; returns two
    (1,) float32 tensors there: the last level's prefixes (select_levels),
    read as float32.
    """
    result = select_levels(flat, n_valid, k_lo, k_hi)[1][-1].view(torch.float32)
    return result[0:1], result[1:2]


def select_order_statistics_at(
    flat: torch.Tensor, n_valid: int, k_lo: int, k_hi: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """select_order_statistics with n_valid and the ranks as host integers:
    on CUDA they go to the kernel as values, so the selection launches no
    fill of its own (one zeroing and one select_levels launch)."""
    result = select_levels(flat, int(n_valid), int(k_lo), int(k_hi))[1][-1].view(torch.float32)
    return result[0:1], result[1:2]


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
