"""B1's staged route (csrc/dft_staged.cu) traced on a CUDA device: each of
its kernels' device time and share of a call, beside torch.stft(...).abs()
and the kernels' registers, shared memory and spills.

    python -m orcai_tpu_torch.tools.trace_staged [--sizes 40962/20481/301,...]
        [--iters 10] [--seed 0]

It first builds csrc/dft_staged.cu (every build of ops/_build.py::VARIANTS)
and keeps ptxas's lines of each kernel (registers, shared memory, spills).
Then for each n_fft / hop / frames of --sizes, on an int16 tile made from
--seed: dft_magnitude held against the float64 rFFT of its first
CHECK_FRAMES frames (atol 2e-4); dft_magnitude and torch.stft(...).abs()
on the same samples timed with CUDA events in turns (a, b, b, a), --iters
calls each; then --iters calls of dft_magnitude under torch.profiler
(CUPTI): each kernel's launches, device time a call and share of the
kernels' time, and the device-memory bytes a frame pair that the design
moves in that kernel (`pair_bytes`: what it reads and writes of the
scratch, of the samples and of the magnitudes; the tables, read through
L1 and L2 by every pair, not counted) over its time (`gb_per_s`). Prints
one JSON line per size, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

DEFAULT_SIZES = "40962/20481/301,40962/20481/2048,49154/24577/301"
CHECK_FRAMES = 64  # frames held against the float64 rFFT
SPIN_CYCLES = 8_000_000  # about 4 ms at an H100's clock


def kernel_name(key: str) -> str:
    """A demangled kernel name without its return type, namespace and
    arguments: columns_kernel<short, 1>."""
    key = re.sub(r"^void ", "", key)
    key = key.replace("(anonymous namespace)::", "")
    depth, end = 0, len(key)
    for i, c in enumerate(key):
        depth += c == "<"
        depth -= c == ">"
        if c == "(" and depth == 0:
            end = i
            break
    return key[:end]


def pair_bytes(name: str, n_fft: int, hop: int, m: int, sample_bytes: int) -> int:
    """Device-memory bytes one frame pair moves through the kernel `name`
    by the design's count: M complex float32 (8 bytes) a scratch pass, the
    pair's new samples (2 hop, its frames overlapping the next pair's by
    n_fft - hop), the 2 (n_fft/2 + 1) float32 magnitudes."""
    scratch, bins = 8 * m, 2 * (n_fft // 2 + 1) * 4
    samples = min(2 * n_fft, n_fft + hop) * sample_bytes
    if name.startswith(("fft_columns_kernel", "columns_kernel")):
        return samples + scratch  # from the audio into the scratch (the chirp mode's first FFT)
    if name.startswith("fft_rows_kernel"):
        return scratch + bins  # rows to magnitudes (the FFT mode)
    if name == "rows_kernel":
        return 2 * scratch  # the chirp mode's rows back over themselves
    if name.startswith("columns_untangle_kernel"):
        return scratch + bins  # the second FFT's columns to magnitudes
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default=DEFAULT_SIZES)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orcai_tpu_torch.ops import _build
    from orcai_tpu_torch.ops.dft import (
        chirp_length, dft_magnitude, dft_route, staged_chunk_pairs, staged_mode, staged_plan)
    from orcai_tpu_torch.ops.frontend import hann_window

    if not torch.cuda.is_available():
        raise SystemExit("trace_staged: no CUDA device")
    dev = torch.device("cuda")
    logs = _build.build(["dft_staged"])
    print(json.dumps({"build_seconds": _build.build.seconds, "ptxas": {
        name: [ln.strip() for ln in log.splitlines()
               if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        for name, log in logs.items()}}), flush=True)
    rng = np.random.default_rng(args.seed)

    def event_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    for size in args.sizes.split(","):
        n_fft, hop, frames = (int(v) for v in size.split("/"))
        if dft_route(n_fft) != "staged":
            raise SystemExit(f"trace_staged: n_fft {n_fft} takes the {dft_route(n_fft)} route")
        mode = staged_mode(n_fft)
        m = chirp_length(n_fft) if mode == "chirp" else n_fft
        window = hann_window(n_fft)
        x = torch.from_numpy(rng.integers(-32768, 32768, (frames - 1) * hop + n_fft,
                                          dtype=np.int16)).to(dev)
        got = dft_magnitude(x, window, n_fft=n_fft, hop=hop)
        x64 = x[:(min(frames, CHECK_FRAMES) - 1) * hop + n_fft].double() / 32768.0
        exact = torch.fft.rfft(x64.unfold(0, n_fft, hop) * torch.from_numpy(window).to(dev),
                               dim=1).abs()
        err = float((got[:CHECK_FRAMES] - exact).abs().max())
        if not err <= 2e-4:
            raise AssertionError(f"{size}: {err} from the float64 rFFT > 2e-4")
        del got, x64, exact
        samples = x.float() * (1.0 / 32768.0)
        win = torch.hann_window(n_fft, periodic=True, device=dev)
        runs = {"kernel": lambda: dft_magnitude(x, window, n_fft=n_fft, hop=hop),
                "torch_stft": lambda: torch.stft(samples, n_fft, hop_length=hop, window=win,
                                                 center=False, return_complex=True).abs()}
        ms = {k: [] for k in runs}
        for name in [*runs, *reversed(runs)]:
            ms[name].append(event_ms(runs[name]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                runs["kernel"]()
            torch.cuda.synchronize()
        kernels = {}
        for evt in prof.key_averages():
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = evt.self_cuda_time_total
            if evt.device_type == DeviceType.CUDA and t > 0:
                name = kernel_name(evt.key)
                k = kernels.setdefault(name, {"launches": 0, "us": 0.0})
                k["launches"] += evt.count
                k["us"] += t
        total_us = sum(k["us"] for k in kernels.values())
        pairs = (frames + 1) // 2
        for name, k in kernels.items():
            k["launches_a_call"] = k.pop("launches") / args.iters
            k["ms_a_call"] = k.pop("us") / 1e3 / args.iters
            k["share"] = k["ms_a_call"] * 1e3 * args.iters / total_us if total_us else None
            k["pair_bytes"] = pair_bytes(name, n_fft, hop, m, 2)
            k["gb_per_s"] = (k["pair_bytes"] * pairs / (k["ms_a_call"] * 1e-3) / 1e9
                             if k["ms_a_call"] else None)
        print(json.dumps({
            "n_fft": n_fft, "hop": hop, "frames": frames, "dtype": "int16", "mode": mode,
            "length": m, "plan": list(staged_plan(m)),
            "chunks": -(-pairs // staged_chunk_pairs(m)), "max_abs_err_vs_float64": err,
            "ms": ms, "kernel_ms": sum(ms["kernel"]) / len(ms["kernel"]),
            "torch_stft_ms": sum(ms["torch_stft"]) / len(ms["torch_stft"]),
            "traced_device_ms_a_call": total_us / 1e3 / args.iters,
            "profiler_saw_device_time": bool(total_us), "kernels": kernels}), flush=True)
        del x, samples
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
