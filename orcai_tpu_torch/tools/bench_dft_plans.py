"""B1's mixed route on other plans and exchange layouts, and its chirp mode
on other convolution lengths, on a CUDA device.

    python -m orcai_tpu_torch.tools.bench_dft_plans [--frames 32768] [--iters 20] [--seed 0]
        [--sweep | --staged]

The mixed-radix kernel (csrc/dft_mixed.cu) takes its plan from the host, so
one build runs any plan of an n_fft. At (n_fft, hop) 384/192 and 352/176
(the spectral wires), 768/384, 1024/256 and 2048/512, on an int16 tile of
--frames frames synthesized from --seed, it times three plans of the same
transform: the default (ops/dft.py::fft_plan, radix 16 at most, with the
exchange layouts of exchange_pads), the same radices with no padding, and
the radix-8 plan (8 as often as it divides, then one 4 or 2, then the odd
primes) with its own layouts. They run in turns (a, b, c, c, b, a), each
timed with CUDA events over --iters launches, and every output is held
against the plain version (atol 2e-4). The chirp mode the same way on
its convolution lengths M: the default (ops/dft.py::chirp_length, the
{2, ..., 19}-smooth M >= 2 n_fft - 1 whose passes move the fewest values),
the same rule's pick over {2, ..., 23}-smooth M where it differs
("with_23"), the smallest smooth M >= 2 n_fft - 1 and the power of two;
at 470/235 and 2038/1019 on the mixed kernel's block layout, at
8198/4099, 16418/8209 and 24578/12289 on the cluster kernel
(csrc/dft_cluster.cu: 2, 4 and 8 CTAs at the default M, 8 at 65536), each
held against the float64 rFFT of its first CHECK_FRAMES frames (atol 2e-4;
the plain fp32 GEMM is itself about 2e-4 from it at 16418).

With --sweep it times instead dft_magnitude against torch.stft(...).abs()
on the same tile at SWEEP_SIZES, in turns (a, b, b, a), each held against
the float64 rFFT of its first CHECK_FRAMES frames: n_fft of 2^a * 23, 29
and 31 (the FFT routes since radices 23, 29 and 31; above 8192 the 2^a *
29 and 31 take the staged route), n_fft with a prime factor above 31 (the chirp mode) on both of its
layouts and the staged route's chirp mode, and the staged route's FFT mode
(98304, 131072); the tile is --frames frames, or fewer where its samples
would pass 2^27 (2048 at hop 65536).

With --staged it times the staged route's kernels (csrc/dft_staged.cu,
called as dft_magnitude calls them, ops/dft.py::_launch_staged) on the
splits N1 x N2 of STAGED_SPLITS and the chunks of STAGED_CHUNKS (frame
pairs a chunk: ops/dft.py::staged_chunk_pairs' default, then 64, 256 and
the whole tile) at 131072 / 65536 on 2048 frames, and its chirp mode at
the tiles of STAGED_CHIRP_TILES (40962 / 20481 on 301 and 2048 frames,
49154 / 24577 on 301) on the convolution lengths of STAGED_LENGTHS (the
default, chirp_length's, and the others named for that n_fft), and on
the default length with the batches of STAGED_BATCHES (G1, G2, G3 a CTA)
beside staged_plan's, each
held against the float64 rFFT of its first CHECK_FRAMES frames (atol
2e-4), in turns (a, b, ..., b, a). Prints one JSON line per size, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

SIZES = ((384, 192), (352, 176), (768, 384), (1024, 256), (2048, 512))
CHIRP_SIZES = ((470, 235), (2038, 1019), (8198, 4099), (16418, 8209), (24578, 12289))
SWEEP_SIZES = (
    # 2^a * 23: the mixed route, then the cluster route
    (368, 184), (736, 368), (1472, 736), (2944, 1472), (5888, 2944), (11776, 5888),
    (23552, 11776),
    # 2^a * 29 and 2^a * 31: the mixed route up to 8192, then the staged route's
    # FFT mode (dft_cluster.cu has no radix 29 or 31)
    (464, 232), (496, 248), (1856, 928), (1984, 992), (3712, 1856), (3968, 1984),
    (7424, 3712), (7936, 3968), (14848, 7424), (15872, 7936),
    # a prime factor above 31 (47, 1021, 1019, 89, 4099, 8209, 12289, 20479,
    # 6827, 24577): the chirp mode's block layout (M <= 8192), its cluster
    # layout, then the staged route's chirp mode
    (470, 235), (1021, 1021), (2038, 1019), (4094, 2047), (8198, 4099), (16418, 8209),
    (24578, 12289), (40958, 20479), (40962, 20481), (49154, 24577),
    # the staged route's FFT mode
    (98304, 49152), (131072, 65536))
SWEEP_SAMPLES = 1 << 27  # a sweep tile's most samples
STAGED_SPLITS = ((256, 512), (512, 256), (128, 1024), (1024, 128), (64, 2048), (32, 4096))
STAGED_CHUNKS = (None, 64, 256, 1 << 30)  # frame pairs a chunk: the default, ..., the tile
# the chirp mode's batches (G1 columns, G2 row pairs, G3 column pairs a CTA)
# timed on the default length at each n_fft, beside staged_plan's
STAGED_BATCHES = {40962: ((16, 4, 8), (16, 2, 8), (8, 4, 4)),
                  49154: ((8, 4, 4), (16, 4, 8), (8, 8, 4), (4, 2, 2))}
# the chirp mode's tiles (n_fft, hop, frames) and, beside chirp_length's,
# the convolution lengths timed at each n_fft
STAGED_CHIRP_TILES = ((40962, 20481, 301), (40962, 20481, 2048), (49154, 24577, 301))
STAGED_LENGTHS = {40962: (81928, 82944, 98304, 131072),
                  49154: (98560, 102400, 109744, 131072)}
CHECK_FRAMES = 64  # frames held against the float64 rFFT
SPIN_CYCLES = 8_000_000  # about 4 ms at an H100's clock


def radix8_plan(n_fft: int) -> tuple[int, ...]:
    """8 as often as it divides n_fft, then one 4 or 2, then 3, 5, 7, 11."""
    plan, n = [], n_fft
    while n % 8 == 0:
        plan.append(8)
        n //= 8
    for r in (4, 2):
        if n % r == 0:
            plan.append(r)
            n //= r
            break
    for r in (3, 5, 7, 11):
        while n % r == 0:
            plan.append(r)
            n //= r
    return tuple(plan)


def event_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back launches,
    behind a short device spin so the host's launch cost is not timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=32768)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--sweep", action="store_true",
                      help="dft_magnitude against torch.stft at SWEEP_SIZES")
    mode.add_argument("--staged", action="store_true",
                      help="the staged route's splits, chunks and chirp lengths")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from orcai_tpu_torch.ops.dft import (
        CLUSTER_MAX, MIXED_MAX, _DTYPE_CODES, _chirp_kernel, _cluster_plan_array, _kernel,
        _build_variant, _launch_staged, _passes, _smooth, chirp_length, chirp_tables,
        cluster_plan, cluster_tables, dft_magnitude, dft_magnitude_plain, dft_route,
        exchange_pads, fft_plan, fft_tables, pack_plan, pass_roots, staged_mode, staged_plan)
    from orcai_tpu_torch.ops.frontend import hann_window

    if not torch.cuda.is_available():
        raise SystemExit("bench_dft_plans: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    frames = args.frames

    def on_device(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def vs_float64(got, x, window, n_fft, hop):
        """max |got - |rFFT(window * frame)|| over the first CHECK_FRAMES
        frames, the rFFT in float64."""
        x64 = x[:(CHECK_FRAMES - 1) * hop + n_fft].double() / 32768.0
        exact = torch.fft.rfft(x64.unfold(0, n_fft, hop) * on_device(window), dim=1).abs()
        return float((got[:CHECK_FRAMES] - exact).abs().max())

    def staged_line(n_fft, hop, frames, variants):
        """Time each variant (kwargs of _launch_staged) in turns on one
        int16 tile, each held against the float64 rFFT first."""
        window = hann_window(n_fft)
        x = torch.from_numpy(rng.integers(-32768, 32768, (frames - 1) * hop + n_fft,
                                          dtype=np.int16)).to(dev)
        out = torch.empty((frames, n_fft // 2 + 1), dtype=torch.float32, device=dev)
        line = {"n_fft": n_fft, "hop": hop, "frames": frames, "dtype": "int16",
                "variants": {}, "ms": {k: [] for k in variants}}
        for name, kw in variants.items():
            m = kw.get("m") or (chirp_length(n_fft) if staged_mode(n_fft) == "chirp" else n_fft)
            if _launch_staged(x, window, out, n_fft, hop, **kw) != 0:
                raise RuntimeError(f"{n_fft}/{hop} {name}: launch failed")
            torch.cuda.synchronize()
            err = vs_float64(out, x, window, n_fft, hop)
            line["variants"][name] = {"length": m, "plan": list(staged_plan(m, kw.get("split"))),
                                      "batches": kw.get("batches"),
                                      "max_abs_err_vs_float64": err}
            if not err <= 2e-4:
                raise AssertionError(f"{n_fft}/{hop} {name}: {err} from the float64 rFFT")
        for name in [*variants, *reversed(variants)]:
            line["ms"][name].append(event_ms(
                torch, lambda: _launch_staged(x, window, out, n_fft, hop, **variants[name]),
                args.iters))
        print(json.dumps(line), flush=True)
        del x, out
        torch.cuda.empty_cache()

    if args.staged:
        staged_line(131072, 65536, 2048, {
            f"{n1}x{n2}/{chunk or 'default'}": {"split": (n1, n2), "chunk_pairs": chunk}
            for n1, n2 in STAGED_SPLITS for chunk in STAGED_CHUNKS})
        for n_fft, hop, tile in STAGED_CHIRP_TILES:
            staged_line(n_fft, hop, tile, {
                f"{m}/{chunk or 'default'}": {"m": m, "chunk_pairs": chunk}
                for m in (chirp_length(n_fft), *STAGED_LENGTHS[n_fft]) for chunk in STAGED_CHUNKS})
            staged_line(n_fft, hop, tile, {
                "default": {}, **{"batches_" + "_".join(map(str, g)): {"batches": g}
                                  for g in STAGED_BATCHES[n_fft]}})
    if args.sweep:
        for n_fft, hop in SWEEP_SIZES:
            window = hann_window(n_fft)
            frames = min(args.frames, max(64, SWEEP_SAMPLES // hop))
            n = (frames - 1) * hop + n_fft
            x = torch.from_numpy(rng.integers(-32768, 32768, n, dtype=np.int16)).to(dev)
            samples = x.float() * (1.0 / 32768.0)
            win = torch.hann_window(n_fft, periodic=True, device=dev)
            route = dft_route(n_fft)
            chirp = route == "chirp" or route == "staged" and staged_mode(n_fft) == "chirp"
            m = chirp_length(n_fft) if chirp else n_fft
            line = {"n_fft": n_fft, "hop": hop, "frames": frames, "dtype": "int16",
                    "route": route, "length": m,
                    "plan": list(fft_plan(m)) if m <= MIXED_MAX else
                    list(cluster_plan(m)) if m <= CLUSTER_MAX else list(staged_plan(m))}
            if route == "chirp":
                line["layout"] = "block" if _chirp_kernel(n_fft) == "mixed" else "cluster"
            got = dft_magnitude(x, window, n_fft=n_fft, hop=hop)
            line["max_abs_err_vs_float64"] = err = vs_float64(got, x, window, n_fft, hop)
            if not err <= 2e-4:
                raise AssertionError(f"{n_fft}/{hop}: {err} from the float64 rFFT > 2e-4")
            del got
            runs = {"kernel": lambda: dft_magnitude(x, window, n_fft=n_fft, hop=hop),
                    "torch_stft": lambda: torch.stft(samples, n_fft, hop_length=hop, window=win,
                                                     center=False, return_complex=True).abs()}
            line["ms"] = {k: [] for k in runs}
            for name in [*runs, *reversed(runs)]:
                line["ms"][name].append(event_ms(torch, runs[name], args.iters))
            kernel, library = (sum(line["ms"][k]) for k in runs)
            line["library_over_kernel"] = library / kernel
            print(json.dumps(line), flush=True)
            del x, samples
            torch.cuda.empty_cache()
    for n_fft, hop in () if args.sweep or args.staged else SIZES + CHIRP_SIZES:
        window = hann_window(n_fft)
        n = (frames - 1) * hop + n_fft
        x = torch.from_numpy(rng.integers(-32768, 32768, n, dtype=np.int16)).to(dev)
        chirp = (n_fft, hop) in CHIRP_SIZES
        want = None if chirp else dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)
        out = torch.empty((frames, n_fft // 2 + 1), dtype=torch.float32, device=dev)
        if chirp:  # (FFT length, plan, layouts) of each variant
            lengths = {"default": chirp_length(n_fft),
                       "smallest": next(m for m in range(2 * n_fft - 1, 4 * n_fft)
                                        if _smooth(m)),
                       "power_of_two": 1 << (2 * n_fft - 2).bit_length()}
            top = min(4 * n_fft, MIXED_MAX if n_fft <= MIXED_MAX // 2 else CLUSTER_MAX)
            with_23 = min((m for m in range(2 * n_fft - 1, top + 1) if _smooth(m)),
                          key=lambda m: (m * _passes(m), m))
            if with_23 != lengths["default"]:
                lengths["with_23"] = with_23
            variants = {k: (m, fft_plan(m), exchange_pads(m)) if m <= MIXED_MAX
                        else (m, cluster_plan(m), None) for k, m in lengths.items()}
        else:
            default, eights = fft_plan(n_fft), radix8_plan(n_fft)
            variants = {
                "default": (n_fft, default, exchange_pads(n_fft)),
                "default_unpadded": (n_fft, default, ((0, 0),) * len(default)),
                "radix8": (n_fft, eights, exchange_pads(n_fft, eights)),
            }
        line = {"n_fft": n_fft, "hop": hop, "frames": frames, "dtype": "int16",
                "plans": {k: {"length": m, "radices": list(p),
                              **({"pads": [list(x) for x in pads]} if pads else {})}
                          for k, (m, p, pads) in variants.items()},
                "ms": {k: [] for k in variants}, "max_abs_err": {}}
        # a plan of the mixed kernel, or above its 8192 points the cluster
        # kernel's (N1, N2, C): its packed plan and roots
        kernel = {k: "mixed" if m <= MIXED_MAX else "cluster" for k, (m, _, _) in variants.items()}
        packed = {k: pack_plan(p, pads) if kernel[k] == "mixed" else _cluster_plan_array(m)
                  for k, (m, p, pads) in variants.items()}
        roots = {k: on_device(pass_roots(m, p) if kernel[k] == "mixed" else cluster_tables(m))
                 for k, (m, p, _) in variants.items()}
        tables = {k: on_device(chirp_tables(window, m)) if chirp else None
                  for k, (m, _, _) in variants.items()}
        win = None if chirp else on_device(fft_tables(window)[0])

        def launch(name):
            err = _kernel(kernel[name], _build_variant(kernel[name], variants[name][0], x.dtype))(
                x.data_ptr(), _DTYPE_CODES[x.dtype], None if chirp else win.data_ptr(),
                roots[name].data_ptr(), tables[name].data_ptr() if chirp else None,
                packed[name], out.data_ptr(), frames, n_fft, hop, stream)
            if err != 0:
                raise RuntimeError(f"{n_fft}/{hop} {name}: CUDA error {err}")

        for name in variants:
            launch(name)
            torch.cuda.synchronize()
            line["max_abs_err"][name] = err = (
                vs_float64(out, x, window, n_fft, hop) if chirp
                else float((out - want).abs().max()))
            if not err <= 2e-4:
                raise AssertionError(f"{n_fft}/{hop} {name}: max |kernel - "
                                     f"{'float64' if chirp else 'plain'}| {err} > 2e-4")
        for name in [*variants, *reversed(variants)]:
            line["ms"][name].append(event_ms(torch, lambda: launch(name), args.iters))
        print(json.dumps(line), flush=True)
        del x, want, out
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
