"""B1's mixed route on other plans and exchange layouts, and its chirp mode
on other convolution lengths, on a CUDA device.

    python -m orcai_tpu_torch.tools.bench_dft_plans [--frames 32768] [--iters 20] [--seed 0]

The mixed-radix kernel (csrc/dft_mixed.cu) takes its plan from the host, so
one build runs any plan of an n_fft. At (n_fft, hop) 384/192 and 352/176
(the spectral wires), 768/384, 1024/256 and 2048/512, on an int16 tile of
--frames frames synthesized from --seed, it times three plans of the same
transform: the default (ops/dft.py::fft_plan, radix 16 at most, with the
exchange layouts of exchange_pads), the same radices with no padding, and
the radix-8 plan (8 as often as it divides, then one 4 or 2, then the odd
primes) with its own layouts. They run in turns (a, b, c, c, b, a), each
timed with CUDA events over --iters launches, and every output is held
against the plain version (atol 2e-4). The chirp mode (the same kernel)
at 1216/608 and 2038/1019 the same way on three convolution lengths M:
the default (ops/dft.py::chirp_length, the smooth M >= 2 n_fft - 1 whose
passes move the fewest values), the smallest smooth M >= 2 n_fft - 1 and
the power of two. Prints one JSON line per size, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

SIZES = ((384, 192), (352, 176), (768, 384), (1024, 256), (2048, 512))
CHIRP_SIZES = ((1216, 608), (2038, 1019))
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
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from orcai_tpu_torch.ops.dft import (
        _DTYPE_CODES, _kernel, _smooth, chirp_length, chirp_tables, dft_magnitude_plain,
        exchange_pads, fft_plan, fft_tables, pack_plan, pass_roots)
    from orcai_tpu_torch.ops.frontend import hann_window

    if not torch.cuda.is_available():
        raise SystemExit("bench_dft_plans: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    frames = args.frames

    def on_device(a):
        return torch.from_numpy(np.array(a)).to(dev)

    for n_fft, hop in SIZES + CHIRP_SIZES:
        window = hann_window(n_fft)
        n = (frames - 1) * hop + n_fft
        x = torch.from_numpy(rng.integers(-32768, 32768, n, dtype=np.int16)).to(dev)
        want = dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)
        out = torch.empty_like(want)
        if (n_fft, hop) in CHIRP_SIZES:  # (FFT length, plan, layouts) of each variant
            lengths = {"default": chirp_length(n_fft),
                       "smallest": next(m for m in range(2 * n_fft - 1, 4 * n_fft)
                                        if _smooth(m)),
                       "power_of_two": 1 << (2 * n_fft - 2).bit_length()}
            variants = {k: (m, fft_plan(m), exchange_pads(m)) for k, m in lengths.items()}
        else:
            default, eights = fft_plan(n_fft), radix8_plan(n_fft)
            variants = {
                "default": (n_fft, default, exchange_pads(n_fft)),
                "default_unpadded": (n_fft, default, ((0, 0),) * len(default)),
                "radix8": (n_fft, eights, exchange_pads(n_fft, eights)),
            }
        chirp = (n_fft, hop) in CHIRP_SIZES
        line = {"n_fft": n_fft, "hop": hop, "frames": frames, "dtype": "int16",
                "plans": {k: {"length": m, "radices": list(p), "pads": [list(x) for x in pads]}
                          for k, (m, p, pads) in variants.items()},
                "ms": {k: [] for k in variants}, "max_abs_err": {}}
        packed = {k: pack_plan(p, pads) for k, (_, p, pads) in variants.items()}
        roots = {k: on_device(pass_roots(m, p)) for k, (m, p, _) in variants.items()}
        tables = {k: on_device(chirp_tables(window, m)) if chirp else None
                  for k, (m, _, _) in variants.items()}
        win = None if chirp else on_device(fft_tables(window)[0])

        def launch(name):
            err = _kernel("mixed")(
                x.data_ptr(), _DTYPE_CODES[x.dtype], None if chirp else win.data_ptr(),
                roots[name].data_ptr(), tables[name].data_ptr() if chirp else None,
                packed[name], out.data_ptr(), frames, n_fft, hop, stream)
            if err != 0:
                raise RuntimeError(f"{n_fft}/{hop} {name}: CUDA error {err}")

        for name in variants:
            launch(name)
            torch.cuda.synchronize()
            line["max_abs_err"][name] = err = float((out - want).abs().max())
            if not err <= 2e-4:
                raise AssertionError(f"{n_fft}/{hop} {name}: max |kernel - plain| {err} > 2e-4")
        for name in [*variants, *reversed(variants)]:
            line["ms"][name].append(event_ms(torch, lambda: launch(name), args.iters))
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
