"""csrc/dft_mixed.cu's FFT mode taken apart on one CUDA device: where its
time goes between the memory path and the arithmetic.

    python -m orcai_tpu_torch.tools.probe_mixed [--sizes 384/192,352/176]
        [--compile 512] [--frames 32768] [--dtypes int16] [--iters 20] [--seed 0] [--sass]

Three copies of the source (`probe_source`) are compiled into
_build/probe/, for each build a size needs (ops/dft.py::_build_variant):
the kernel as ops/_build.py builds it, one with no passes (the span copies
and a store of each row from its windowed samples) and one with the passes
and the untangle but no row stored. --compile adds the plans of those
n_fft to the copies' table of plans compiled whole (COMPILED), so that
the compiled layout can be read at a size the shipped build runs on
another layout or route (512, the FFT route's, beside whose kernel it is
then timed). For each size and sample type: the layout the kernel takes
(ops/dft.py::mixed_layout: threads, resident warps, registers, local
memory), the three copies' times with CUDA events over --iters launches
behind a short device spin, and the byte bound (each sample read once,
each magnitude written once, at 3.35 TB/s). The full copy is held
against dft_magnitude_plain (atol 2e-4) first. Prints one JSON line a size
and type, one of every build's ptxas lines, with --sass one of each kernel
of the full builds counted by `cuobjdump -sass` (static instructions by
class: floating point, shared and global memory, control, the rest), then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from orcai_tpu_torch.ops import _build

PROBES = {0: "kernel", 1: "no_passes", 2: "no_stores"}
# each probe's edits of csrc/dft_mixed.cu: (the text, what takes its place),
# the text found exactly once; the compiled layout's and the warp layout's
ROWS_FROM_SAMPLES = """\
  {  // no passes: each row stored from its windowed samples
    float* row = out + static_cast<long long>(t) * NBINS;
    for (int k = lane; k < NBINS; k += 32) {
      row[k] = win[k] * sample_unscaled(xa[k]);
      if (t + 1 < n_frames) row[NBINS + k] = win[k] * sample_unscaled(xa[hop + k]);
    }
    __syncwarp();
    return;
  }
"""
GENERIC_ROWS_FROM_SAMPLES = """\
  if (plan.chirp_n == 0) {  // no passes: each row stored from its windowed samples
    const int n_bins = plan.n / 2 + 1;
    float* row = out + static_cast<long long>(t) * n_bins;
    for (int k = lane; k < n_bins; k += width) {
      row[k] = win[k] * sample_to_f32(xa[k]);
      if (t + 1 < n_frames) row[n_bins + k] = win[k] * sample_to_f32(xa[hop + k]);
    }
    fft_sync<BLOCK>();
    return;
  }
"""
KEPT_LIVE = "if (__float_as_uint(ma) == 0xFFFFFFFFu) row_a[k] = mb;  // no stores: kept live\n"
FIRST_PASS = "  compiled_first<I>(xa, hop, wreg, win, za, lane);\n"
GENERIC_PASSES = "  if (!BLOCK || plan.chirp_n == 0) {\n"
EDITS = {
    1: ((FIRST_PASS, ROWS_FROM_SAMPLES + FIRST_PASS),
        (GENERIC_PASSES, GENERIC_ROWS_FROM_SAMPLES + GENERIC_PASSES)),
    2: (("      row_a[k] = ma;\n      if (has_b) row_a[NBINS + k] = mb;\n", "      " + KEPT_LIVE),
        ("    row_a[k] = ma;\n    if (has_b) row_a[n_bins + k] = mb;\n", "    " + KEPT_LIVE)),
}
TABLE = "constexpr Compiled COMPILED[] = {\n"
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 8_000_000  # about 4 ms of device spin ahead of the first event
DTYPES = ("f32", "int16", "uint8")
SASS_CLASSES = {"fp": ("FADD", "FMUL", "FFMA", "MUFU"),
                "memory": ("LDS", "STS", "LDG", "STG", "LDGSTS", "LD", "ST"),
                "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC", "BAR", "NOP")}


def sass_counts(library: Path) -> dict:
    """{kernel: {"instructions": n, class: n, ...}} of a library's kernels,
    counted from `cuobjdump -sass` (static: each instruction once)."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1).split("dft_mixed_kernel")[-1]
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            counts[name][m.group(2)] += 1
    out = {}
    for name, ops in counts.items():
        total = sum(ops.values())
        classes = {c: sum(ops[o] for o in opcodes) for c, opcodes in SASS_CLASSES.items()}
        out[name] = {"instructions": total, **classes,
                     "integer_and_moves": total - sum(classes.values())}
    return out


def probe_source(probe: int, compile_sizes=()) -> str:
    """csrc/dft_mixed.cu with probe `probe`'s edits (PROBES; 0 none) and the
    plans of `compile_sizes` (ops/dft.py::fft_plan, radices of 16 at most in
    3 passes at most) added to its COMPILED table."""
    from orcai_tpu_torch.ops.dft import fft_plan

    source = (_build.CSRC / "dft_mixed.cu").read_text()
    entries = ""
    for n in compile_sizes:
        plan = fft_plan(n)
        if len(plan) > 3 or max(plan) > 16:
            raise SystemExit(f"probe_mixed: the plan {plan} of {n} cannot be compiled whole")
        entries += f"    {{{len(plan)}, {{{', '.join(map(str, plan))}}}}},  // {n}, probe_mixed\n"
    edits = ((TABLE, TABLE + entries), *EDITS.get(probe, ()))
    for old, new in edits:
        if source.count(old) != 1:
            raise SystemExit(f"probe_mixed: csrc/dft_mixed.cu no longer holds {old!r} once")
        source = source.replace(old, new)
    return source


def build_probes(variants, compile_sizes=()) -> tuple[dict, dict]:
    """{(variant, probe): library path} and {name: ptxas lines}, every nvcc
    at once."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for probe in PROBES:
        src = out_dir / f"dft_mixed-p{probe}.cu"
        src.write_text(probe_source(probe, compile_sizes))
        for variant in variants:
            flags = (*_build._flags(variant), f"-I{_build.CSRC}")
            path = out_dir / f"libdft_mixed{_build._tag(variant)}-p{probe}.so"
            jobs[(variant, probe)] = (path, subprocess.Popen(
                [_build._nvcc(), *flags, "-o", str(path), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths, ptxas = {}, {}
    for (variant, probe), (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"probe_mixed: nvcc failed for {variant} probe {probe}:\n{log}")
        paths[(variant, probe)] = path
        ptxas[f"odd{variant[0]}-t{variant[1]}-{PROBES[probe]}"] = [
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return paths, ptxas


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default="384/192,352/176")
    parser.add_argument("--compile", default="",
                        help="n_fft whose plans the copies compile whole, comma-separated")
    parser.add_argument("--frames", type=int, default=32768)
    parser.add_argument("--dtypes", default="int16")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from orcai_tpu_torch.ops.dft import (
        _DTYPE_CODES, _build_variant, _plan_array, _route_tables, dft_magnitude,
        dft_magnitude_plain, dft_route, mixed_layout)
    from orcai_tpu_torch.ops.frontend import hann_window
    from orcai_tpu_torch.ops.wire_codec import mulaw_encode

    if not torch.cuda.is_available():
        raise SystemExit("probe_mixed: no CUDA device")
    sizes = [tuple(int(v) for v in s.split("/")) for s in args.sizes.split(",")]
    kinds = args.dtypes.split(",")
    torch_dtype = {"f32": torch.float32, "int16": torch.int16, "uint8": torch.uint8}
    compile_sizes = tuple(int(v) for v in args.compile.split(",") if v)
    for n_fft, _ in sizes:
        if dft_route(n_fft) not in ("mixed", "fft"):
            raise SystemExit(f"probe_mixed: n_fft {n_fft} does not take the mixed or FFT route")
    variants = sorted({_build_variant("mixed", n, torch_dtype[k]) for n, _ in sizes for k in kinds})
    paths, ptxas = build_probes(variants, compile_sizes)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for key, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.orcai_dft_mixed.argtypes = [ptr, i32, ptr, ptr, ptr, ctypes.POINTER(i32), ptr, i32,
                                        i32, i32, ptr]
        lib.orcai_dft_mixed.restype = i32
        libs[key] = lib
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def cuda_ms(fn) -> float:
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

    for n_fft, hop in sizes:
        rng = np.random.default_rng(args.seed + n_fft)
        n = (args.frames - 1) * hop + n_fft
        pcm = rng.integers(-32768, 32768, n, dtype=np.int16)
        host = {"int16": pcm, "uint8": mulaw_encode(pcm),
                "f32": (0.3 * rng.standard_normal(n)).astype(np.float32)}
        window = hann_window(n_fft)
        win, roots = _route_tables("mixed", window.tobytes(), dev)
        for kind in kinds:
            x = torch.from_numpy(host[kind]).to(dev)
            variant = _build_variant("mixed", n_fft, x.dtype)
            out = torch.empty((args.frames, n_fft // 2 + 1), dtype=torch.float32, device=dev)

            def launch(probe):
                err = libs[(variant, probe)].orcai_dft_mixed(
                    x.data_ptr(), _DTYPE_CODES[x.dtype], win.data_ptr(), roots.data_ptr(), None,
                    _plan_array(n_fft), out.data_ptr(), args.frames, n_fft, hop, stream)
                if err != 0:
                    raise SystemExit(f"probe_mixed: {n_fft}/{hop} probe {probe}: CUDA error {err}")

            launch(0)
            err = float((out - dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)).abs().max())
            if not err <= 2e-4:
                raise SystemExit(f"probe_mixed: {n_fft}/{hop} {kind}: {err} from plain")
            line = {"n_fft": n_fft, "hop": hop, "frames": args.frames, "dtype": kind,
                    "max_abs_err": err, "bound_ms": (x.numel() * x.element_size()
                                                     + out.numel() * 4) / HBM_BYTES_PER_S * 1e3,
                    **mixed_layout(n_fft, hop, x.dtype, libs[(variant, 0)])}
            for probe, name in PROBES.items():
                line[f"{name}_ms"] = cuda_ms(lambda: launch(probe))
            if dft_route(n_fft) == "fft":  # the FFT route's kernel on the same tile
                line["fft_route_ms"] = cuda_ms(
                    lambda: dft_magnitude(x, window, n_fft=n_fft, hop=hop))
            print(json.dumps(line), flush=True)
            del x, out
    print(json.dumps({"ptxas": ptxas}), flush=True)
    if args.sass:
        print(json.dumps({"sass": {f"odd{v[0]}-t{v[1]}": sass_counts(paths[(v, 0)])
                                   for v in variants}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
