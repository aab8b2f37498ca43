"""csrc/dft_mixed.cu taken apart on one CUDA device, in its FFT mode and
in its chirp mode: where its time goes between the memory path, the
tables and the arithmetic.

    python -m orcai_tpu_torch.tools.probe_mixed [--sizes 384/192,352/176]
        [--compile 512] [--block-shapes 8192:512:1,4096c:256:2] [--frames 32768] [--dtypes int16]
        [--iters 20] [--seed 0] [--sass]

Five copies of the source (`probe_source`) are compiled into
_build/probe/, for each build a size needs (ops/dft.py::_build_variant):
the kernel as ops/_build.py builds it; one with no passes (the span copies
and a store of each row from its windowed samples; in the compiled block
layout the first pass's loads and butterflies, their values stored as the
rows); one with the passes
and the untangle but no row stored; one with no table loads (the roots,
the window and the chirp mode's w a, B and a taken from constants the
compiler cannot fold); and one whose chirp mode runs no second FFT (the
untangle reads the first FFT's output). --compile adds the plans of those
n_fft to the copies' table of plans compiled whole (COMPILED), so that
the compiled layout can be read at a size the shipped build runs on
another layout or route (512, the FFT route's, beside whose kernel it is
then timed). --block-shapes gives the block layout's plans compiled whole
(BLOCK_COMPILED, a row a mode: n the FFT mode's, nc the chirp mode's M)
other threads a group and groups a block in the copies, to read another
shape on the card. --sizes takes any n_fft of the kernel: the mixed route's
(every layout), 512, and the chirp mode's on the block layout (470,
2038). For each size and sample type: the layout the kernel takes
(ops/dft.py::mixed_layout: threads, resident warps, frame pairs in flight
on an SM, compiled or not, registers, local memory), the copies' times
with CUDA events over --iters launches behind a short device spin, and
the byte bound (each sample read once, each magnitude written once, at
3.35 TB/s). The full copy is held first to 2e-4 of dft_magnitude_plain or
of the float64 rFFT on the first 2048 frames (the plain fp32 GEMM misses
2e-4 from 4096 up). Prints one JSON line a size and type, one of every
build's ptxas lines, with --sass one of each kernel of the full builds
counted by `cuobjdump -sass` (static instructions by class: floating
point, shared and global memory, control, the rest), then the card's
name and power limit.
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

PROBES = {0: "kernel", 1: "no_passes", 2: "no_stores", 3: "no_tables", 4: "no_second_fft"}
# each probe's edits of csrc/dft_mixed.cu: (the text, what takes its place),
# the text found exactly once; the compiled layout's, the warp and block
# layouts' (transform_pair, shared) and, where a probe reaches it, the
# chirp mode's
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
  {  // no passes: each row stored from its windowed samples (w a's real part)
    const int n = plan.chirp_n ? plan.chirp_n : plan.n, n_bins = n / 2 + 1;
    float* row = out + static_cast<long long>(t) * n_bins;
    for (int k = lane; k < n_bins; k += width) {
      const float w = plan.chirp_n ? chirp[k].x : win[k];
      row[k] = w * sample_to_f32(xa[k]);
      if (t + 1 < n_frames) row[n_bins + k] = w * sample_to_f32(xa[hop + k]);
    }
    fft_sync<BLOCK>();
    return;
  }
"""
BLOCK_ROWS_FROM_SAMPLES = """\
    {  // no passes: the first pass's values stored as the rows
      const int nb = (CHIRP ? n_fft : N) / 2 + 1;
      float* row = out + static_cast<long long>(t) * nb;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int n = tid + r * (N / 16);
        if (n < nb) {
          row[n] = v.re[0][r];
          if (has_b) row[nb + n] = v.im[0][r];
        }
      }
      continue;
    }
"""
BLOCK_FIRST = "    group_sync<GT, GROUPS>(group);  // the previous pair's untangle is done with z\n"
KEPT_LIVE = "if (__float_as_uint(ma) == 0xFFFFFFFFu) row_a[k] = mb;  // no stores: kept live\n"
FIRST_PASS = "  compiled_first<I>(xa, hop, wreg, win, za, lane);\n"
GENERIC_PASSES = "  if (!BLOCK || plan.chirp_n == 0) {\n"
CONSTANT = "make_float2(0.6f, 0.8f)"  # a table value's stand-in the compiler cannot fold
SECOND_FFT = ("    const float2* u = fft<BLOCK, ODD>(ProductLoad{y, s, g, chirp + 2 * n_fft}, other, y, tw,\n"
              "                                      plan, lane, width);\n")
EDITS = {
    1: ((FIRST_PASS, ROWS_FROM_SAMPLES + FIRST_PASS),
        (GENERIC_PASSES, GENERIC_ROWS_FROM_SAMPLES + GENERIC_PASSES),
        (BLOCK_FIRST, BLOCK_ROWS_FROM_SAMPLES + BLOCK_FIRST)),
    2: (("      row_a[k] = ma;\n      if (has_b) row_a[NBINS + k] = mb;\n", "      " + KEPT_LIVE),
        ("    row_a[k] = ma;\n    if (has_b) row_a[n_bins + k] = mb;\n", "    " + KEPT_LIVE)),
    # the roots, the window and the chirp tables (w a, B, a) from constants
    3: (("      const float2 w = tw[(r - 1) * ns + jm];\n",
         f"      const float2 w = {CONSTANT};  // no tables\n"),
        ("    const float w = win[n];\n", "    const float w = 0.5f;  // no tables\n"),
        ("    const float2 c = wa[n];\n", f"    const float2 c = {CONSTANT};  // no tables\n"),
        ("    const float2 v = y[padded(m, s, g)], w = b[m];\n",
         f"    const float2 v = y[padded(m, s, g)], w = {CONSTANT};  // no tables\n"),
        ("    const float2 v = u[padded(k, s, g)], c = a[k];\n",
         f"    const float2 v = u[padded(k, s, g)], c = {CONSTANT};  // no tables\n"),
        # the compiled layouts' rounds (round_sums) and the compiled block
        # layout's chirp tables (its window in registers from the start)
        ("    const float2 w = twp[(r - 1) * NS + jm];\n",
         f"    const float2 w = {CONSTANT};  // no tables\n"),
        ("    const float2 w = bq[tid + r * NB];\n", f"    const float2 w = {CONSTANT};  // no tables\n"),
        ("      c = wa[n];\n", f"      c = {CONSTANT};  // no tables\n")),
    # the chirp mode's untangle reads the first FFT's output
    4: ((SECOND_FFT, "    const float2* u = y;  // no second FFT\n    (void)other;\n"),
        ("      second_fft<I>(z, tw, bq, tid, group, y);\n",
         "      store_last<I>(z, tid, group, y);  // no second FFT\n")),
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


def probe_source(probe: int, compile_sizes=(), shapes=None) -> str:
    """csrc/dft_mixed.cu with probe `probe`'s edits (PROBES; 0 none), the
    plans of `compile_sizes` (ops/dft.py::fft_plan, radices of 16 at most in
    3 passes at most) added to its COMPILED table, and the block plans of
    `shapes` ({(n, chirp): (threads, groups)}) given those threads a group
    and groups a block in its BLOCK_COMPILED table."""
    from orcai_tpu_torch.ops.dft import fft_plan

    source = (_build.CSRC / "dft_mixed.cu").read_text()
    for (n, chirp), (threads, groups) in (shapes or {}).items():
        radix = ", ".join(map(str, fft_plan(n)))
        row = re.compile(r"(\{\d, \{" + radix + r"\}, \{[\d, ]+\}, \{[\d, ]+\}, "
                         + str(int(chirp)) + r", )\d+, \d+\}")
        if len(row.findall(source)) != 1:
            raise SystemExit(f"probe_mixed: BLOCK_COMPILED holds no plan of {n} once")
        source = row.sub(lambda m: f"{m.group(1)}{threads}, {groups}}}", source)
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


def build_probes(variants, compile_sizes=(), shapes=None) -> tuple[dict, dict]:
    """{(variant, probe): library path} and {name: ptxas lines}, every nvcc
    at once."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for probe in PROBES:
        src = out_dir / f"dft_mixed-p{probe}.cu"
        src.write_text(probe_source(probe, compile_sizes, shapes))
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
    parser.add_argument("--block-shapes", default="",
                        help="n:threads:groups of the block plans compiled whole (nc: the chirp "
                             "mode's plan of M = n), comma-separated")
    parser.add_argument("--frames", type=int, default=32768)
    parser.add_argument("--dtypes", default="int16")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from orcai_tpu_torch.ops.dft import (
        _DTYPE_CODES, _build_variant, _chirp_kernel, _plan_array, _route_tables, _to_f32,
        chirp_length,
        dft_magnitude, dft_magnitude_plain, dft_route, mixed_layout)
    from orcai_tpu_torch.ops.frontend import hann_window
    from orcai_tpu_torch.ops.wire_codec import mulaw_encode

    if not torch.cuda.is_available():
        raise SystemExit("probe_mixed: no CUDA device")
    sizes = [tuple(int(v) for v in s.split("/")) for s in args.sizes.split(",")]
    kinds = args.dtypes.split(",")
    torch_dtype = {"f32": torch.float32, "int16": torch.int16, "uint8": torch.uint8}
    compile_sizes = tuple(int(v) for v in args.compile.split(",") if v)
    shapes = {(int(n.rstrip("c")), n.endswith("c")): (int(t), int(g)) for n, t, g in
              (v.split(":") for v in args.block_shapes.split(",") if v)}
    def chirp(n_fft):  # the chirp mode on the block layout
        return dft_route(n_fft) == "chirp" and _chirp_kernel(n_fft) == "mixed"

    def points(n_fft):  # the FFT's: n_fft, or the chirp mode's convolution length
        return chirp_length(n_fft) if chirp(n_fft) else n_fft

    for n_fft, _ in sizes:
        if dft_route(n_fft) not in ("mixed", "fft") and not chirp(n_fft):
            raise SystemExit(f"probe_mixed: n_fft {n_fft} does not take csrc/dft_mixed.cu")
    variants = sorted({_build_variant("mixed", points(n), torch_dtype[k])
                       for n, _ in sizes for k in kinds})
    paths, ptxas = build_probes(variants, compile_sizes, shapes)
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
        if chirp(n_fft):
            table, roots = _route_tables("chirp", window.tobytes(), dev)
            tables = (None, roots.data_ptr(), table.data_ptr())
        else:
            win, roots = _route_tables("mixed", window.tobytes(), dev)
            tables = (win.data_ptr(), roots.data_ptr(), None)
        for kind in kinds:
            x = torch.from_numpy(host[kind]).to(dev)
            variant = _build_variant("mixed", points(n_fft), x.dtype)
            out = torch.empty((args.frames, n_fft // 2 + 1), dtype=torch.float32, device=dev)

            def launch(probe):
                err = libs[(variant, probe)].orcai_dft_mixed(
                    x.data_ptr(), _DTYPE_CODES[x.dtype], *tables, _plan_array(points(n_fft)),
                    out.data_ptr(), args.frames, n_fft, hop, stream)
                if err != 0:
                    raise SystemExit(f"probe_mixed: {n_fft}/{hop} probe {probe}: CUDA error {err}")

            launch(0)
            err = float((out - dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)).abs().max())
            # the first 2048 frames against the float64 rFFT: the bar where the
            # plain fp32 GEMM itself misses 2e-4 (from 4096 up)
            x64 = x.double() / 32768.0 if kind == "int16" else _to_f32(x).double()
            frames64 = x64[:2047 * hop + n_fft].unfold(0, n_fft, hop)
            exact = torch.fft.rfft(frames64 * torch.from_numpy(window).to(dev), dim=1).abs()
            err64 = float((out[:frames64.shape[0]] - exact).abs().max())
            del x64, frames64, exact
            if not (err <= 2e-4 or err64 <= 2e-4):
                raise SystemExit(f"probe_mixed: {n_fft}/{hop} {kind}: {err} from plain, "
                                 f"{err64} from float64")
            line = {"n_fft": n_fft, "hop": hop, "frames": args.frames, "dtype": kind,
                    "mode": "chirp" if chirp(n_fft) else "fft", "length": points(n_fft),
                    "max_abs_err": err, "max_abs_err_vs_float64": err64,
                    "bound_ms": (x.numel() * x.element_size()
                                 + out.numel() * 4) / HBM_BYTES_PER_S * 1e3,
                    **mixed_layout(n_fft, hop, x.dtype, libs[(variant, 0)])}
            for probe, name in PROBES.items():
                if probe == 4 and not chirp(n_fft):
                    continue  # the FFT mode runs one FFT
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
