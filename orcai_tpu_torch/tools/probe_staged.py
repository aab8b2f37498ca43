"""csrc/dft_staged.cu taken apart on one CUDA device, in either mode: where
its time goes between the samples' loads, the passes, the four-step
twiddles, the scratch's trips between its kernels and the magnitudes'
stores.

    python -m orcai_tpu_torch.tools.probe_staged [--sizes 131072/65536/2048,...]
        [--dtypes int16,uint8,f32] [--iters 10] [--seed 0]

A size is n_fft/hop/frames on the staged route: the FFT mode's two kernels
(the default sizes) or the chirp mode's three (40962/20481/2048,
49154/24577/301). Copies of the
source (`probe_sources`) are compiled into _build/probe_staged/<probe>/,
each with its own copies of the headers it edits, for each build a size
needs (ops/dft.py::_build_variant):
- kernel: the source as ops/_build.py builds it;
- no_passes: the loads, the twiddles and the stores, the butterflies and
  every pass after the first left out (a side compiled whole hands its
  first pass's outputs to its last step);
- no_twiddles: the four-step twiddles (kernel 1's, and in the chirp mode
  kernel 2's) a constant made from an index (no table read or product;
  the multiply they feed stays);
- no_sample_loads: kernel 1's samples and window (in the chirp mode w a)
  constants (made from an index, or zeros where they are staged);
- no_scratch_stores: kernel 1's products (in the chirp mode kernel 2's
  too) computed and kept live, none stored to the scratch;
- no_row_loads: the scratch's reads (kernel 2's rows, and in the chirp
  mode kernel 3's columns) constants made from an index;
- no_magnitude_stores: the last kernel's magnitudes computed and kept
  live, none stored;
- no_zero_rows: every first pass (generic or compiled whole) reads only
  the first half of each butterfly's inputs, the rest zeros the compiler
  folds: in the chirp mode's kernel 1 at 40962 and 49154 exactly the rows
  at and above n_fft / N2, which hold zeros (read that kernel's time
  alone: the edit reaches the other kernels' first passes too).
The edits of a probe are made where its text is (EDITS); a text the
source no longer holds stops the tool. For each size and sample type the
tool holds the kernel against the step-by-step reference (ops/dft.py::
_staged_reference, or _chirp_staged_reference) on the first frames, then
times every copy with CUDA
events over --iters calls behind a short device spin, and traces --iters
calls of each under torch.profiler for each kernel's device time a call
and its share. It prints one JSON line a size and type: each copy's ms and
its kernels' ms, the byte bound (each sample read once, each magnitude
written once, at 3.35 TB/s), the bytes each kernel moves by the design's
count over its time (tools/trace_staged.py::pair_bytes) and the launch's
layout (ops/dft.py::staged_layout); then
the builds' ptxas lines, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from orcai_tpu_torch.ops import _build

DEFAULT_SIZES = "131072/65536/2048,98304/49152/2048"
PROBES = ("kernel", "no_passes", "no_twiddles", "no_sample_loads", "no_scratch_stores",
          "no_row_loads", "no_magnitude_stores", "no_zero_rows")
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 8_000_000  # about 4 ms of device spin ahead of the first event
REFERENCE_FRAMES = 33
# a stand-in for a value that no load feeds: 1 + a few ulps, from an index
CONST = "make_float2(__uint_as_float(0x3f800000u | (({}) & 7)), 0.0f)"
LIVE = "if (__float_as_uint({v}.x) == 0xFFFFFFFFu) {store};  // kept live, not stored"

# each probe's edits: {file: ((the text, what takes its place, how often it
# is there), ...)}; a text that is not found that often stops the tool
EDITS = {
    "no_passes": {
        "dft_batched.cuh": (
            ("      dft(re, im);\n#pragma unroll\n      for (int r = 0; r < R; ++r) "
             "dst[(j * R + r) * stride + b]",
             "#pragma unroll\n      for (int r = 0; r < R; ++r) dst[(j * R + r) * stride + b]", 1),
            ("  for (int p = 1; p < side.n_passes; ++p) {", "  for (int p = 1; p < 1; ++p) {", 1),
            ("      dft(re, im);\n#pragma unroll\n      for (int r = 0; r < R; ++r) "
             "dst[(base + r * ns) * stride + b]",
             "#pragma unroll\n      for (int r = 0; r < R; ++r) "
             "dst[(base + r * ns) * stride + b]", 1),
        ),
        "dft_staged.cu": (
            ("      dft(re[k], im[k]);\n", "", 1),
            ("    fixed_pass<R, NS, N, BATCH, THREADS, READS_BUF>(\n"
             "        load, tw, tid, [&](int e, int b, float2 v) { buf[e * STRIDE + b] = v; });\n"
             "    __syncthreads();\n"
             "    Passes<N, BATCH, STRIDE, THREADS, NS * R, true, LAST_BUF, R2, RS...>::run(\n"
             "        Local{buf, STRIDE}, buf, NS > 1 ? tw + (R - 1) * NS : tw, tid, last);\n",
             "    fixed_pass<R, NS, N, BATCH, THREADS, READS_BUF && LAST_BUF>(load, tw, tid, last);\n",
             1),
        ),
    },
    "no_twiddles": {
        "dft_staged.cu": (
            ("twiddle(lo, hi, tw_log2, k1 * j)", CONST.format("k1 * j"), 2),
            ("twiddle(lo, hi, tw_log2, w.o * j)", CONST.format("w.o * j"), 2),
            ("twiddle(lo, hi, tw_log2, k1 * w.i)", CONST.format("k1 * w.i"), 1),
        ),
    },
    "no_sample_loads": {
        "dft_batched.cuh": (
            ("    const float w = win[n];\n"
             "    return make_float2(w * sample_to_f32(xa[n]), has_b ? w * sample_to_f32(xb[n]) "
             ": 0.0f);",
             f"    return {CONST.format('n')};", 1),
        ),
        "dft_staged.cu": (
            ("        v[k] = *reinterpret_cast<const V*>(src + at(row) + (i % PER_ROW) * VEC);",
             "        v[k] = V{};", 1),
            ("        if (BYTES * q < bytes) a[k] = word[0];\n"
             "        if (lead[k] != 0 && BYTES * (q + 1) < bytes) b[k] = word[1];\n", "", 1),
            ("    return chirp_input(wa[n], sample_to_f32(xa[n]), has_b ? sample_to_f32(xb[n]) : "
             "0.0f);", f"    return {CONST.format('n')};", 1),
        ),
    },
    "no_scratch_stores": {
        "dft_staged.cu": (
            ("s[k1 * n2 + j] = twiddled(v, twiddle(lo, hi, tw_log2, k1 * j));",
             "const float2 u = twiddled(v, twiddle(lo, hi, tw_log2, k1 * j));\n"
             + LIVE.format(v="u", store="s[k1 * n2 + j] = u"), 2),
            ("s[w.o * n2 + j] = twiddled(y[w.o * plan.cstride + w.i], twiddle(lo, hi, tw_log2, "
             "w.o * j));",
             "const float2 u = twiddled(y[w.o * plan.cstride + w.i], twiddle(lo, hi, tw_log2, "
             "w.o * j));\n" + LIVE.format(v="u", store="s[w.o * n2 + j] = u"), 2),
            ("s[k1 * n2 + w.i] = twiddled(g[w.i * stride + w.o], twiddle(lo, hi, tw_log2, k1 * w.i));",
             "const float2 u = twiddled(g[w.i * stride + w.o], twiddle(lo, hi, tw_log2, k1 * w.i));\n"
             + LIVE.format(v="u", store="s[k1 * n2 + w.i] = u"), 1),
        ),
    },
    "no_row_loads": {
        "dft_staged.cu": (
            ("if (f < items) v[i] = s[rows_k1[f / n2] * n2 + f % n2];",
             f"if (f < items) v[i] = {CONST.format('f')};", 1),
            ("return b < ncols ? s[e * n2 + cols[b]] : make_float2(0.0f, 0.0f);",
             f"return {CONST.format('e * n2 + b')};", 1),
        ),
    },
    "no_magnitude_stores": {
        "dft_batched.cuh": (
            ("  row_a[k] = 0.5f * sqrtf(pr * pr + pi * pi);\n"
             "  if (has_b) row_a[n_bins + k] = 0.5f * sqrtf(qr * qr + qi * qi);\n",
             "  const float ma = 0.5f * sqrtf(pr * pr + pi * pi);\n"
             "  const float mb = 0.5f * sqrtf(qr * qr + qi * qi);\n"
             "  if (__float_as_uint(ma) == 0xFFFFFFFFu && has_b) row_a[k] = mb;  // live\n", 1),
        ),
    },
    "no_zero_rows": {
        "dft_batched.cuh": (
            ("      const float2 v = load(j + r * nb, b);",
             "      const float2 v = r < R / 2 ? load(j + r * nb, b) : make_float2(0.0f, 0.0f);", 1),
        ),
        "dft_staged.cu": (
            ("        const float2 v = load(j + r * NB, b);",
             "        const float2 v = NS > 1 || r < R / 2 ? load(j + r * NB, b) "
             ": make_float2(0.0f, 0.0f);", 1),
        ),
    },
}


def probe_sources(probe: str) -> dict[str, str]:
    """{file name: text} of csrc/dft_staged.cu and the headers of csrc/ it
    includes that probe `probe` edits (EDITS), the edits made."""
    files = {"dft_staged.cu": (_build.CSRC / "dft_staged.cu").read_text()}
    for name, edits in EDITS.get(probe, {}).items():
        text = files.get(name) or (_build.CSRC / name).read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"probe_staged: {name} no longer holds {old!r} {count} times")
            text = text.replace(old, new)
        files[name] = text
    return files


def build_probes(variants) -> tuple[dict, dict]:
    """{(variant, probe): library path} and {name: ptxas lines}, every nvcc
    at once."""
    jobs = {}
    for probe in PROBES:
        out_dir = _build.BUILD_DIR / "probe_staged" / probe
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, text in probe_sources(probe).items():  # "..." includes find these first
            (out_dir / name).write_text(text)
        for variant in variants:
            flags = (*_build._flags(variant), f"-I{_build.CSRC}")
            path = out_dir / f"libdft_staged{_build._tag(variant)}.so"
            jobs[(variant, probe)] = (path, subprocess.Popen(
                [_build._nvcc(), *flags, "-o", str(path), str(out_dir / "dft_staged.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths, ptxas = {}, {}
    for (variant, probe), (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"probe_staged: nvcc failed for {variant} {probe}:\n{log}")
        paths[(variant, probe)] = path
        ptxas[f"odd{variant[0]}-{probe}"] = [
            ln.strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return paths, ptxas


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default=DEFAULT_SIZES)
    parser.add_argument("--dtypes", default="int16,uint8,f32")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import ctypes

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orcai_tpu_torch.ops import dft
    from orcai_tpu_torch.ops.frontend import hann_window
    from orcai_tpu_torch.ops.wire_codec import mulaw_encode
    from orcai_tpu_torch.tools.trace_staged import kernel_name, pair_bytes

    if not torch.cuda.is_available():
        raise SystemExit("probe_staged: no CUDA device")
    sizes = []
    for s in args.sizes.split(","):
        n_fft, hop, frames = (int(v) for v in s.split("/"))
        if dft.dft_route(n_fft) != "staged":
            raise SystemExit(f"probe_staged: n_fft {n_fft} does not take the staged route")
        sizes.append((n_fft, hop, frames))
    kinds = args.dtypes.split(",")
    torch_dtype = {"f32": torch.float32, "int16": torch.int16, "uint8": torch.uint8}
    def length(n_fft):  # the FFT's points: n_fft, or the chirp mode's M
        return n_fft if dft.staged_mode(n_fft) == "fft" else dft.chirp_length(n_fft)

    variants = sorted({dft._build_variant("staged", length(n), torch_dtype[k])
                       for n, _, _ in sizes for k in kinds})
    paths, ptxas = build_probes(variants)
    libs = {key: ctypes.CDLL(str(path)) for key, path in paths.items()}
    dev = torch.device("cuda")

    def cuda_ms(fn) -> float:
        for _ in range(2):
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

    def traced(fn) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for evt in prof.key_averages():
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = evt.self_cuda_time_total
            if evt.device_type == DeviceType.CUDA and t > 0:
                name = kernel_name(evt.key)
                kernels[name] = kernels.get(name, 0.0) + t / 1e3 / args.iters
        return kernels

    for n_fft, hop, frames in sizes:
        rng = np.random.default_rng(args.seed + n_fft)
        count = (frames - 1) * hop + n_fft
        pcm = rng.integers(-32768, 32768, count, dtype=np.int16)
        host = {"int16": pcm, "uint8": mulaw_encode(pcm),
                "f32": (0.3 * rng.standard_normal(count)).astype(np.float32)}
        window = hann_window(n_fft)
        for kind in kinds:
            x = torch.from_numpy(host[kind]).to(dev)
            m = length(n_fft)
            variant = dft._build_variant("staged", m, x.dtype)
            out = torch.empty((frames, n_fft // 2 + 1), dtype=torch.float32, device=dev)

            def launch(probe):
                err = dft._launch_staged(x, window, out, n_fft, hop,
                                         library=libs[(variant, probe)])
                if err != 0:
                    raise SystemExit(f"probe_staged: {n_fft}/{hop} {probe}: CUDA error {err}")

            launch("kernel")
            reference = (dft._staged_reference if m == n_fft else dft._chirp_staged_reference)
            ref = reference(x[:(REFERENCE_FRAMES - 1) * hop + n_fft], window, n_fft=n_fft, hop=hop)
            err = float((out[:REFERENCE_FRAMES] - ref).abs().max())
            if not err <= 2e-4:
                raise SystemExit(f"probe_staged: {n_fft}/{hop} {kind}: {err} from the reference")
            line = {"n_fft": n_fft, "hop": hop, "frames": frames, "dtype": kind,
                    "mode": dft.staged_mode(n_fft), "length": m,
                    "plan": list(dft.staged_plan(m)), "max_abs_err_vs_reference": err,
                    "bound_ms": (x.numel() * x.element_size() + out.numel() * 4)
                    / HBM_BYTES_PER_S * 1e3,
                    "layout": dft.staged_layout(n_fft, x.dtype, libs[(variant, "kernel")])}
            pairs = (frames + 1) // 2
            for probe in PROBES:
                line[f"{probe}_ms"] = cuda_ms(lambda: launch(probe))
                kernels = traced(lambda: launch(probe))
                line[f"{probe}_kernels_ms"] = kernels
                if probe == "kernel":
                    line["kernel_tb_per_s"] = {
                        name: pair_bytes(name, n_fft, hop, m, x.element_size()) * pairs
                        / (ms * 1e-3) / 1e12 for name, ms in kernels.items() if ms}
            print(json.dumps(line), flush=True)
            del x, out
            torch.cuda.empty_cache()
    print(json.dumps({"ptxas": ptxas}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
