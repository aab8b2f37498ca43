"""csrc/dft_cluster.cu taken apart on one CUDA device: where its time goes
between the samples' loads, the passes, the exchange between the CTAs of a
cluster, the tables and the stores.

    python -m orcai_tpu_torch.tools.probe_cluster [--sizes 16384/8192,32768/16384,...]
        [--frames 32768] [--dtypes int16] [--iters 10] [--seed 0]

A size is n_fft/hop or n_fft/hop/frames (frames overrides --frames), on
the cluster route or the chirp mode's cluster layout. Six copies of the
source (`probe_sources`) are compiled into _build/probe_cluster/<probe>/,
each with its own copies of the headers it edits, for each build a size
needs (ops/dft.py::_build_variant):
- kernel: the source as ops/_build.py builds it;
- no_passes: the samples' loads, the exchange and the stores, the
  butterflies and every pass after the first left out;
- no_exchange: every rank's buffer taken as the CTA's own, so that every
  value the exchange would send to another CTA, and every mirror bin the
  chirp mode's untangle would read there, stays local, and no cluster
  barrier (each a __syncthreads instead);
- no_tables: the twiddles, the window and the chirp tables as constants
  made from an index (no load or product; the multiplies they feed stay);
- no_stores: the magnitudes computed and kept live, none stored;
- generic: no plan compiled whole (the plans of 16384, 32768 and 65536
  read at run time, as every other plan is).
For each size and sample type the tool holds the full copy against the
step-by-step reference (ops/dft.py::_fft_cluster_reference or
_chirp_cluster_reference) on the first frames, then times every copy with
CUDA events over --iters launches behind a short device spin. It prints one
JSON line a size and type: the six times, the byte bound (each sample read
once, each magnitude written once, at 3.35 TB/s) and the launch's layout
(ops/dft.py::cluster_layout: CTAs a cluster, threads, CTAs an SM, resident
clusters, shared memory, registers, spilled bytes, whether the plan is
compiled whole); then the builds' ptxas lines, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

from orcai_tpu_torch.ops import _build

PROBES = ("kernel", "no_passes", "no_exchange", "no_tables", "no_stores", "generic")
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 8_000_000  # about 4 ms of device spin ahead of the first event
REFERENCE_FRAMES = 33
# a stand-in for a table's value that no load feeds: 1 + a few ulps, from an index
CONST = "make_float2(__uint_as_float(0x3f800000u | ({} & 7)), 0.0f)"

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
        "dft_cluster.cu": (
            ("    pass<B>(first, second, STRIDE, batch, tw, N, A, tid, threads);\n",
             "    (void)tw;  // no second pass\n    return first;\n", 1),
        ),
    },
    "no_exchange": {
        "dft_cluster.cu": (
            ("peer[r] = cluster.map_shared_rank(za, r);", "peer[r] = za;", 1),
            ("cluster.sync();", "__syncthreads();", 10),
        ),
    },
    "no_tables": {
        "dft_cluster.cu": (
            ("tw(j * k1)", CONST.format("k1"), 1),
            ("tw(k1 * p2)", CONST.format("p2"), 1),
            ("ck[i] = a[k];\n      cm[i] = a[m];",
             f"ck[i] = {CONST.format('k')};\n      cm[i] = {CONST.format('m')};", 1),
        ),
        "dft_batched.cuh": (
            ("w = bq[rows_k1[b] + n1 * e];", f"w = {CONST.format('b')};", 1),
            ("const float2 c = wa[n];", f"const float2 c = {CONST.format('n')};", 1),
            ("const float w = win[n];", "const float w = __uint_as_float(0x3f800000u | (n & 7));",
             1),
        ),
    },
    "no_stores": {
        "dft_batched.cuh": (
            ("  row_a[k] = 0.5f * sqrtf(pr * pr + pi * pi);\n"
             "  if (has_b) row_a[n_bins + k] = 0.5f * sqrtf(qr * qr + qi * qi);\n",
             "  const float ma = 0.5f * sqrtf(pr * pr + pi * pi);\n"
             "  const float mb = 0.5f * sqrtf(qr * qr + qi * qi);\n"
             "  if (__float_as_uint(ma) == 0xFFFFFFFFu && has_b) row_a[k] = mb;  // live\n", 1),
        ),
    },
    "generic": {
        "dft_cluster.cu": (
            ("#if ORCAI_ODD == 17\nusing Compiled = Plans<", "#if 0\nusing Compiled = Plans<", 1),
        ),
    },
}


def probe_sources(probe: str) -> dict[str, str]:
    """{file name: text} of csrc/dft_cluster.cu and the headers of csrc/
    it includes that probe `probe` edits (EDITS), the edits made."""
    files = {"dft_cluster.cu": (_build.CSRC / "dft_cluster.cu").read_text()}
    for name, edits in EDITS.get(probe, {}).items():
        text = files.get(name) or (_build.CSRC / name).read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"probe_cluster: {name} no longer holds {old!r} {count} times")
            text = text.replace(old, new)
        files[name] = text
    return files


def build_probes(variants) -> tuple[dict, dict]:
    """{(variant, probe): library path} and {name: ptxas lines}, every nvcc
    at once."""
    jobs = {}
    for probe in PROBES:
        out_dir = _build.BUILD_DIR / "probe_cluster" / probe
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, text in probe_sources(probe).items():  # "..." includes find these first
            (out_dir / name).write_text(text)
        for variant in variants:
            flags = (*_build._flags(variant), f"-I{_build.CSRC}")
            path = out_dir / f"libdft_cluster{_build._tag(variant)}.so"
            jobs[(variant, probe)] = (path, subprocess.Popen(
                [_build._nvcc(), *flags, "-o", str(path), str(out_dir / "dft_cluster.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths, ptxas = {}, {}
    for (variant, probe), (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"probe_cluster: nvcc failed for {variant} {probe}:\n{log}")
        paths[(variant, probe)] = path
        ptxas[f"odd{variant[0]}-t{variant[1]}-{probe}"] = [
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return paths, ptxas


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default="16384/8192,32768/16384,65536/32768/11251,"
                                           "8198/4099,16418/8209")
    parser.add_argument("--frames", type=int, default=32768)
    parser.add_argument("--dtypes", default="int16")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from orcai_tpu_torch.ops.dft import (
        _DTYPE_CODES, _build_variant, _chirp_cluster_reference, _chirp_kernel,
        _cluster_plan_array, _fft_cluster_reference, _route_tables, chirp_length, cluster_layout,
        dft_route)
    from orcai_tpu_torch.ops.frontend import hann_window
    from orcai_tpu_torch.ops.wire_codec import mulaw_encode

    if not torch.cuda.is_available():
        raise SystemExit("probe_cluster: no CUDA device")
    sizes = []
    for s in args.sizes.split(","):
        values = [int(v) for v in s.split("/")]
        n_fft, hop, frames = (*values, args.frames)[:3]
        route = dft_route(n_fft)
        if route != "cluster" and not (route == "chirp" and _chirp_kernel(n_fft) == "cluster"):
            raise SystemExit(f"probe_cluster: n_fft {n_fft} does not take the cluster layout")
        sizes.append((n_fft, hop, frames, route, chirp_length(n_fft) if route == "chirp"
                      else n_fft))
    kinds = args.dtypes.split(",")
    torch_dtype = {"f32": torch.float32, "int16": torch.int16, "uint8": torch.uint8}
    variants = sorted({_build_variant("cluster", n, torch_dtype[k])
                       for *_, n in sizes for k in kinds})
    paths, ptxas = build_probes(variants)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for key, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.orcai_dft_cluster.argtypes = [ptr, i32, ptr, ptr, ptr, ctypes.POINTER(i32), ptr, i32,
                                          i32, i32, ptr]
        lib.orcai_dft_cluster.restype = i32
        libs[key] = lib
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

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

    for n_fft, hop, frames, route, n in sizes:
        rng = np.random.default_rng(args.seed + n_fft)
        count = (frames - 1) * hop + n_fft
        pcm = rng.integers(-32768, 32768, count, dtype=np.int16)
        host = {"int16": pcm, "uint8": mulaw_encode(pcm),
                "f32": (0.3 * rng.standard_normal(count)).astype(np.float32)}
        window = hann_window(n_fft)
        a, b = _route_tables(route, window.tobytes(), dev)
        tables = ((a.data_ptr(), b.data_ptr(), None) if route == "cluster"
                  else (None, b.data_ptr(), a.data_ptr()))
        reference = _fft_cluster_reference if route == "cluster" else _chirp_cluster_reference
        for kind in kinds:
            x = torch.from_numpy(host[kind]).to(dev)
            variant = _build_variant("cluster", n, x.dtype)
            out = torch.empty((frames, n_fft // 2 + 1), dtype=torch.float32, device=dev)

            def launch(probe):
                err = libs[(variant, probe)].orcai_dft_cluster(
                    x.data_ptr(), _DTYPE_CODES[x.dtype], *tables, _cluster_plan_array(n),
                    out.data_ptr(), frames, n_fft, hop, stream)
                if err != 0:
                    raise SystemExit(f"probe_cluster: {n_fft}/{hop} {probe}: CUDA error {err}")

            launch("kernel")
            ref = reference(x[:(REFERENCE_FRAMES - 1) * hop + n_fft], window, n_fft=n_fft,
                            hop=hop)
            err = float((out[:REFERENCE_FRAMES] - ref).abs().max())
            if not err <= 2e-4:
                raise SystemExit(f"probe_cluster: {n_fft}/{hop} {kind}: {err} from the reference")
            line = {"n_fft": n_fft, "hop": hop, "frames": frames, "dtype": kind, "route": route,
                    "length": n, "max_abs_err_vs_reference": err,
                    "bound_ms": (x.numel() * x.element_size() + out.numel() * 4)
                    / HBM_BYTES_PER_S * 1e3,
                    **cluster_layout(n_fft, hop, x.dtype, libs[(variant, "kernel")])}
            for probe in PROBES:
                line[f"{probe}_ms"] = cuda_ms(lambda: launch(probe))
            print(json.dumps(line), flush=True)
            del x, out
    print(json.dumps({"ptxas": ptxas}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
