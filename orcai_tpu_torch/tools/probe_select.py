"""The selection of two order statistics (ops/radix_select.py over
csrc/digit_hist.cu) taken apart on one CUDA device, in memory and
streamed, for one tree of this package or for two in turns.

    python -m orcai_tpu_torch.tools.probe_select --trees A [B] [--rounds 2]
        [--iters 50] [--traces 5] [--long-repeats 14] [--seed 0] [--no-streamed]

A and B are directories that hold an orcai_tpu_torch package (this
checkout, or another commit's unpacked with `git archive`). The packages
share a name, so each run is a process of its own that imports its tree's
package; with two trees the runs go A, B, B, A for each of --rounds, and
the summary gives each number's median over a tree's runs. A run:

- In memory, at the 20-minute shape: `synth_magnitudes` from --seed,
  225001 x 171 valid values in a 262144 x 171 buffer, the ranks of the
  0.01 and 0.999 quantiles (ops/frontend.py::nearest_quantile_index).
  The selection as ops/frontend.py::finalize makes it (where the tree has
  `select_order_statistics_at`, on host integers; else three `torch.full`
  fills and `select_order_statistics` on their tensors), held bit-equal to
  a sort, then timed with CUDA events over --iters selections behind a
  short device spin; the same for `select_order_statistics` on tensors
  made beforehand, and for one `digit_histograms` sweep at each level
  (the prefixes of the two targets read from the sort). Then --traces
  selections, each behind a spin, under torch.profiler (CUPTI): every
  device launch of a selection in order, its device time and the idle
  gap before it (the first's after the spin), and the selection's wall
  from its first launch's start to its last one's end; the medians over
  the traces.
- Streamed, with the audio resident: the 20-minute sweep recording of
  tools/synthetic.py --long-repeats times over (14: 4 h 40 min, 13 stats
  tiles of 262144 frames), made once by the calling process, through
  `StreamingPredictor` at the default tiles: pass 1
  (`_select_percentiles`) once to warm, three times on the host clock
  between synchronizations (its wall), then once under torch.profiler
  inside a `record_function` span: the launches of each level (split at
  each level's last B2 sweep), the device idle from each level's last
  sweep to the next level's first B1 launch, and after the third level
  the time from the last sweep's end to the host's return from the pass
  where the host returned later (0 where it returned first: the device
  was still busy).

Prints one JSON line a run, then with two trees one summary line (the
medians, whether the trees' order statistics are bit-equal in memory
and streamed), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


RUN = r"""
import json, os, statistics, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from orcai_tpu_torch.ops import radix_select as rs
from orcai_tpu_torch.ops.frontend import nearest_quantile_index
from orcai_tpu_torch.tools.synthetic import synth_magnitudes

cfg = json.loads(sys.argv[2])
dev = torch.device("cuda")
SPIN = 8_000_000  # about 4 ms at the card's clock


def event_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def short(name):
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            return name[:i]
    return name


def traced(fn):
    # (device events as (name, start us, duration us) in order, host spans
    # of the record_function marks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device = sorted(
        ((short(e["name"]), float(e["ts"]), float(e["dur"])) for e in events
         if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")),
        key=lambda e: e[1])
    marks = {e["name"]: (float(e["ts"]), float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    return device, marks


def bits_of(x):
    return int(torch.as_tensor(x).reshape(-1)[:1].cpu().view(torch.int32)[0])


out = {"tree": sys.argv[1], "finalize_form": "select_order_statistics_at"
       if hasattr(rs, "select_order_statistics_at") else "3 torch.full + select_order_statistics"}

# -- in memory ----------------------------------------------------------
n_valid, n_total = 225001 * 171, 262144 * 171
flat = synth_magnitudes(n_valid, n_total, cfg["seed"], dev)
k_lo, k_hi = (nearest_quantile_index(q, n_valid) for q in (0.01, 0.999))


def selection():
    if hasattr(rs, "select_order_statistics_at"):
        return rs.select_order_statistics_at(flat, n_valid, k_lo, k_hi)
    return rs.select_order_statistics(
        flat, torch.full((1,), n_valid, dtype=torch.int32, device=dev),
        torch.full((1,), k_lo, dtype=torch.int64, device=dev),
        torch.full((1,), k_hi, dtype=torch.int64, device=dev))


nv = torch.full((1,), n_valid, dtype=torch.int32, device=dev)
ks = [torch.full((1,), k, dtype=torch.int64, device=dev) for k in (k_lo, k_hi)]
ordered = torch.sort(flat[:n_valid]).values
want = [bits_of(ordered[k]) for k in (k_lo, k_hi)]
got = [bits_of(v) for v in selection()]
got_tensors = [bits_of(v) for v in rs.select_order_statistics(flat, nv, *ks)]
if got != want or got_tensors != want:
    raise AssertionError(f"selection {got} / {got_tensors} != sort {want}")
out["order_statistics_bits"] = got
targets = torch.tensor(want, dtype=torch.int64)
level_prefixes = [torch.zeros(2, dtype=torch.int32, device=dev),
                  (targets >> 21).to(torch.int32).to(dev), (targets >> 10).to(torch.int32).to(dev)]
del ordered
out["selection_ms"] = event_ms(selection, cfg["iters"])
out["selection_tensors_ms"] = event_ms(lambda: rs.select_order_statistics(flat, nv, *ks),
                                       cfg["iters"])
out["b2_level_ms"] = [
    event_ms(lambda: rs.digit_histograms(flat, nv, p, shift, bits, pshift), cfg["iters"])
    for p, (shift, bits, pshift) in zip(level_prefixes, rs._LEVELS)]


def spun_selections():
    for _ in range(cfg["traces"]):
        torch.cuda._sleep(SPIN)
        selection()
        torch.cuda.synchronize()


device, _ = traced(spun_selections)
runs, cur = [], None
for name, ts, dur in device:
    if "spin" in name:
        cur = {"launches": [], "prev_end": ts + dur}
        runs.append(cur)
    elif cur is not None:
        cur["launches"].append({"name": name, "device_us": dur,
                                "gap_before_us": ts - cur["prev_end"]})
        cur["start"] = cur.get("start", ts)
        cur["prev_end"] = ts + dur
counts = {len(r["launches"]) for r in runs}
if len(runs) != cfg["traces"] or len(counts) != 1:
    raise AssertionError(f"traced selections {len(runs)}, launches {counts}")
table = []
for i, first in enumerate(runs[0]["launches"]):
    table.append({"name": first["name"],
                  "device_us": statistics.median(r["launches"][i]["device_us"] for r in runs),
                  "gap_before_us": statistics.median(r["launches"][i]["gap_before_us"]
                                                     for r in runs)})
out["selection_launches"] = table
out["selection_wall_us"] = statistics.median(r["prev_end"] - r["start"] for r in runs)
out["selection_device_us"] = sum(row["device_us"] for row in table)
out["selection_gaps_us"] = sum(row["gap_before_us"] for row in table[1:])
del flat
torch.cuda.empty_cache()

# -- streamed, the audio resident ------------------------------------------
if cfg["long_wav"]:
    from scipy.io import wavfile

    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.ops.overlap import WindowPredictor
    from orcai_tpu_torch.ops.streaming import StreamingPredictor

    model, param, shape = load_orcai_model(device="cuda")
    sp = param["spectrogram"]
    predictor = WindowPredictor(model, snippet_len=shape["input_shape"][0],
                                n_filters=len(param["model"]["filters"]), batch_size=128)
    _, pcm = wavfile.read(cfg["long_wav"], mmap=True)
    streaming = StreamingPredictor(predictor, sp)
    with torch.inference_mode():
        source, n_frames = streaming.source(pcm)
        if not source.resident:
            raise AssertionError("the long recording's audio is not resident")
        n_tiles = -(-n_frames // streaming.stats_tile_frames)
        stats = streaming._select_percentiles(source, n_frames)
        out["streamed_bits"] = [bits_of(v) for v in stats[1:]]
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streaming._select_percentiles(source, n_frames)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        def pass1():
            with record_function("pass1"):
                streaming._select_percentiles(source, n_frames)

        # the trace has been seen to miss a few of its first launches: a
        # pass whose three levels' sweeps are not all there is traced again
        for _ in range(3):
            device, marks = traced(pass1)
            b2 = [i for i, e in enumerate(device) if "digit_hist" in e[0]]
            if len(b2) == 3 * n_tiles:
                break
        else:
            raise AssertionError(f"{len(b2)} B2 sweeps traced, expected {3 * n_tiles}")
    host_end = sum(marks["pass1"])
    is_b1 = lambda e: "dft" in e[0] or "fft" in e[0] or "magnitude" in e[0]
    cuts = [b2[(level + 1) * n_tiles - 1] for level in range(3)]
    levels, idle, start = [], [], 0
    for level, cut in enumerate(cuts):
        segment = device[start : cut + 1]
        names = {}
        for e in segment:
            names[e[0]] = names.get(e[0], 0) + 1
        levels.append({"launches": len(segment), "by_name": names,
                       "device_us": sum(e[2] for e in segment)})
        end = device[cut][1] + device[cut][2]
        if level < 2:
            nxt = next(i for i in range(cut + 1, len(device)) if is_b1(device[i]))
            between = device[cut + 1 : nxt]
            idle.append(device[nxt][1] - end - sum(e[2] for e in between))
            tail = between
        else:
            tail = device[cut + 1 :]
            idle.append(max(0.0, host_end - max(e[1] + e[2] for e in device)))
        levels[-1]["after_last_sweep"] = [e[0] for e in tail]
        start = cut + 1
    span = device[-1][1] + device[-1][2] - device[0][1]
    out["streamed"] = {
        "frames": n_frames, "stats_tiles": n_tiles, "pass1_wall_s": walls,
        "pass1_wall_s_median": statistics.median(walls), "levels": levels,
        "idle_after_level_us": idle, "device_span_us": span,
        "device_idle_us": span - sum(e[2] for e in device),
        "host_return_us_after_first_launch": host_end - device[0][1],
    }
print(json.dumps(out), flush=True)
"""

SUMMED = ("selection_ms", "selection_tensors_ms", "selection_wall_us", "selection_device_us",
          "selection_gaps_us")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", required=True, metavar="TREE")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--traces", type=int, default=5)
    parser.add_argument("--long-repeats", type=int, default=14)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-streamed", action="store_true")
    args = parser.parse_args(argv)
    if len(args.trees) > 2:
        raise SystemExit("probe_select: one tree or two")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_select: no CUDA device")
    from orcai_tpu_torch.tools.synthetic import synth_long_recording, synth_sweep_wav

    trees = [str(Path(t).resolve()) for t in args.trees]
    order = trees if len(trees) == 1 else [*trees, *reversed(trees)] * args.rounds
    runs = {t: [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        long_wav = ""
        if not args.no_streamed:
            short_wav, long_wav = Path(tmp) / "sweep.wav", str(Path(tmp) / "long.wav")
            synth_sweep_wav(short_wav, args.seed, 20.0)
            synth_long_recording(long_wav, short_wav, args.seed, args.long_repeats)
        cfg = json.dumps({"seed": args.seed, "iters": args.iters, "traces": args.traces,
                          "long_wav": long_wav})
        for tree in order:
            proc = subprocess.run([sys.executable, "-c", RUN, tree, cfg],
                                  capture_output=True, text=True, timeout=1800)
            if proc.returncode != 0:
                raise SystemExit(f"probe_select: the run of {tree} failed:\n{proc.stderr[-3000:]}")
            runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[tree][-1]), flush=True)
    if len(trees) == 2:
        summary = {"order": "A B B A", "rounds": args.rounds, "trees": args.trees}
        for name, tree in zip(("A", "B"), trees):
            rs = runs[tree]
            med = {k: statistics.median(r[k] for r in rs) for k in SUMMED}
            med["b2_level_ms"] = [statistics.median(r["b2_level_ms"][i] for r in rs)
                                  for i in range(3)]
            med["selection_launches"] = len(rs[0]["selection_launches"])
            if "streamed" in rs[0]:
                med["pass1_wall_s"] = statistics.median(
                    w for r in rs for w in r["streamed"]["pass1_wall_s"])
                med["idle_after_level_us"] = [
                    statistics.median(r["streamed"]["idle_after_level_us"][i] for r in rs)
                    for i in range(3)]
                med["device_idle_us"] = statistics.median(
                    r["streamed"]["device_idle_us"] for r in rs)
            summary[name] = med
        a, b = (runs[t][0] for t in trees)
        summary["bit_equal_in_memory"] = a["order_statistics_bits"] == b["order_statistics_bits"]
        if "streamed_bits" in a:
            summary["bit_equal_streamed"] = a["streamed_bits"] == b["streamed_bits"]
        print(json.dumps(summary), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
