"""Where the time of one warm `predict` goes, on a CUDA device.

    python -m orcai_tpu_torch.tools.profile_predict [--seed 0]
        [--trace_dir DIR] [--long_repeats 14]

Takes the throughput cell of chip_smoke.py: a 20-minute 48 kHz int16
recording synthesized from --seed (tools/synthetic.py) through the bundled
orcai-v1 model in float32 at batch 128. Builds the predictor once,
runs `predict` once to warm up, then times each stage of a second run under
torch.profiler: wav load, frontend (spectrogram), CRNN windows with
overlap-add, and the fetch/decode/TSV tail. For each stage it prints one
JSON line with the host wall time (around synchronized work), the summed
device kernel time, the device idle share (1 - kernel time / wall) and the
top kernels by device time. With --trace_dir it also writes a Chrome trace
per stage there.

Then the same recording goes through the two-pass streaming path
(ops/streaming.py) with its audio resident on the device and host-sliced,
staged as source (the upload, when resident), pass 1 (statistics) and
pass 2 (inference). With --long_repeats N the recording is written N times
over (tools/synthetic.py::synth_long_recording) and those three stages are
timed on it too, with the host clock and without the profiler, whose trace
of that many kernels would not fit.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

MINUTES = 20.0
BATCH_SIZE = 128


def wall_stage(torch, name: str, fn):
    """fn() timed by the host clock around synchronized work; one JSON line."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(json.dumps({"stage": name, "wall_s": time.perf_counter() - t0}), flush=True)
    return out


def streaming_stages(torch, stage, predictor, sp, audio, label: str, budget: int):
    """The streaming path's three steps on `audio`, each through `stage`."""
    from orcai_tpu_torch.ops.streaming import StreamingPredictor

    streaming = StreamingPredictor(predictor, sp, hbm_audio_budget=budget)
    with torch.inference_mode():
        source, n_frames = stage(f"{label}_source", lambda: streaming.source(audio))
        stats = stage(f"{label}_pass1_stats",
                      lambda: streaming._select_percentiles(source, n_frames))
        grids = stage(f"{label}_pass2_inference",
                      lambda: streaming._infer(source, n_frames, *stats))
    return predictor.fetch_aggregated(*grids)


def profile_stage(torch, name: str, fn, trace_dir: Path | None, top: int = 12):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [
        (e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) * 1e-6
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / f"profile_{name}.json"))
    line = {
        "stage": name, "wall_s": wall, "device_kernel_s": busy_s,
        "device_idle_share": max(0.0, 1.0 - busy_s / wall) if wall > 0 else None,
        "top_kernels": [
            {"kernel": k[:90], "ms": us * 1e-3, "calls": c} for k, us, c in rows[:top]
        ],
    }
    print(json.dumps(line), flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace_dir", default=None)
    parser.add_argument("--long_repeats", type=int, default=0,
                        help="also time the streaming stages on the recording "
                             "written this many times over (default: 0, skip)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_predict: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.io.wav import load_wav_for_frontend
    from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device
    from orcai_tpu_torch.ops.overlap import WindowPredictor
    from orcai_tpu_torch.pipeline.predict import _finish_wav, predict, save_predictions
    from orcai_tpu_torch.tools.synthetic import synth_long_recording, synth_sweep_wav
    from orcai_tpu_torch.utils.device import exact_f32_math

    trace_dir = Path(args.trace_dir) if args.trace_dir else None
    model, param, shape = load_orcai_model(device="cuda")
    sp = param["spectrogram"]
    predictor = WindowPredictor(
        model, snippet_len=shape["input_shape"][0],
        n_filters=len(param["model"]["filters"]), batch_size=BATCH_SIZE,
    )
    with exact_f32_math(), tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "synthetic.wav"
        synth_sweep_wav(wav, args.seed, MINUTES)
        out = Path(tmp) / "pred.txt"
        predict(wav, output_path=out, overwrite=True, predictor=predictor)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(wav, output_path=out, overwrite=True, predictor=predictor)
        torch.cuda.synchronize()
        print(json.dumps({"stage": "predict_total_unprofiled",
                          "wall_s": time.perf_counter() - t0,
                          "device": torch.cuda.get_device_name(0)}), flush=True)

        audio, _ = profile_stage(
            torch, "wav_load",
            lambda: load_wav_for_frontend(wav, sr=sp["sampling_rate"]), trace_dir)
        spec, n_frames, _, times = profile_stage(
            torch, "frontend",
            lambda: make_spectrogram_from_params_device(audio, sp), trace_dir)
        agg, count, n_out = profile_stage(
            torch, "crnn_overlap_add",
            lambda: predictor.aggregate_device(spec, n_frames=n_frames), trace_dir)
        disp = {"mode": "device", "agg_dev": agg, "count_dev": count, "n_out": n_out,
                "delta_t": float(times[1] - times[0])}

        def tail():
            labels, _, delta_t = _finish_wav(disp, predictor, param)
            save_predictions(labels, out, delta_t)

        profile_stage(torch, "fetch_decode_tsv", tail, trace_dir)
        del spec, agg, count, disp

        def profiled(name, fn):
            return profile_stage(torch, name, fn, trace_dir, top=8)

        for label, budget in (("stream_resident", 1 << 40), ("stream_host_sliced", 0)):
            streaming_stages(torch, profiled, predictor, sp, audio, label, budget)
        if args.long_repeats:
            long_wav = Path(tmp) / "synthetic_long.wav"
            synth_long_recording(long_wav, wav, args.seed, args.long_repeats)
            long_audio, _ = load_wav_for_frontend(long_wav, sr=sp["sampling_rate"])

            def timed(name, fn):
                return wall_stage(torch, name, fn)

            for label, budget in (("long_resident", 1 << 40), ("long_host_sliced", 0)):
                streaming_stages(torch, timed, predictor, sp, long_audio, label, budget)
    return 0


if __name__ == "__main__":
    sys.exit(main())
