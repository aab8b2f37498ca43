#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orcai_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line and failing the run on any error:

  env      torch/CUDA versions, the device, its capability and power limit
  build    compiles csrc/*.cu with nvcc (one process per source, together)
  kernels  holds each kernel against its plain PyTorch version on the card
           at main-path shapes (B1 dft_magnitude at a 32768-frame tile,
           f32 and int16, atol 2e-4; B2 digit_histograms at all three
           digit levels and select_order_statistics on 38.5 M magnitudes,
           bit-exact) and times kernel, plain version and a library call
           (the selection is torch ops over three B2 launches, no kernel
           of its own: it prints on a line of its own, not as a kernel)
  golden   `predict` on tests/fixtures/golden.wav with the bundled orcai-v1
           weights in float32 on cuda: the TSV must be byte-equal to
           tests/fixtures/golden_expected.txt
  full     `predict` on a 20-minute 48 kHz int16 recording synthesized from
           --seed (the main path whose kernel launches are reported), the
           frontend and CRNN timed on their own, the outputs checked
           (finite, in range, the spectrogram against the port's CPU path
           and the CRNN against the CPU model on a few windows)

Then one {"selection": {...}} line, one {"kernels": [...]} line, the card's `name, power.limit` from
nvidia-smi, and last {"ok": true, "device": {...}}. Exits non-zero, with no
result, when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
MINUTES = 20.0  # the throughput cell: 225001 frames, 7 real tiles, 610 windows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flop: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_env(torch) -> dict:
    cap = torch.cuda.get_device_capability(0)
    info = {
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "capability": list(cap),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
    }
    if cap != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a; device capability is {cap}")
    return info


def phase_build() -> dict:
    from orcai_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    resources = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "built": sorted(logs), "ptxas": resources}


def phase_kernels(torch, seed: int) -> tuple[dict, dict]:
    """Kernel vs plain on the card; returns (phase line, per-kernel rows)."""
    import numpy as np

    from orcai_tpu_torch.ops.dft import dft_magnitude, dft_magnitude_plain
    from orcai_tpu_torch.ops.frontend import _dft_mats
    from orcai_tpu_torch.ops.radix_select import (
        digit_histograms,
        digit_histograms_plain,
        select_order_statistics,
        select_order_statistics_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n_fft, hop, tile = 512, 256, 32768
    C, S = (torch.from_numpy(m.copy()).to(dev) for m in _dft_mats(n_fft))
    n_bins = C.shape[1]
    n_samp = (tile - 1) * hop + n_fft
    x32 = torch.from_numpy(
        (0.3 * rng.standard_normal(n_samp)).astype(np.float32)).to(dev)
    x16 = torch.from_numpy(
        rng.integers(-32768, 32768, n_samp, dtype=np.int16)).to(dev)
    errs = {}
    for name, x in (("f32", x32), ("int16", x16)):
        got = dft_magnitude(x, C, S, n_fft=n_fft, hop=hop)
        want = dft_magnitude_plain(x, C, S, n_fft=n_fft, hop=hop)
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        if not errs[name] <= 2e-4:
            raise AssertionError(f"B1 {name}: max |kernel - plain| {errs[name]} > 2e-4")
    win = torch.hann_window(n_fft, periodic=True, device=dev)
    b1_bytes = n_samp * 4 + 2 * n_fft * n_bins * 4 + tile * n_bins * 4
    b1_bound, b1_by = bound(b1_bytes, 4.0 * tile * n_fft * n_bins)
    b1 = {
        "name": "dft_magnitude", "route": "cuda",
        "source": "orcai_tpu_torch/csrc/dft_magnitude.cu",
        "replaces": "orcai_tpu/ops/pallas_dft.py:67",
        "max_abs_err": max(errs.values()),
        "ms": cuda_ms(lambda: dft_magnitude(x32, C, S, n_fft=n_fft, hop=hop)),
        "ms_int16": cuda_ms(lambda: dft_magnitude(x16, C, S, n_fft=n_fft, hop=hop)),
        "plain_ms": cuda_ms(lambda: dft_magnitude_plain(x32, C, S, n_fft=n_fft, hop=hop)),
        "bound_ms": b1_bound, "bound_by": b1_by,
        "library_ms": cuda_ms(lambda: torch.stft(
            x32, n_fft, hop_length=hop, window=win, center=False,
            return_complex=True).abs()),
        "shape": f"tile {tile} frames x {n_bins} bins",
    }

    # 20-minute main-path shape: 225001 valid frames x 171 bins inside the
    # 262144-frame bucket, the padding rows zero as the frontend leaves them
    n_valid_elems, n_total = 225001 * 171, 262144 * 171
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.zeros(n_total, dtype=torch.float32, device=dev)
    flat[:n_valid_elems] = (
        torch.randn(n_valid_elems, generator=g, device=dev).abs()
        * torch.exp(3.0 * torch.randn(n_valid_elems, generator=g, device=dev)))
    flat[: n_valid_elems : 97] = 0.125  # heavy ties across a digit boundary
    nv = torch.full((1,), n_valid_elems, dtype=torch.int32, device=dev)
    k_lo = torch.full((1,), int(np.round(0.01 * (n_valid_elems - 1))), dtype=torch.int64, device=dev)
    k_hi = torch.full((1,), int(np.round(0.999 * (n_valid_elems - 1))), dtype=torch.int64, device=dev)
    lo, hi = select_order_statistics(flat, nv, k_lo, k_hi)
    lo_p, hi_p = select_order_statistics_plain(flat, nv, k_lo, k_hi)
    if not (torch.equal(lo, lo_p) and torch.equal(hi, hi_p)):
        raise AssertionError(f"selection {lo.item()}, {hi.item()} != sort {lo_p.item()}, {hi_p.item()}")
    # the three digit levels, with the prefixes the selection walks through
    b_lo = int(lo.view(torch.int32)) & 0xFFFFFFFF
    b_hi = int(hi.view(torch.int32)) & 0xFFFFFFFF
    levels = [
        (21, 11, None, (0, 0)),
        (10, 11, 21, (b_lo >> 21, b_hi >> 21)),
        (0, 10, 10, (b_lo >> 10, b_hi >> 10)),
    ]
    b2_err = 0.0
    for shift, bits, pshift, pref in levels:
        p = torch.tensor(pref, dtype=torch.int32, device=dev)
        got = digit_histograms(flat, nv, p, shift, bits, pshift)
        want = digit_histograms_plain(flat, nv, p, shift, bits, pshift)
        b2_err = max(b2_err, float((got.double() - want.double()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"B2 level shift={shift}: kernel != plain bincount")
    zeros2 = torch.zeros(2, dtype=torch.int32, device=dev)
    b2_bound, b2_by = bound(n_valid_elems * 4 + 2 * 2048 * 4, 0.0)
    b2 = {
        "name": "digit_histograms", "route": "cuda",
        "source": "orcai_tpu_torch/csrc/digit_hist.cu",
        "replaces": "orcai_tpu/ops/pallas_hist.py:117",
        "max_abs_err": b2_err,
        "ms": cuda_ms(lambda: digit_histograms(flat, nv, zeros2, 21, 11, None)),
        "plain_ms": cuda_ms(lambda: digit_histograms_plain(flat, nv, zeros2, 21, 11, None)),
        "bound_ms": b2_bound, "bound_by": b2_by, "library_ms": None,
        "shape": f"{n_valid_elems} valid of {n_total}, level 0",
    }
    sel_bound, sel_by = bound(n_valid_elems * 4, 0.0)
    valid = flat[:n_valid_elems]
    ks = (int(k_lo) + 1, int(k_hi) + 1)
    sel = {
        "name": "select_order_statistics", "route": "torch over B2",
        "source": "orcai_tpu_torch/ops/radix_select.py",
        "replaces": "orcai_tpu/ops/pallas_hist.py:178",
        "max_abs_err": float(torch.cat([lo - lo_p, hi - hi_p]).abs().max()),
        "ms": cuda_ms(lambda: select_order_statistics(flat, nv, k_lo, k_hi)),
        "plain_ms": cuda_ms(lambda: select_order_statistics_plain(flat, nv, k_lo, k_hi)),
        "bound_ms": sel_bound, "bound_by": sel_by,
        # two kthvalue calls, one per order statistic
        "library_ms": cuda_ms(lambda: (
            torch.kthvalue(valid, ks[0]), torch.kthvalue(valid, ks[1]))),
        "shape": f"{n_valid_elems} valid magnitudes, 3 sweeps of B2",
    }
    line = {"phase": "kernels", "b1_max_abs_err": errs,
            "b2_levels_bit_exact": True, "selection_bit_equal_sort": True}
    return line, {r["name"]: r for r in (b1, b2)}, sel


def _counters():
    from orcai_tpu_torch.ops.dft import dft_magnitude
    from orcai_tpu_torch.ops.radix_select import digit_histograms

    return (dft_magnitude, digit_histograms)


def reset_counts() -> None:
    for fn in _counters():
        fn.launches = 0


def read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _counters()}


def phase_golden(torch, tmp: Path) -> dict:
    from orcai_tpu_torch.pipeline.predict import predict

    out = tmp / "golden_pred.txt"
    reset_counts()
    t0 = time.perf_counter()
    predict(FIXTURES / "golden.wav", output_path=out, overwrite=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    same = out.read_bytes() == (FIXTURES / "golden_expected.txt").read_bytes()
    if not same:
        raise AssertionError(
            "golden TSV differs from tests/fixtures/golden_expected.txt:\n"
            + out.read_text())
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the golden path: {counts}")
    return {"phase": "golden", "tsv_byte_equal": True, "wall_s_first_call": wall,
            "launches": counts}


def phase_full(torch, tmp: Path, seed: int) -> tuple[dict, dict]:
    import numpy as np

    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.io.wav import load_wav_for_frontend
    from orcai_tpu_torch.ops.frontend import compute_spectrogram_device
    from orcai_tpu_torch.ops.overlap import WindowPredictor
    from orcai_tpu_torch.pipeline.predict import predict
    from orcai_tpu_torch.tools.synthetic import synth_recording

    wav = tmp / "synthetic_20min.wav"
    n = synth_recording(wav, seed, MINUTES)
    model, param, shape = load_orcai_model(device="cuda")
    sp = param["spectrogram"]
    predictor = WindowPredictor(model, snippet_len=shape["input_shape"][0],
                                n_filters=len(param["model"]["filters"]),
                                batch_size=128)
    args = (sp["sampling_rate"], sp["nfft"], sp["n_overlap"], sp["freq_range"],
            sp["quantiles"])

    # the main path, through the user's entry point; its launches are reported
    out = tmp / "synthetic_pred.txt"
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    predict(wav, output_path=out, overwrite=True, predictor=predictor)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the main path: {counts}")
    n_rows = len(out.read_text().splitlines()) - 1

    # stage times on the warm process (host clock around synchronized work)
    audio, _ = load_wav_for_frontend(wav, sr=sp["sampling_rate"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, n_frames, _, _ = compute_spectrogram_device(audio, *args, device="cuda")
    torch.cuda.synchronize()
    t_front = time.perf_counter() - t0
    t0 = time.perf_counter()
    agg, count, n_out = predictor.aggregate_device(spec, n_frames=n_frames)
    torch.cuda.synchronize()
    t_crnn = time.perf_counter() - t0
    aggregated, overlap = predictor.fetch_aggregated(agg, count, n_out)

    # output checks: shapes, ranges, and the port's CPU path as reference
    n_win = predictor.plan(n_frames)[0]
    spec_v = spec[:n_frames].cpu().numpy()
    if spec_v.shape != (1 + n // sp["n_overlap"], shape["input_shape"][1]):
        raise AssertionError(f"spectrogram shape {spec_v.shape}")
    if not (np.isfinite(spec_v).all() and spec_v.min() >= 0 and spec_v.max() <= 1):
        raise AssertionError("spectrogram not finite in [0, 1]")
    if aggregated.shape != (n_frames // predictor.down, model.num_labels):
        raise AssertionError(f"aggregated shape {aggregated.shape}")
    if not (np.isfinite(aggregated).all() and aggregated.min() >= 0 and aggregated.max() <= 1):
        raise AssertionError("aggregated probabilities not finite in [0, 1]")
    if set(np.unique(overlap[: (n_win - 1) * predictor.shift_out])) - {1.0, 2.0}:
        raise AssertionError("overlap counts outside {1, 2}")
    spec_cpu, _, _, _ = compute_spectrogram_device(audio, *args, device="cpu")
    spec_err = float(np.abs(spec_cpu[:n_frames].numpy() - spec_v).max())
    if not spec_err <= 2e-4:
        raise AssertionError(f"spectrogram cuda vs cpu: {spec_err} > 2e-4")
    step, snip = predictor.shift, predictor.snippet_len
    windows = torch.stack([spec[i * step : i * step + snip] for i in range(0, 64, 8)])[..., None]
    model_cpu, _, _ = load_orcai_model(device="cpu")
    with torch.inference_mode():
        crnn_err = float((model(windows).cpu() - model_cpu(windows.cpu())).abs().max())
    if not crnn_err <= 2e-5:
        raise AssertionError(f"CRNN cuda vs cpu: {crnn_err} > 2e-5")
    line = {
        "phase": "full", "minutes": MINUTES, "samples": n, "frames": n_frames,
        "windows": n_win, "batch_size": predictor.batch_size,
        "predict_wall_s": wall, "frontend_wall_s": t_front, "crnn_wall_s": t_crnn,
        "peak_device_bytes": peak, "tsv_rows": n_rows, "launches": counts,
        "spectrogram_max_abs_err_vs_cpu": spec_err,
        "crnn_max_abs_err_vs_cpu": crnn_err,
    }
    return line, counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from orcai_tpu_torch.utils.device import exact_f32_math

    phase = "env"
    try:
        env = phase_env(torch)
        emit(env)
        phase = "build"
        emit(phase_build())
        # the f32 CRNN checks and stage timings below call the model directly
        with exact_f32_math(), tempfile.TemporaryDirectory() as tmp:
            phase = "kernels"
            line, rows, sel = phase_kernels(torch, args.seed)
            emit(line)
            phase = "golden"
            emit(phase_golden(torch, Path(tmp)))
            phase = "full"
            line, counts = phase_full(torch, Path(tmp), args.seed)
            emit(line)
    except Exception as e:  # report the phase, then fail the run
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    for name, row in rows.items():
        row["launches"] = counts[name]
    # not a kernel: torch ops over B2, whose main-path launches it made
    sel["b2_launches"] = counts["digit_histograms"]
    emit({"selection": sel})
    emit({"kernels": list(rows.values())})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
