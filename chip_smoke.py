#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orcai_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line with its wall in `seconds` and failing
the run on any error:

  env      torch/CUDA versions, the device, its capability and power limit
  build    compiles csrc/*.cu with nvcc (one process per library, together):
           the wall, each library's, every kernel's registers and spills
           (none may spill)
  kernels  holds each kernel against its plain PyTorch version on the card
           at main-path shapes (B1 dft_magnitude at a 32768-frame tile and
           on a ragged and an unaligned one, f32 and int16, atol 2e-4; B2
           digit_histograms at all three digit levels on 38.5 M magnitudes,
           on an offset view and with ragged valid counts, bit-exact; the
           pick kernel bit-equal on the three levels and an edge set;
           select_order_statistics bit-equal to a sort) and times kernel,
           plain version and a library call (the selection is three B2
           sweeps and three picks, no kernel of its own: it prints on a
           line of its own, not as a kernel); B1 and B2 again at the
           streaming path's shapes (B1 on the 188784-frame normalize tile
           and the 262144-frame stats tile in int16, B2 on a stats tile's
           44.8 M values with a ragged valid count, all three levels)
  golden   `predict` on tests/fixtures/golden.wav with the bundled orcai-v1
           weights in float32 on cuda: the TSV must be byte-equal to
           tests/fixtures/golden_expected.txt
  full     `predict` on a 20-minute 48 kHz int16 recording synthesized from
           --seed (the main path whose kernel launches are reported), the
           frontend and CRNN timed on their own, B2 and the selection timed
           on that recording's real magnitudes, the outputs checked
           (finite, in range, the spectrogram against the port's CPU path
           and the CRNN against the CPU model on a few windows)

  streaming  the two-pass streaming path (ops/streaming.py) through
           `predict`: the 20-minute recording with
           ORCAI_TPU_STREAM_SPEC_BYTES=1, the audio resident and host-sliced
           (TSV byte-equal to the in-memory one, aggregate within 1e-5,
           counts equal, B1 = 5 and B2 = 3 launches), the golden wav at the
           default tiles (byte-equal TSV), then a 4 h 40 min recording (the
           20-minute PCM 14 times over, each repeat at its own gain) that
           streams at the default budgets, resident and host-sliced: equal
           TSVs, finite outputs in [0, 1], overlap counts in {1, 2}, exact
           launches, and the host-sliced peak device memory within 64 MB
           of the 20-minute host-sliced run's
  table_serve  a three-row recording table (golden, the 20-minute wav, a
           missing file) through `predict` with probabilities and the
           default duration limits, then `serve` over a folder with the
           same two wavs: both reproduce the single-file TSVs byte for byte
  train    model development at the bundled orcai-v1's width (ResNetLSTM,
           filters 30/40/50/60, 2x BiLSTM-128, input 736 x 171 x 1, 7
           labels, batch 64, float32): a train/val/test directory of 512 /
           128 / 70 snippets cut from the 20-minute recording's spectrogram
           with labels that follow band energy (tools/synthetic.py);
           `train` from fresh weights for 3 epochs with the data resident
           on the card, then `train(load_model=True)` for one more with the
           streaming runner; losses finite and falling; a run killed after
           epoch 2 and started again against the uninterrupted history;
           the resident and the streaming runner over one epoch from the
           same state; `predict` on the golden wav with the trained model
           (B1 1, B2 3, pick 3 launches); one step from the bundled weights
           at dropout 0 on the card and on the CPU (loss and gradients);
           step time, epoch walls, peak device memory
  test_model  `test_model` on that directory: four CSVs and the metrics
           JSON, all 70 snippets counted, the same bytes with a slab of one
           batch; then the dense trunk (WindowPredictor(dense_trunk=True))
           against the windowed path on the golden spectrogram, and both
           CRNN walls on the 20-minute recording
  data_prep  the data chain on a synthetic project at orcai-v1's widths (3
           recordings of 20 minutes from --seed, 8 calls a minute over the 7
           labels; one recording without annotation, one with BR and BUZZ
           not possible; the default parameter file with n_batch
           train/val/test cut from 3750/375/375 to 8/2/2 at batch 64):
           create-recording-table, create-spectrograms on cuda, its report's
           stage walls (B1 7, B2 3, pick 3 launches per annotated recording; each
           store bit-equal to the frontend run in this process and within
           2e-4 of its plain versions on the card), create-label-arrays
           ((frames, 7), masked columns at MASK_VALUE), create-snippet-table,
           create-tvt-snippet-tables, create-tvt-data (shapes [736, 171, 1]
           and [46, 7]) and one train epoch on the result (finite loss);
           stage walls, the zarr codec, bytes written, peak device memory

  wires    the coded and spectral wires: B1 against its plain version on a
           32768-frame tile, the ragged 11251-frame one and a uint8 view one
           byte off alignment (atol 2e-4; against the float64 rFFT where the
           plain fp32 GEMM itself misses it, at 4096 and above): the mixed
           route at (n_fft, hop) 384/192, 352/176, 1024/256, 4096/2048 and
           8192/4096 in float32, int16 and uint8 mu-law codes and at
           768/384, 704/352, 2048/512, 416/208, with radix 17 at 1088/544
           and 4352/2176, with radix 19 at 1216/608 and with radix 23 at
           1472/736 and 368/184 in int16 and uint8, with radices 29 and 31
           at 464/232, 496/248, 1856/928 and 1984/992 in all three types,
           also at streamed sp-bfp5's 188784- and 262144-frame tiles at
           384/192; the cluster route at 16384/8192 (4 CTAs) and 32768/16384
           (8; two CTAs an SM) in all three types and at 65536/32768 (8
           CTAs, one an SM; all three plans compiled whole) in int16 and
           uint8 on the 11251-frame tile, and at 20736/10368 (4 CTAs) and
           40960/20480 (8; both two an SM, both on the generic kernel, which
           serves every plan with an odd radix) in all three types on the
           11251-frame tile (at 32768 and up, where the plain GEMM's
           tables are 4.3 and 17 GB, against the kernel's arithmetic step by
           step on the card on a 33-frame tile and against the float64 rFFT
           on every frame); the chirp route at 2038/1019 and 470/235 (block
           layout), 8198/4099 and 16418/8209 (cluster layout, 4 and 8 CTAs,
           two an SM; 16418 also on a 301-frame tile) and 24578/12289 (8
           CTAs, one an SM, on the 11251-frame tile, held as 65536 is), the
           staged route at
           40962/20481 (its chirp mode) on a 301-frame tile (against the
           plain version in int16, 6.7 GB of tables) and a 2048-frame one,
           at 131072/65536 and 98304/49152 (its FFT mode) on 2048 frames and
           at 14848/7424 (2^9 * 29), at 17856, 33408 and 270336 (the FFT
           mode's other columns compiled whole, in all three types) and
           49154/24577 (its chirp mode on M =
           289 x 361) on a 301-frame tile (each also against its arithmetic
           step by step on the card and the float64 rFFT; 3 kernels a chunk
           in the chirp mode, 2 in the FFT mode), at the top of its reach
           on 3 frames: 262144/131072 within 2e-4, 2^20/2^19 (FFT mode) and
           (2^20 - 2)/(2^19 - 1) (chirp mode) where no float32 FFT holds
           2e-4 within C1_FACTOR of float32 torch.fft.rfft's own error from
           the float64 rFFT (ROADMAP C1), the staged kernels called directly at 65536/32768 beside
           the cluster route, the GEMM kernel called directly at 40962 on
           301 frames and through dft_magnitude at n_fft 1 (its route's
           one size below 2^20; 1 launch, no B2 or pick), and the FFT route
           at 512/256 in uint8; the cluster layout at each of its sizes (CTAs
           a cluster, threads, CTAs an SM, clusters the card holds at once,
           a plan compiled whole: asserted), the staged layout at each of its
           sizes (each kernel compiled whole or not, CTAs an SM, registers,
           no spill: asserted), B1 at n_fft 1 timed beside its plain version,
           torch.stft and its bound; B1 of the codes bit-equal to B1
           of their int16 decode on every route; the new sizes no farther
           from the float64 rFFT than the plain version; kernel, plain,
           torch.stft and the GEMM kernel called directly at the same n_fft
           (on a 301-frame tile above 8192), timed side by side; `predict`
           on golden through mulaw8, bfp6, bfp5, sp-bfp6, sp-bfp5 and
           sp11-bfp5, each inside the reference's golden bar (B1 1, B2 3,
           pick 3 launches on the wire's
           route: the spectral wires on the mixed route); create-spectrograms
           through the CLI on a one-minute project at nfft 416, 1216 and
           1856 (B1 1 on the mixed route), 2038 and 16418 (the chirp route
           on the block and the cluster layout), 16384 (the cluster route),
           40962 and 131072 (the staged route's two modes), B2 3, pick 3;
           the store against the CPU path within 2e-4 (at 131072, whose
           plain tables are 68.7 GB, bit-equal to the frontend on cuda);
           the 20-minute recording in memory on exact, mulaw8, bfp5
           and sp-bfp5 (7 / 3 / 3 launches, the spectrogram within 2e-4 of the
           port's CPU path on the same wire, the frontend's wall, device copy
           and kernel time, host encode or resample time and bytes uploaded);
           streamed on mulaw8 and sp-bfp5, resident and host-sliced (5 / 3
           launches, the two TSVs byte-equal, the aggregate held to the
           in-memory one of the same wire); the host C codecs loaded

  hpsearch  Hyperband (train/hpsearch.py) over default_hps_parameter.json at
           its full widths (filter sets 10-40, 20-50, 30-60, LSTM 64/128,
           dropout 0.3/0.4/0.5, kernel 3/5/7, batch 64, 736 x 171 x 1, 7
           labels) with the default parameter file at seed 7, on the train
           phase's 512 / 128 snippets (8 steps an epoch), max_epochs 2 and
           factor 2: 2 brackets, 5 rung-trials, 8 trial-epochs, promotions
           carrying weights; each trial's epoch walls and peak device memory;
           the same call again, every trial CACHED and the outputs equal but
           the status column; golden through the best model's directory (B1
           1, B2 3, pick 3 launches)
  first_epoch  where a first epoch's extra wall goes
           (tools/profile_first_epoch.py): in this process, a shape of the
           search space that no trial ran, the same shape in a fresh model,
           and a second new shape under torch.profiler, each trained two
           resident epochs with build, move, init, the first step's stages,
           the other steps and the evaluation timed and the allocator's
           counters read; then orcai-v1's width in three fresh processes that
           trained nothing before (as it is, with the weight initialiser's
           and Adam's first calls timed apart, and after predicting the
           20-minute recording)
  bf16     predict with ORCAI_TPU_PREDICT_DTYPE=bf16: golden in memory and
           streamed byte-equal to golden_expected.txt (1 / 3 / 3 and 4 / 3
           launches), the 20-minute cell's warm wall beside float32's and
           its aggregated probabilities' distance from float32's
  bf16_train  `train` with compute_dtype bfloat16 at orcai-v1's width, batch
           64, one epoch: warm step ms, peak memory, the loss beside the
           float32 run's; the saved weights float32 and loaded back
  architectures  ResNet1DConv and ResNetTCN at orcai-v1's widths: two
           resident epochs through `train`, warm step ms, peak memory, the
           forward on the card against the CPU (2e-5), golden through the
           trained directory (1 / 3 / 3)
  warmup_serve  `python -m orcai_tpu_torch warmup --minutes 1`, then `serve`
           over a folder holding golden in a cold process and in one given
           --warm_minutes 1: both TSVs byte-equal to golden's, the warm-up's
           wall, each first file's latency and the service's console report
  reference_formats  the reference's own formats, from
           tests/fixtures/reference_formats (written by Keras and TensorFlow,
           which the card does not have): `convert-dataset` through the CLI
           on GZIP tf.data snapshots of 8 and 4 samples at orcai-v1's shapes
           (every file's sha256 as in expected.json, the JAX package's
           output; a second run skips both splits; -ow and -o write the same
           bytes), the conversion's wall and MB/s in this process, one epoch
           at orcai-v1's widths, batch 4, on the converted data; the
           orcai-v1.keras dir and a dir holding only its model.weights.h5 as
           model_weights.h5, each loaded on cuda bit-equal to the bundled
           msgpack (load walls beside the msgpack's) and predicting golden in
           memory (1 / 3 / 3) and streamed (4 / 3) byte-equal to
           golden_expected.txt; `train --load_model` with the .keras dir as
           the model dir, its weights before the first step bit-equal to the
           bundled ones
  parallel  parallel/ on the one card: the plain Trainer and the distributed
           one (DDP, BatchNorm statistics all-reduced, the loss's count
           global) in an NCCL group of one rank, 8 steps at batch 64 from
           the bundled weights (losses, weights and statistics within
           RUNNER_RTOL, both step times); `train(load_model=True)` from the
           bundled weights over ["cuda:0", "cuda:0"] (two spawned processes
           in a gloo group, 32 + 32 of each batch) against one process, one
           epoch (history, weights and statistics within RUNNER_RTOL); 8
           steps at 64 from the bundled weights over two gloo ranks through
           the distributed Trainer and through a plain DDP wrap (the
           control), each against one process: the first step's gradients
           and the BatchNorm statistics' change within RUNNER_RTOL, the
           weights' change within PAR_CHANGE_RTOL, the control above all
           three, each run also read against the first step in float64 and
           the two ranks against one process running their synced
           BatchNorm (read, not held); before it, grad_split
           (tools/probe_grad_split.py on the first batch of 64 in this
           process: two 32-row halves against the 64 rows with BatchNorm on
           running statistics, cuDNN on and off, the training step with
           cuDNN's and the synced BatchNorm, each against float64); after
           it, tensor_parallel: TP_STEPS (3) steps at 64 from the bundled
           weights over a (1 data x 2 model) grid of gloo ranks sharing the
           card, the parameters sharded (parallel/sharding_rules.py), against
           one process's same steps: losses, first gradients and the
           statistics' change
           within RUNNER_RTOL, the weights' change within PAR_CHANGE_RTOL,
           each rank's parameter bytes and the step ms; a search without --parallel over ["cuda:0", "cuda:0"]
           (its one trial data-parallel over two spawned processes) against
           the same search on one device (the trial, its config, its losses
           within RUNNER_RTOL); the bundled predictor split over ["cuda:0", "cuda:0"]: golden
           byte-equal in memory (1 / 3 / 3) and streamed (4 / 3), the
           20-minute TSV byte-equal (7 / 3 / 3) and its aggregate within 1e-6
           of one replica's; two processes joined through a launcher's
           environment running create-spectrograms over the data_prep
           project and predict over a three-row table (stores and TSVs
           byte-equal to one process's) and a search on the train phase's
           data (max_epochs 2, factor 2: 5 rung-trials at the default
           space's widths; each trial recorded once, process 1 publishing
           nothing, the rerun all CACHED). One card: no time here is a
           multi-GPU speed-up

Then one {"selection": {...}} line, one {"kernels": [...]} line (B1 as six
rows, its FFT, mixed-radix, cluster, chirp, staged and point routes; the GEMM
kernel, which no route reaches, is the phase wires' yardstick; the run fails
if a row's kernel no path launched), the card's `name, power.limit` from
nvidia-smi, and last {"ok": true, "device": {...}}. Exits non-zero, with no
result, when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
MINUTES = 20.0  # the throughput cell: 225001 frames, 7 real tiles, 610 windows
LONG_REPEATS = 14  # the streaming cell: 4 h 40 min, 3150001 frames, 8559 windows
STATS_TILE, CHUNK_TILE = 1 << 18, (512 + 1) * 368  # the streaming path's tiles, frames
B1_TILES = (32768, 11251)  # frames: the in-memory tile, golden's (odd, ragged) count
GEMM_FRAMES = 301  # frames of B1's tile at 40962 (the GEMM route's last size until the
#   staged route), of 16418's old GEMM tile and of the GEMM kernel called directly above
#   8192: its time grows as n_fft^2
GEMM_NFFT = 40962  # above PLAIN_MAX, the one n_fft held against the plain version (int16,
#   GEMM_FRAMES frames: 6.7 GB of tables) and timed against the GEMM kernel called directly
STAGED_FRAMES = 2048  # frames of B1's tiles on the staged route (0.27 GB of int16 at 131072)
PLAIN_MAX = 16418  # the largest n_fft held against B1's plain version but GEMM_NFFT:
#   at 24578, 32768 and 65536 its tables are 2.4, 4.3 and 17 GB in float32, 68.7 GB at
#   131072, built through float64 on the host; the step-by-step reference holds those
B1_SHORT = 33  # frames of the step-by-step reference run on the card above PLAIN_MAX
C1_FRAMES = 3  # frames of B1's tiles at the top of the staged route's reach (2^20)
STAGED_COMPILED_CTAS = 3  # CTAs an SM of a staged kernel compiled whole (one buffer)
STAGED_GENERIC_CTAS = 2  # CTAs an SM of a staged kernel that reads its plan at run time
CTA_RESERVED_BYTES = 1024  # shared memory the card keeps for each CTA
# the staged FFT mode's sides compiled whole that no other size here runs, one
# size each on GEMM_FRAMES frames (n_fft: N1 x N2, the compiled side): columns
# of 64 and 128 points 16 a CTA and of 512 points 8 a CTA
STAGED_COLUMN_SIZES = (17856, 33408, 270336)  # 64 x 279, 128 x 261, 512 x 528
# whether the staged chirp mode's column side (its kernels 1 and 3) runs
# compiled whole at its sizes here: 40962 on M = 256 x 323, 49154 on 289 x 361,
# 2^20 - 2 on 2^21 = 512 x 4096
STAGED_CHIRP_COMPILED = {40962: True, 49154: False, (1 << 20) - 2: True}
C1_HOLDS_MAX = 1 << 19  # the largest n_fft where B1 holds 2e-4 of the float64 rFFT: above,
#   magnitudes that grow with n_fft take any float32 FFT past it (ROADMAP C1)
C1_FACTOR = 1.25  # above C1_HOLDS_MAX, B1 within this factor of float32 torch.fft.rfft's
#   own error from the float64 rFFT, against float64 and its reference (the CPU tests'
#   factor, tests/test_torch_kernels_plain.py::C1_FACTOR; the card reads 0.55-0.63x)
PEAK_SLACK_BYTES = 64 * 1024 * 1024
TVT_SNIPPETS = (512, 128, 70)  # train / val / test; 70 leaves a remainder batch at 64
TRAIN_EPOCHS, TRAIN_LR = 3, 1e-3
RUNNER_RTOL = 5e-3  # resident against streaming epoch metrics, same state (read
#                     1.7e-5 and 1.1e-4: the batches are the same, cuDNN's sums are not)
RESUME_ATOL = 1e-1  # resumed against uninterrupted history. cuDNN's backward is not
#                     deterministic and the difference grows by the step (read 0.0067,
#                     0.0063 and 0.012 after 24 steps, as much between two epochs that both
#                     ran before the cut); a run that started over would be off by the 0.3
#                     that the loss falls in an epoch. Exact on the CPU (the tests).
CPU_STEP_RTOL = 5e-3  # card against CPU: loss, and gradients over the largest gradient
#                       (read 6e-8 and 7e-4: the two sum in other orders)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SPIN_CYCLES = 8_000_000  # about 4 ms at the card's clock


def emit(obj: dict) -> None:
    """One result line on the process's standard output (the phases' console
    reports go to standard error, main())."""
    print(json.dumps(obj), file=sys.__stdout__, flush=True)


def emit_phase(line: dict, t0: float) -> None:
    """A phase's result line with its wall in `seconds` from t0 (a phase
    that times itself keeps its own)."""
    line.setdefault("seconds", time.perf_counter() - t0)
    emit(line)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters`
    back-to-back runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # a few ms of spinning on the device ahead of the first event lets the
    # host queue the launches, so its launch overhead is not timed as theirs
    # (without it a kernel of a few microseconds reads as the ~20 us that
    # the host needs per launch); _sleep is torch's own test helper
    torch.cuda._sleep(SPIN_CYCLES)
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
    # ptxas's "N bytes spill stores, M bytes spill loads" a kernel: none may
    # spill to local memory
    spills = [f"{name}: {ln}" for name, lines in resources.items() for ln in lines
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
    if spills:
        raise AssertionError(f"kernels spill: {spills}")
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "libraries": len(logs), "library_seconds": _build.build.seconds,
            "built": sorted(logs), "ptxas": resources, "spills": spills}


def _b1_checks(torch, rng, dev) -> tuple[dict, dict]:
    """B1 against its plain version (atol 2e-4, the reference suite's DFT
    bar) at the main path's tile, on a ragged tile and on a view that is not
    16-byte aligned; returns (errors, timing inputs)."""
    import numpy as np

    from orcai_tpu_torch.ops.dft import dft_magnitude, dft_magnitude_plain
    from orcai_tpu_torch.ops.frontend import hann_window

    n_fft, hop, tile = 512, 256, 32768
    window = hann_window(n_fft)

    def audio(n_frames, kind):
        n = (n_frames - 1) * hop + n_fft
        if kind == "int16":
            return torch.from_numpy(rng.integers(-32768, 32768, n, dtype=np.int16)).to(dev)
        return torch.from_numpy((0.3 * rng.standard_normal(n)).astype(np.float32)).to(dev)

    x32, x16 = audio(tile, "f32"), audio(tile, "int16")
    # golden's frame count: odd, and no multiple of the kernel's 32-frame block
    r32, r16 = audio(11251, "f32"), audio(11251, "int16")
    shifted = torch.empty(r32.shape[0] + 1, dtype=torch.float32, device=dev)
    shifted[1:] = r32
    cases = {"f32": x32, "int16": x16, "ragged_f32": r32, "ragged_int16": r16,
             "ragged_f32_unaligned": shifted[1:]}
    errs = {}
    for name, x in cases.items():
        got = dft_magnitude(x, window, n_fft=n_fft, hop=hop)
        want = dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"B1 {name}: shape {tuple(got.shape)}")
        errs[name] = float((got - want).abs().max())
        if not errs[name] <= 2e-4:
            raise AssertionError(f"B1 {name}: max |kernel - plain| {errs[name]} > 2e-4")
    # both against the float64 FFT of the same windowed frames
    frames = x32.double().unfold(0, n_fft, hop) * torch.from_numpy(window).to(dev)
    exact = torch.fft.rfft(frames, dim=1).abs()
    vs64 = {
        "kernel": float((dft_magnitude(x32, window, n_fft=n_fft, hop=hop) - exact).abs().max()),
        "plain": float((dft_magnitude_plain(x32, window, n_fft=n_fft, hop=hop) - exact).abs().max()),
    }
    return errs, {"x32": x32, "x16": x16, "window": window, "vs64": vs64,
                  "n_fft": n_fft, "hop": hop, "tile": tile}


def _streaming_shape_checks(torch, rng, dev, window) -> tuple[dict, dict]:
    """B1 and B2 against their plain versions at the streaming path's
    shapes; returns (errors, times and bounds for the kernels' rows)."""
    import numpy as np

    from orcai_tpu_torch.ops.dft import dft_magnitude, dft_magnitude_plain
    from orcai_tpu_torch.ops.radix_select import (
        _LEVELS, digit_histograms, digit_histograms_plain, radix_pick_plain,
    )

    n_fft, hop, n_bins, crop = 512, 256, 257, 171
    errs, extra = {}, {}
    for name, frames in (("normalize_tile", CHUNK_TILE), ("stats_tile", STATS_TILE)):
        n = (frames - 1) * hop + n_fft
        x = torch.from_numpy(rng.integers(-32768, 32768, n, dtype=np.int16)).to(dev)
        got = dft_magnitude(x, window, n_fft=n_fft, hop=hop)
        want = dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != (frames, n_bins) or not err <= 2e-4:
            raise AssertionError(f"B1 {name} ({frames} frames, int16): "
                                 f"shape {tuple(got.shape)}, max |kernel - plain| {err}")
        errs[f"b1_{name}_int16"] = err
        del got, want
        extra[f"b1_ms_{name}_int16"] = cuda_ms(
            lambda: dft_magnitude(x, window, n_fft=n_fft, hop=hop), iters=5)
        extra[f"b1_bound_ms_{name}_int16"] = bound(n * 2 + frames * n_bins * 4, 0.0)[0]
        del x
    # a stats tile's cropped magnitudes: |normal| * exp(3 normal) in the
    # 20-minute recording's 225001 valid frames (an odd count), zeros after
    n_total, n_valid = STATS_TILE * crop, 225001 * crop
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    flat = torch.zeros(n_total, dtype=torch.float32, device=dev)
    flat[:n_valid] = torch.randn(n_valid, generator=g, device=dev).abs() * torch.exp(
        3.0 * torch.randn(n_valid, generator=g, device=dev))
    nv = torch.full((1,), n_valid, dtype=torch.int32, device=dev)
    ranks = torch.tensor([int(0.01 * n_valid), int(0.999 * n_valid)], dtype=torch.int64,
                         device=dev)
    prefixes = torch.zeros(2, dtype=torch.int32, device=dev)
    worst = 0.0
    for level, (shift, bits, pshift) in enumerate(_LEVELS):
        got = digit_histograms(flat, nv, prefixes, shift, bits, pshift)
        want = digit_histograms_plain(flat, nv, prefixes, shift, bits, pshift)
        worst = max(worst, float((got.double() - want.double()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"B2 stats tile, level {level}: kernel != plain bincount")
        if int(got[0].sum()) != n_valid and pshift is None:
            raise AssertionError("B2 stats tile: level 0 does not count every valid value")
        extra[f"b2_ms_stats_tile_level{level}"] = cuda_ms(
            lambda: digit_histograms(flat, nv, prefixes, shift, bits, pshift))
        prefixes, ranks = radix_pick_plain(want, ranks, prefixes, bits, pshift is None)
    errs["b2_stats_tile"] = worst
    extra["b2_bound_ms_stats_tile"] = bound(n_valid * 4 + 2 * 2048 * 4, 0.0)[0]
    return errs, extra


def _pick_checks(torch, dev, level_hists, level_ranks, level_prefixes) -> float:
    """The pick kernel bit-equal to its plain version (`_pick` and the
    shifts around it) on the selection's three real histograms and on an
    edge set; returns the largest difference seen (0.0)."""
    from orcai_tpu_torch.ops.radix_select import _LEVELS, radix_pick, radix_pick_plain

    cases = []
    for level, (_, bits, pshift) in enumerate(_LEVELS):
        cases.append((f"level {level}", level_hists[level], level_ranks[level],
                      level_prefixes[level], bits, pshift is None))
    h = torch.zeros((2, 2048), dtype=torch.int32, device=dev)
    h[0, 5], h[0, 700], h[0, 2047] = 10, 1, 3  # row 1 stays an empty target
    n = int(h[0].sum())
    zeros = torch.zeros(2, dtype=torch.int32, device=dev)
    some = torch.tensor([3, 0x1FFFFF], dtype=torch.int32, device=dev)
    one_bin = torch.zeros((2, 1024), dtype=torch.int32, device=dev)
    one_bin[:, 77] = 2_000_000_000
    for name, hist, ranks, pref, bits, shared in (
        ("k = 0 and k = n - 1", h, (0, n - 1), zeros, 11, True),
        ("bin boundaries", h, (9, 10), some, 11, True),
        ("an empty target", h, (11, 0), zeros, 11, False),
        ("one bin holds everything", one_bin, (0, 1_999_999_999), some, 10, False),
    ):
        cases.append((name, hist, torch.tensor(ranks, dtype=torch.int64, device=dev),
                      pref, bits, shared))
    worst = 0.0
    for name, hist, ranks, pref, bits, shared in cases:
        got = radix_pick(hist, ranks, pref, bits, shared)
        want = radix_pick_plain(hist, ranks, pref, bits, shared)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            worst = max(worst, float((g.double() - w.double()).abs().max()))
            if not (g.dtype == w.dtype and torch.equal(g, w)):
                raise AssertionError(f"pick kernel != plain on {name}: {g.tolist()} vs {w.tolist()}")
    return worst


def phase_kernels(torch, seed: int) -> tuple[dict, dict, dict]:
    """Kernel vs plain on the card; returns (phase line, per-kernel rows,
    the selection's line)."""
    import numpy as np

    from orcai_tpu_torch.ops.dft import dft_magnitude, dft_magnitude_plain
    from orcai_tpu_torch.ops.radix_select import (
        _LEVELS,
        _launch_pick,
        digit_histograms,
        digit_histograms_plain,
        radix_pick,
        radix_pick_plain,
        select_order_statistics,
        select_order_statistics_plain,
    )
    from orcai_tpu_torch.tools.synthetic import synth_magnitudes

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    errs, b1_in = _b1_checks(torch, rng, dev)
    x32, x16, window = b1_in["x32"], b1_in["x16"], b1_in["window"]
    stream_errs, stream_extra = _streaming_shape_checks(torch, rng, dev, window)
    errs.update({k[3:]: v for k, v in stream_errs.items() if k.startswith("b1_")})
    n_fft, hop, tile = b1_in["n_fft"], b1_in["hop"], b1_in["tile"]
    n_bins = n_fft // 2 + 1
    win = torch.hann_window(n_fft, periodic=True, device=dev)
    # the function reads each sample once and writes each magnitude once;
    # an operation count would belong to one algorithm (the GEMM needs 40x
    # the FFT's), not to the function, and the FFT's own arithmetic, about
    # 5 N log2 N for two frames, stays far below the byte time
    fft_flop = 0.5 * tile * 5.0 * n_fft * np.log2(n_fft)
    b1_bound, b1_by = bound(x32.numel() * 4 + tile * n_bins * 4, fft_flop)
    b1_bound16, _ = bound(x16.numel() * 2 + tile * n_bins * 4, fft_flop)
    b1 = {
        "name": "dft_magnitude_fft", "route": "cuda",
        "source": "orcai_tpu_torch/csrc/dft_magnitude.cu",
        "replaces": "orcai_tpu/ops/pallas_dft.py:67",
        "max_abs_err": max(errs.values()),
        "max_abs_err_vs_float64": b1_in["vs64"],
        "ms": cuda_ms(lambda: dft_magnitude(x32, window, n_fft=n_fft, hop=hop)),
        "ms_int16": cuda_ms(lambda: dft_magnitude(x16, window, n_fft=n_fft, hop=hop)),
        # the framed GEMM and the upload of its two 0.5 MB matrices
        "plain_ms": cuda_ms(lambda: dft_magnitude_plain(x32, window, n_fft=n_fft, hop=hop)),
        "bound_ms": b1_bound, "bound_ms_int16": b1_bound16, "bound_by": b1_by,
        "library_ms": cuda_ms(lambda: torch.stft(
            x32, n_fft, hop_length=hop, window=win, center=False,
            return_complex=True).abs()),
        "shape": f"B1's FFT route (n_fft 512): tile {tile} frames x {n_bins} bins; the "
                 f"*_normalize_tile_int16 and *_stats_tile_int16 keys: the streaming path's "
                 f"{CHUNK_TILE}- and {STATS_TILE}-frame tiles; cases: the wires phase "
                 "(uint8 mu-law codes)",
        **{k[3:]: v for k, v in stream_extra.items() if k.startswith("b1_")},
    }

    # 20-minute main-path shape: 225001 valid frames x 171 bins inside the
    # 262144-frame bucket, the padding rows zero as the frontend leaves them
    n_valid_elems, n_total = 225001 * 171, 262144 * 171
    flat = synth_magnitudes(n_valid_elems, n_total, seed, dev)
    nv = torch.full((1,), n_valid_elems, dtype=torch.int32, device=dev)
    k_lo = torch.full((1,), int(np.round(0.01 * (n_valid_elems - 1))), dtype=torch.int64, device=dev)
    k_hi = torch.full((1,), int(np.round(0.999 * (n_valid_elems - 1))), dtype=torch.int64, device=dev)
    lo, hi = select_order_statistics(flat, nv, k_lo, k_hi)
    lo_p, hi_p = select_order_statistics_plain(flat, nv, k_lo, k_hi)
    if not (torch.equal(lo, lo_p) and torch.equal(hi, hi_p)):
        raise AssertionError(f"selection {lo.item()}, {hi.item()} != sort {lo_p.item()}, {hi_p.item()}")
    # the three digit levels, with the prefixes and ranks the selection
    # walks through (taken from the plain versions)
    b2_err = stream_errs["b2_stats_tile"]
    ranks = torch.cat([k_lo, k_hi])
    prefixes = torch.zeros(2, dtype=torch.int32, device=dev)
    level_hists, level_ranks, level_prefixes = [], [], []
    for shift, bits, pshift in _LEVELS:
        got = digit_histograms(flat, nv, prefixes, shift, bits, pshift)
        want = digit_histograms_plain(flat, nv, prefixes, shift, bits, pshift)
        b2_err = max(b2_err, float((got.double() - want.double()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"B2 level shift={shift}: kernel != plain bincount")
        level_hists.append(want)
        level_ranks.append(ranks)
        level_prefixes.append(prefixes)
        prefixes, ranks = radix_pick_plain(want, ranks, prefixes, bits, pshift is None)
    # the scalar ends: a view one element into the buffer (4-byte aligned
    # only) and valid counts that are no multiple of 4
    for offset, count in ((1, n_valid_elems - 3), (1, 1001), (3, 2), (0, n_valid_elems - 1)):
        view = flat[offset:]
        nv_c = torch.full((1,), count, dtype=torch.int32, device=dev)
        for shift, bits, pshift in _LEVELS[:2]:
            got = digit_histograms(view, nv_c, level_prefixes[1], shift, bits, pshift)
            want = digit_histograms_plain(view, nv_c, level_prefixes[1], shift, bits, pshift)
            b2_err = max(b2_err, float((got.double() - want.double()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"B2 offset {offset}, n_valid {count}, shift {shift}: kernel != plain")
    pick_err = _pick_checks(torch, dev, level_hists, level_ranks, level_prefixes)

    zeros2 = torch.zeros(2, dtype=torch.int32, device=dev)
    b2_bound, b2_by = bound(n_valid_elems * 4 + 2 * 2048 * 4, 0.0)
    b2 = {
        "name": "digit_histograms", "route": "cuda",
        "source": "orcai_tpu_torch/csrc/digit_hist.cu",
        "replaces": "orcai_tpu/ops/pallas_hist.py:117",
        "max_abs_err": b2_err,
        "ms": cuda_ms(lambda: digit_histograms(flat, nv, zeros2, 21, 11, None)),
        "ms_prefixed": cuda_ms(lambda: digit_histograms(
            flat, nv, level_prefixes[1], 10, 11, 21)),
        "plain_ms": cuda_ms(lambda: digit_histograms_plain(flat, nv, zeros2, 21, 11, None)),
        "bound_ms": b2_bound, "bound_by": b2_by, "library_ms": None,
        "shape": f"{n_valid_elems} valid of {n_total}; ms: level 0 on the synthetic "
                 "spread, ms_prefixed: level 1, ms_real: level 0 on the 20-minute "
                 "recording's magnitudes; the *_stats_tile keys: the same valid "
                 f"count inside a streaming stats tile of {STATS_TILE * 171} values",
        **{k[3:]: v for k, v in stream_extra.items() if k.startswith("b2_")},
    }
    pick_bound, pick_by = bound(2 * 2048 * 4 + 2 * (8 + 4) * 2, 0.0)
    pick_args = (level_hists[1], level_ranks[1], level_prefixes[1], 11, False)
    # the launch alone on preallocated state, as the selection launches it;
    # the ranks it reads stay the level's own from one launch to the next
    p_state, k_out = level_prefixes[1].clone(), torch.empty_like(level_ranks[1])
    k_ptr = level_ranks[1].data_ptr()

    def pick_launch():
        _launch_pick(dev, level_hists[1].data_ptr(), 11, False, k_ptr, k_ptr + 8,
                     p_state.data_ptr(), k_out.data_ptr(), None)
    pick = {
        "name": "radix_pick", "route": "cuda",
        "source": "orcai_tpu_torch/csrc/digit_hist.cu",
        "replaces": "orcai_tpu/ops/pallas_hist.py:170",
        "replaces_note": "_pick, a plain-jnp helper of select_order_statistics "
                         "(no pallas_call of its own), with the shifts around it",
        "max_abs_err": pick_err,
        "ms": cuda_ms(lambda: radix_pick(*pick_args)),
        "ms_launch_only": cuda_ms(pick_launch, iters=50),
        "plain_ms": cuda_ms(lambda: radix_pick_plain(*pick_args)),
        "bound_ms": pick_bound, "bound_by": pick_by, "library_ms": None,
        "shape": "(2, 2048) int32 counts, two targets; ms: the public wrapper, "
                 "with its two small allocations, ms_launch_only: the launch "
                 "alone as the selection makes it",
    }
    sel_bound, sel_by = bound(3 * n_valid_elems * 4, 0.0)
    valid = flat[:n_valid_elems]
    ks = (int(k_lo) + 1, int(k_hi) + 1)
    sel = {
        "name": "select_order_statistics", "route": "B2 + pick kernel",
        "source": "orcai_tpu_torch/ops/radix_select.py",
        "replaces": "orcai_tpu/ops/pallas_hist.py:178",
        "max_abs_err": float(torch.cat([lo - lo_p, hi - hi_p]).abs().max()),
        "ms_runs": [cuda_ms(lambda: select_order_statistics(flat, nv, k_lo, k_hi))
                    for _ in range(3)],
        "plain_ms": cuda_ms(lambda: select_order_statistics_plain(flat, nv, k_lo, k_hi)),
        "bound_ms": sel_bound, "bound_by": sel_by,
        # two kthvalue calls, one per order statistic
        "library_ms": cuda_ms(lambda: (
            torch.kthvalue(valid, ks[0]), torch.kthvalue(valid, ks[1])), iters=2, warmup=1),
        "shape": f"{n_valid_elems} valid magnitudes: 1 memset, 3 sweeps of B2, 3 picks",
    }
    sel["ms"] = statistics.median(sel["ms_runs"])
    line = {"phase": "kernels", "b1_max_abs_err": errs,
            "b1_max_abs_err_vs_float64": b1_in["vs64"],
            "b2_levels_bit_exact": True, "b2_unaligned_and_ragged_bit_exact": True,
            "b2_stats_tile_levels_bit_exact": True,
            "pick_bit_equal_plain": True, "selection_bit_equal_sort": True}
    return line, {r["name"]: r for r in (b1, b2, pick)}, sel


def _counters():
    from orcai_tpu_torch.ops.dft import dft_magnitude
    from orcai_tpu_torch.ops.radix_select import digit_histograms, radix_pick

    return (dft_magnitude, digit_histograms, radix_pick)


def check_counts(counts: dict, b1: int, where: str, b2: int = 3, pick: int = 3,
                 route: str = "fft") -> None:
    """In memory: one B1 launch per real tile, three sweeps and three picks.
    Streaming: B1 three times per stats tile and once per chunk, B2 three
    times per stats tile, and the pick on the host from int64 counts. Every
    B1 launch takes `route` (ops/dft.py::dft_route: the FFT at n_fft 512, the
    mixed-radix FFT at the spectral wires' 384 and 352 and at 416, 1216 and
    1856, the cluster layout at 16384, the chirp mode at 2038 and 16418, the
    staged route at 40962 and 131072, the point kernel at n_fft 1)."""
    want = {"dft_magnitude": b1, "digit_histograms": b2, "radix_pick": pick,
            "b1_routes": {r: b1 if r == route else 0 for r in counts["b1_routes"]}}
    if counts != want:
        raise AssertionError(f"kernel launches on the {where} path {counts}, expected {want}")


def reset_counts() -> None:
    for fn in _counters():
        fn.launches = 0
    b1 = _counters()[0]
    b1.route_launches = dict.fromkeys(b1.route_launches, 0)


def read_counts(total: dict | None = None) -> dict:
    """This path's launches; added to `total`, the run's sum over its paths
    (B1 by route: dft_magnitude_fft, dft_magnitude_mixed, dft_magnitude_cluster,
    dft_magnitude_chirp, dft_magnitude_staged, dft_magnitude_point; dft_magnitude_gemm,
    which no route reaches, stays 0)."""
    counts = {fn.__name__: fn.launches for fn in _counters()}
    routes = dict(_counters()[0].route_launches)
    if total is not None:
        per = {"digit_histograms": counts["digit_histograms"],
               "radix_pick": counts["radix_pick"],
               **{f"dft_magnitude_{r}": n for r, n in routes.items()}}
        for name, n in per.items():
            total[name] = total.get(name, 0) + n
    counts["b1_routes"] = routes
    return counts


def phase_golden(torch, tmp: Path, total: dict) -> dict:
    from orcai_tpu_torch.pipeline.predict import predict

    out = tmp / "golden_pred.txt"
    reset_counts()
    t0 = time.perf_counter()
    predict(FIXTURES / "golden.wav", output_path=out, overwrite=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(total)
    same = out.read_bytes() == (FIXTURES / "golden_expected.txt").read_bytes()
    if not same:
        raise AssertionError(
            "golden TSV differs from tests/fixtures/golden_expected.txt:\n"
            + out.read_text())
    check_counts(counts, 1, "golden")
    return {"phase": "golden", "tsv_byte_equal": True, "wall_s_first_call": wall,
            "launches": counts}


def phase_full(torch, tmp: Path, seed: int, total: dict) -> tuple[dict, dict, dict]:
    import numpy as np

    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.io.wav import load_wav_for_frontend
    from orcai_tpu_torch.ops.frontend import (
        compute_spectrogram_device,
        fft_frequencies,
        freq_crop_indices,
        nearest_quantile_index,
        tile_magnitudes,
    )
    from orcai_tpu_torch.ops.overlap import WindowPredictor
    from orcai_tpu_torch.ops.radix_select import digit_histograms, select_order_statistics
    from orcai_tpu_torch.pipeline.predict import predict
    from orcai_tpu_torch.tools.synthetic import synth_sweep_wav

    wav = tmp / "synthetic_20min.wav"
    n = synth_sweep_wav(wav, seed, MINUTES)
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
    counts = read_counts(total)
    peak = torch.cuda.max_memory_allocated()
    check_counts(counts, 7, "main")
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
    # B2 level 0 and the selection on this recording's real magnitudes
    dev = torch.device("cuda")
    lo_idx, hi_idx = freq_crop_indices(
        fft_frequencies(sp["sampling_rate"], sp["nfft"]), sp["freq_range"])
    mag, _ = tile_magnitudes(audio, sp["nfft"], sp["n_overlap"], lo_idx, hi_idx, dev)
    n_elem = n_frames * (hi_idx - lo_idx)
    flat = mag.reshape(-1)
    nv = torch.full((1,), n_elem, dtype=torch.int32, device=dev)
    zeros2 = torch.zeros(2, dtype=torch.int32, device=dev)
    ks = [torch.full((1,), nearest_quantile_index(float(q), n_elem), dtype=torch.int64,
                     device=dev) for q in sp["quantiles"]]
    real = {
        "b2_ms_real": cuda_ms(lambda: digit_histograms(flat, nv, zeros2, 21, 11, None)),
        "occupied_top_digits": int((digit_histograms(flat, nv, zeros2, 21, 11, None)[0] > 0).sum()),
        "selection_ms_real": cuda_ms(lambda: select_order_statistics(flat, nv, *ks)),
    }
    line = {
        "phase": "full", "minutes": MINUTES, "samples": n, "frames": n_frames,
        "windows": n_win, "batch_size": predictor.batch_size,
        "predict_wall_s": wall, "frontend_wall_s": t_front, "crnn_wall_s": t_crnn,
        "peak_device_bytes": peak, "tsv_rows": n_rows, "launches": counts,
        "spectrogram_max_abs_err_vs_cpu": spec_err,
        "crnn_max_abs_err_vs_cpu": crnn_err, **real,
    }
    state = {"wav": wav, "tsv": out, "predictor": predictor, "param": param,
             "shape": shape, "aggregated": aggregated, "overlap": overlap, "n_samples": n,
             "spec": spec, "n_frames": n_frames}
    return line, real, state


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block; the earlier values come back."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def kept_aggregates():
    """Within the block, every StreamingPredictor.aggregate result is also
    appended to the list this yields: `predict` hands back a path only, and
    the checks below need the numbers it decoded."""
    from orcai_tpu_torch.ops.streaming import StreamingPredictor

    kept, real = [], StreamingPredictor.aggregate

    def keeping(self, audio):
        kept.append(real(self, audio))
        return kept[-1]

    StreamingPredictor.aggregate = keeping
    try:
        yield kept
    finally:
        StreamingPredictor.aggregate = real


def _streamed_predict(torch, wav, out, predictor, total, where, b1, b2, wire=None,
                      route="fft", **env) -> dict:
    """One `predict` on `wire` that must take the streaming path, with the
    environment given; returns its wall, peak memory, launches and
    (aggregated, overlap counts)."""
    from orcai_tpu_torch.pipeline.predict import predict

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with environ(**env), kept_aggregates() as kept:
        t0 = time.perf_counter()
        predict(wav, output_path=out, overwrite=True, predictor=predictor, wire=wire)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts(total)
    if len(kept) != 1:
        raise AssertionError(f"{where}: predict did not take the streaming path")
    check_counts(counts, b1, where, b2=b2, pick=0, route=route)
    return {"wall_s": wall, "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "device_bytes_before": base, "launches": counts, "result": kept[0]}


def streaming_launches(n_samples: int, predictor, hop: int) -> tuple[int, int]:
    """(B1, B2) launches of one streamed recording: B1 three times per stats
    tile and once per 512-window chunk, B2 three times per stats tile."""
    n_frames = 1 + n_samples // hop
    n_win = (n_frames - predictor.snippet_len) // predictor.shift + 1
    n_tiles, n_chunks = -(-n_frames // STATS_TILE), -(-n_win // 512)
    return 3 * n_tiles + n_chunks, 3 * n_tiles


def phase_streaming(torch, tmp: Path, seed: int, state: dict, total: dict) -> dict:
    import numpy as np

    from orcai_tpu_torch.pipeline.predict import _is_streaming_recording
    from orcai_tpu_torch.tools.synthetic import synth_long_recording

    predictor, sp = state["predictor"], state["param"]["spectrogram"]
    n_bins = state["shape"]["input_shape"][1]
    line = {"phase": "streaming"}

    # the 20-minute recording, forced onto the streaming path: 225001 frames
    # are 1 stats tile and 610 windows 2 chunks, so B1 = 5 and B2 = 3
    tsv = state["tsv"].read_bytes()
    b1_20, b2_20 = streaming_launches(state["n_samples"], predictor, sp["n_overlap"])
    for name, env in (("resident", {}), ("host_sliced", {"ORCAI_TPU_HBM_AUDIO_BYTES": 0})):
        out = tmp / f"stream20_{name}.txt"
        run = _streamed_predict(torch, state["wav"], out, predictor, total,
                                f"20-minute streaming ({name})", b1_20, b2_20,
                                ORCAI_TPU_STREAM_SPEC_BYTES=1, **env)
        agg, cnt = run.pop("result")
        if out.read_bytes() != tsv:
            raise AssertionError(f"20-minute streaming ({name}): TSV differs from in-memory")
        if not np.array_equal(cnt, state["overlap"]):
            raise AssertionError(f"20-minute streaming ({name}): overlap counts differ")
        run["aggregate_max_abs_diff_vs_in_memory"] = float(
            np.abs(agg - state["aggregated"]).max())
        if not run["aggregate_max_abs_diff_vs_in_memory"] <= 1e-5:
            raise AssertionError(f"20-minute streaming ({name}): aggregate off by "
                                 f"{run['aggregate_max_abs_diff_vs_in_memory']} > 1e-5")
        run["tsv_byte_equal_in_memory"] = True
        line[f"min20_{name}"] = run
    peak20 = line["min20_host_sliced"]["peak_device_bytes"]

    # golden (60 s, 2880000 samples) at the default tiles: 1 stats tile, 1 chunk
    out = tmp / "golden_stream.txt"
    run = _streamed_predict(torch, FIXTURES / "golden.wav", out, predictor, total,
                            "golden streaming",
                            *streaming_launches(2_880_000, predictor, sp["n_overlap"]),
                            ORCAI_TPU_STREAM_SPEC_BYTES=1)
    run.pop("result")
    if out.read_bytes() != (FIXTURES / "golden_expected.txt").read_bytes():
        raise AssertionError("golden streaming: TSV differs from golden_expected.txt")
    run["tsv_byte_equal"] = True
    line["golden"] = run

    # the path at a size that needs it: no variable set, `predict` streams
    long_wav = tmp / "synthetic_long.wav"
    t0 = time.perf_counter()
    n = synth_long_recording(long_wav, state["wav"], seed, LONG_REPEATS)
    line["long_synth_s"] = time.perf_counter() - t0
    if not _is_streaming_recording(n, sp, state["shape"]):
        raise AssertionError("the long recording does not pass the spectrogram budget")
    n_frames = 1 + n // sp["n_overlap"]
    n_win = (n_frames - predictor.snippet_len) // predictor.shift + 1
    b1_long, b2_long = streaming_launches(n, predictor, sp["n_overlap"])
    line.update({"long_samples": n, "long_frames": n_frames, "long_windows": n_win,
                 "long_stats_tiles": b2_long // 3, "long_chunks": b1_long - b2_long})
    outs = {}
    for name, env in (("resident", {}), ("host_sliced", {"ORCAI_TPU_HBM_AUDIO_BYTES": 0})):
        outs[name] = tmp / f"long_{name}.txt"
        run = _streamed_predict(torch, long_wav, outs[name], predictor, total,
                                f"long streaming ({name})", b1_long, b2_long, **env)
        agg, cnt = run.pop("result")
        if agg.shape != (n_frames // predictor.down, predictor.n_labels(n_bins)):
            raise AssertionError(f"long streaming ({name}): aggregated shape {agg.shape}")
        if not (np.isfinite(agg).all() and agg.min() >= 0 and agg.max() <= 1):
            raise AssertionError(f"long streaming ({name}): outputs not finite in [0, 1]")
        if set(np.unique(cnt[: (n_win - 1) * predictor.shift_out])) - {1.0, 2.0}:
            raise AssertionError(f"long streaming ({name}): overlap counts outside {{1, 2}}")
        run["tsv_rows"] = len(outs[name].read_text().splitlines()) - 1
        line[f"long_{name}"] = run
    if outs["resident"].read_bytes() != outs["host_sliced"].read_bytes():
        raise AssertionError("long streaming: resident and host-sliced TSVs differ")
    line["long_tsvs_byte_equal"] = True
    growth = line["long_host_sliced"]["peak_device_bytes"] - peak20
    line["long_host_sliced_peak_minus_min20_host_sliced_peak"] = growth
    if abs(growth) > PEAK_SLACK_BYTES:
        raise AssertionError(
            f"peak device memory grew with the recording: {growth} bytes from the "
            f"20-minute to the long host-sliced run (limit {PEAK_SLACK_BYTES})")
    long_wav.unlink()
    return line


def _served_latencies(report: str) -> list[tuple[str, float]]:
    """(wav name, seconds) from the service's `<wav> -> <tsv> (<s> s)` lines."""
    rows = []
    for text in report.splitlines():
        text = text.strip()
        if " -> " in text and text.endswith(" s)"):
            rows.append((text.split(" -> ")[0], float(text.rsplit("(", 1)[1].split()[0])))
    return rows


def phase_table_serve(torch, tmp: Path, state: dict, total: dict) -> dict:
    from orcai_tpu_torch.pipeline.predict import DEFAULT_CALL_DURATION_LIMITS, predict
    from orcai_tpu_torch.pipeline.serve import serve

    golden_tsv = (FIXTURES / "golden_expected.txt").read_bytes()
    full_tsv = state["tsv"].read_bytes()
    recs = tmp / "recordings"
    recs.mkdir()
    shutil.copy(FIXTURES / "golden.wav", recs / "golden.wav")
    os.link(state["wav"], recs / "synthetic_20min.wav")
    table = tmp / "recording_table.csv"
    table.write_text(
        "recording,channel,base_dir_recording,rel_recording_path\n"
        f"golden,1,{recs},golden.wav\n"
        f"synthetic_20min,1,{recs},synthetic_20min.wav\n"
        f"missing,1,{recs},missing.wav\n"
    )
    out_dir = tmp / "table_out"
    reset_counts()
    t0 = time.perf_counter()
    saved = predict(table, output_path=out_dir, save_probabilities=True,
                    call_duration_limits=DEFAULT_CALL_DURATION_LIMITS,
                    predictor=state["predictor"])
    torch.cuda.synchronize()
    table_wall = time.perf_counter() - t0
    table_counts = read_counts(total)
    check_counts(table_counts, 1 + 7, "table", b2=6, pick=6)
    want = {"golden": golden_tsv, "synthetic_20min": full_tsv}
    if [p.name for p in saved] != [f"{r}_orcai-v1_predicted.txt" for r in want]:
        raise AssertionError(f"table: saved {[p.name for p in saved]}")
    for rec, tsv in want.items():
        if (out_dir / f"{rec}_orcai-v1_predicted.txt").read_bytes() != tsv:
            raise AssertionError(f"table: {rec} TSV differs from the single-file predict")
        if not (out_dir / f"{rec}_orcai-v1_predicted_probabilities.csv.gz").exists():
            raise AssertionError(f"table: {rec} has no probabilities file")
    if (out_dir / "missing_orcai-v1_predicted.txt").exists():
        raise AssertionError("table: the missing row produced a file")

    # the service over the same two wavs: its own predictor, a stub sleep
    from orcai_tpu_torch.utils.messenger import Messenger

    serve_out = tmp / "serve_out"
    report = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    n = serve(recs, output_dir=serve_out, poll_seconds=0, max_files=2, sleep=lambda _: None,
              msgr=Messenger(file=report))
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_counts = read_counts(total)
    check_counts(serve_counts, 1 + 7, "serve", b2=6, pick=6)
    if n != 2 or list(serve_out.glob("*.failed")):
        raise AssertionError(f"serve: processed {n} files, markers "
                             f"{[p.name for p in serve_out.glob('*.failed')]}")
    for rec, tsv in want.items():
        if (serve_out / f"{rec}_c1_orcai-v1_predicted.txt").read_bytes() != tsv:
            raise AssertionError(f"serve: {rec} TSV differs from the single-file predict")
    return {"phase": "table_serve", "table_wall_s": table_wall,
            "table_launches": table_counts, "table_tsvs_byte_equal": True,
            "missing_row_skipped": True, "serve_wall_s": serve_wall,
            "serve_launches": serve_counts, "serve_tsvs_byte_equal": True,
            "serve_file_latency_s": _served_latencies(report.getvalue())}


class _Killed(Exception):
    """Raised from a training run's epoch-end callback to cut it short."""


def _history_diff(a: dict, b: dict) -> list[float]:
    """Largest absolute difference of any metric, epoch by epoch."""
    if sorted(a) != sorted(b) or any(len(a[k]) != len(b[k]) for k in a):
        raise AssertionError(f"histories differ in shape: {a} against {b}")
    return [max(abs(a[k][e] - b[k][e]) for k in a) for e in range(len(a["loss"]))]


def _one_step(torch, model, x, y, device):
    """(loss, {name: gradient on the host}) of the training loss at the
    model's weights on `device`; the model's statistics are put back."""
    from orcai_tpu_torch.train.trainer import Trainer

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, 1e-3, device=device)
    model.zero_grad(set_to_none=True)
    logits = model(x.to(device), train=True, return_logits=True)
    loss = trainer._loss(logits, y.to(device))
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.load_state_dict(saved)
    return float(loss.detach()), grads


def _train_run(torch, data_dir: Path, out: Path, param: dict, kill_after: int | None = None,
               **kwargs) -> tuple[Path, list[float]]:
    """`train` into out/<name>; returns the model directory and each epoch's
    wall (the first from the call). `kill_after` cuts the run with _Killed
    at the end of that epoch."""
    from orcai_tpu_torch.train.trainer import train

    ends = []

    def stamp(s, h, e, lr, c):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        if kill_after == e:
            raise _Killed

    begin = time.perf_counter()
    train(data_dir, out, orcai_parameter=param, on_epoch_end=stamp, **kwargs)
    torch.cuda.synchronize()
    return out / param["name"], [b - a for a, b in zip([begin] + ends, ends)]


def _finite_history(model_dir: Path, epochs: int) -> dict:
    history = json.loads((model_dir / "training_history.json").read_text())
    flat = [v for k in ("loss", "val_loss", "MBA", "val_MBA") for v in history[k]]
    if len(history["loss"]) != epochs or not all(math.isfinite(v) for v in flat):
        raise AssertionError(f"{model_dir.name}: history not finite over {epochs} epochs: "
                             f"{history}")
    return history


def _steps_ms(torch, trainer, state, x, y, n: int = 10, warm: int = 2) -> list[float]:
    """Device ms of each of n train steps on one batch, CUDA events around
    each, after `warm` untimed ones."""
    times = []
    for i in range(n + warm):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(state, x, y)
        end.record()
        end.synchronize()
        if i >= warm:
            times.append(start.elapsed_time(end))
    return times


def phase_train(torch, tmp: Path, seed: int, state: dict, total: dict) -> tuple[dict, dict]:
    import copy

    import numpy as np

    from orcai_tpu_torch.io.dataset import ArrayDataset
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.models import build_model
    from orcai_tpu_torch.pipeline.predict import predict
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.tools.profile_first_epoch import alloc_stats
    from orcai_tpu_torch.tools.synthetic import synth_tvt
    from orcai_tpu_torch.train.trainer import (
        Trainer, device_runners, streaming_runners,
    )
    from orcai_tpu_torch.utils.seeds import SEED_ID_LOAD_TRAIN_DATA, SEED_ID_LOAD_VAL_DATA

    data_dir, out = tmp / "tvt", tmp / "models"
    spec_host = state["spec"][: state["n_frames"]].cpu().numpy()
    t0 = time.perf_counter()
    counts = synth_tvt(data_dir, spec_host, seed, *TVT_SNIPPETS)
    tvt_s = time.perf_counter() - t0
    param = read_json(DEFAULT_ORCAI_PARAMETER)
    if (param["model"]["filters"], param["model"]["lstm_units"], param["model"]["batch_size"],
            len(param["calls"])) != ([30, 40, 50, 60], 128, 64, 7):
        raise AssertionError("the default parameter file is not the bundled model's width")
    param["seed"] = seed
    param["model"].update(epochs=TRAIN_EPOCHS, learning_rate=TRAIN_LR)
    batch = param["model"]["batch_size"]

    def run(name, **kwargs):
        return _train_run(torch, data_dir, out, {**param, "name": name}, **kwargs)

    # fresh weights, the data resident on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc_before = alloc_stats()
    whole_dir, epoch_walls = run("smoke-train")
    alloc_after = alloc_stats()
    peak = torch.cuda.max_memory_allocated()
    history = _finite_history(whole_dir, TRAIN_EPOCHS)
    if not history["loss"][-1] < history["loss"][0]:
        raise AssertionError(f"training loss did not fall: {history['loss']}")
    weights = (whole_dir / "smoke-train.msgpack").read_bytes()

    # killed after epoch 2, then started again: the uninterrupted history
    try:
        run("smoke-cut", kill_after=1)
        raise AssertionError("the run was not cut")
    except _Killed:
        pass
    if [p.name for p in (out / "smoke-cut" / "resume").iterdir()] != ["epoch_1.pt"]:
        raise AssertionError("the cut run left no checkpoint of epoch 2")
    cut_dir, resumed_walls = run("smoke-cut")
    resumed = read_json(cut_dir / "training_history.json")
    # epochs 1 and 2 ran before the cut: their difference is what two runs
    # of the same code differ by; epoch 3 ran from the checkpoint
    resume_diffs = _history_diff(resumed, history)
    resume_diff = max(resume_diffs)
    if len(resumed_walls) != 1 or not resume_diff <= RESUME_ATOL:
        raise AssertionError(f"resumed history off by {resume_diffs} > {RESUME_ATOL} after "
                             f"{len(resumed_walls)} more epoch(s): {resumed} against {history}")
    if (cut_dir / "resume").exists():
        raise AssertionError("the finished run left its resume directory")

    # one more epoch from the saved model, batches uploaded one by one
    with environ(ORCAI_TPU_DEVICE_DATASET_BYTES=1):
        _, stream_walls = run("smoke-train", load_model=True, max_epochs=1)
    more = read_json(whole_dir / "training_history.json")
    if len(more["loss"]) != 1 or not np.isfinite([v[0] for v in more.values()]).all():
        raise AssertionError(f"load_model epoch: {more}")
    if (whole_dir / "smoke-train.msgpack").read_bytes() == weights:
        raise AssertionError("the load_model epoch left the weights as they were")

    # the two runners over one epoch from the same state
    train_ds = ArrayDataset.load(data_dir / "train_dataset")
    val_ds = ArrayDataset.load(data_dir / "val_dataset")
    seeds = ([SEED_ID_LOAD_TRAIN_DATA, seed], [SEED_ID_LOAD_VAL_DATA, seed])
    runner_metrics = {}
    for name in ("resident", "streaming"):
        model, _, _ = load_orcai_model(cut_dir, device="cuda")
        trainer = Trainer(model, TRAIN_LR, device="cuda")
        st = trainer.state_from_variables(seed=seed)
        if name == "resident":
            runners = device_runners(trainer, train_ds, val_ds, batch, *seeds)
        else:
            runners = streaming_runners(
                trainer,
                lambda e: train_ds.batches(batch, seed=seeds[0], epoch=e),
                lambda e: val_ds.batches(batch, seed=seeds[1], epoch=e))
        st, m = runners[0](st, 0)
        runner_metrics[name] = {**m, **runners[1](st, 0)}
    runner_diff = max(
        abs(runner_metrics["resident"][k] - v) / max(abs(v), 1e-12)
        for k, v in runner_metrics["streaming"].items())
    if not runner_diff <= RUNNER_RTOL:
        raise AssertionError(f"resident and streaming runners differ by {runner_diff} > "
                             f"{RUNNER_RTOL}: {runner_metrics}")
    # warm step time on that trainer: CUDA events around each of 10 steps
    xb = torch.from_numpy(np.asarray(train_ds.x[:batch])).cuda()
    yb = torch.from_numpy(np.asarray(train_ds.y[:batch])).cuda()
    step_ms = _steps_ms(torch, trainer, st, xb, yb)

    # the trained directory loads and predicts
    reset_counts()
    tsv = predict(FIXTURES / "golden.wav", model_dir=whole_dir,
                  output_path=tmp / "golden_trained.txt", overwrite=True, device="cuda")
    torch.cuda.synchronize()
    predict_counts = read_counts(total)
    check_counts(predict_counts, 1, "predict with the trained model")
    if tsv.read_text().splitlines()[0].split("\t") != ["start", "stop", "label"]:
        raise AssertionError("predict with the trained model wrote no TSV")

    # one step from the bundled weights, dropout 0, on the card and the CPU
    bundled, bparam, bshape = load_orcai_model(device="cuda")
    plain = build_model({**bparam, "model": {**bparam["model"], "dropout_rate": 0.0}},
                        bshape["input_shape"]).cuda()
    plain.load_state_dict(bundled.state_dict())
    test_ds = ArrayDataset.load(data_dir / "test_dataset")
    xs = torch.from_numpy(np.asarray(test_ds.x[:8]))
    ys = torch.from_numpy(np.asarray(test_ds.y[:8]))
    loss_card, grads_card = _one_step(torch, plain, xs, ys, "cuda")
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = _one_step(torch, copy.deepcopy(plain).cpu(), xs, ys, "cpu")
    cpu_step_s = time.perf_counter() - t0
    largest = max(float(g.abs().max()) for g in grads_cpu.values())
    grad_diff = max(float((grads_card[k] - g).abs().max()) for k, g in grads_cpu.items()) / largest
    loss_diff = abs(loss_card - loss_cpu) / abs(loss_cpu)
    if sorted(grads_card) != sorted(grads_cpu) or not np.isfinite([loss_card, grad_diff]).all():
        raise AssertionError("the card's step has other or non-finite gradients")
    if not (loss_diff <= CPU_STEP_RTOL and grad_diff <= CPU_STEP_RTOL):
        raise AssertionError(f"card against CPU step: loss {loss_diff}, gradients {grad_diff} "
                             f"> {CPU_STEP_RTOL}")
    line = {
        "phase": "train", "snippets": counts, "tvt_write_s": tvt_s, "batch_size": batch,
        "learning_rate": TRAIN_LR, "history": history,
        "epoch_wall_s_resident": epoch_walls, "epoch_wall_s_streaming": stream_walls,
        "allocator_before_first_run": alloc_before, "allocator_after_first_run": alloc_after,
        "load_model_epoch": {k: v[0] for k, v in more.items()},
        "step_ms_median_warm": statistics.median(step_ms), "step_ms": step_ms,
        "peak_device_bytes": peak,
        "resumed_vs_uninterrupted_max_abs_diff": resume_diff,
        "resumed_vs_uninterrupted_abs_diff_by_epoch": resume_diffs,
        "resumed_epoch_wall_s": resumed_walls, "resume_atol": RESUME_ATOL,
        "runner_metrics": runner_metrics, "runners_max_rel_diff": runner_diff,
        "runner_rtol": RUNNER_RTOL,
        "trained_model_predict_launches": predict_counts,
        "bundled_step_loss_card": loss_card, "bundled_step_loss_cpu": loss_cpu,
        "card_vs_cpu_loss_rel_diff": loss_diff,
        "card_vs_cpu_gradient_diff_over_largest": grad_diff, "card_vs_cpu_rtol": CPU_STEP_RTOL,
        "cpu_step_s": cpu_step_s,
    }
    return line, {"data_dir": data_dir, "model_dir": whole_dir, "batch": batch, "seed": seed,
                  "history": history, "step_ms": line["step_ms_median_warm"],
                  "epoch_walls": epoch_walls}


def phase_test_model(torch, tmp: Path, state: dict, trained: dict) -> dict:
    import csv

    import numpy as np

    from orcai_tpu_torch.io.wav import load_wav_for_frontend
    from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device
    from orcai_tpu_torch.ops.overlap import WindowPredictor
    from orcai_tpu_torch.train.evaluate import test_model

    names = ["test_data_confusion_table.csv", "test_data_metrics.json",
             "test_data_misclassification_table_pred_true.csv",
             "test_data_misclassification_table_true_pred.csv"]
    walls = []
    one_batch = trained["batch"] * 736 * 171 * 4
    for where, env in (("test_a", {}), ("test_b", {"ORCAI_TPU_EVAL_SLAB_BYTES": one_batch})):
        with environ(**env):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = test_model(trained["model_dir"], trained["data_dir"], output_dir=tmp / where)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if sorted(p.name for p in out.iterdir()) != names:
            raise AssertionError(f"test_model wrote {sorted(p.name for p in out.iterdir())}")
    # the u8 upload (native/quant.c on the host), at both slab sizes
    for where, env in (("test_u8_a", {}),
                       ("test_u8_b", {"ORCAI_TPU_EVAL_SLAB_BYTES": one_batch})):
        with environ(ORCAI_TPU_EVAL_UPLOAD="u8", **env):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            test_model(trained["model_dir"], trained["data_dir"], output_dir=tmp / where)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    for name in names:
        if (tmp / "test_a" / name).read_bytes() != (tmp / "test_b" / name).read_bytes():
            raise AssertionError(f"{name} differs with a slab of one batch")
        if (tmp / "test_u8_a" / name).read_bytes() != (tmp / "test_u8_b" / name).read_bytes():
            raise AssertionError(f"{name} differs with a slab of one batch on the u8 upload")
    from orcai_tpu_torch import native

    if native.quantize_linear_native(np.zeros(4, np.float32), np.uint8) is None:
        raise AssertionError("the native quantizer did not load")
    metrics = json.loads((tmp / "test_a" / names[1]).read_text())
    metrics_u8 = json.loads((tmp / "test_u8_a" / names[1]).read_text())
    if not (np.isfinite(metrics["loss"]) and 0.0 <= metrics["MBA"] <= 1.0):
        raise AssertionError(f"test metrics {metrics}")
    with open(tmp / "test_a" / names[0], newline="") as f:
        totals = {r["Label"]: int(r["Total"]) for r in csv.DictReader(f)}
    n_test, n_steps = TVT_SNIPPETS[2], 736 // 16
    # the first five labels carry no mask: every snippet's every step counts
    unmasked = state["param"]["calls"][:5]
    if len(totals) != 7 or any(totals[c] != n_test * n_steps for c in unmasked):
        raise AssertionError(f"confusion totals {totals}, expected {n_test * n_steps} "
                             f"for {unmasked}")

    # the dense trunk against the windowed path
    predictor, sp = state["predictor"], state["param"]["spectrogram"]
    dense = WindowPredictor(predictor.model, snippet_len=predictor.snippet_len,
                            n_filters=4, batch_size=predictor.batch_size, dense_trunk=True)
    audio, _ = load_wav_for_frontend(FIXTURES / "golden.wav", sr=sp["sampling_rate"])
    gspec, g_frames, _, _ = make_spectrogram_from_params_device(audio, sp)
    w_agg, w_count = predictor.aggregate(gspec, n_frames=g_frames)
    d_agg, d_count = dense.aggregate(gspec, n_frames=g_frames)
    if not (np.array_equal(w_count, d_count) and np.isfinite(d_agg).all()
            and d_agg.min() >= 0 and d_agg.max() <= 1):
        raise AssertionError("dense trunk on golden: counts or range")
    crnn = {}
    for name, pred in (("windowed", predictor), ("dense", dense)):
        pred.aggregate_device(state["spec"], n_frames=state["n_frames"])  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        agg, count, n_out = pred.aggregate_device(state["spec"], n_frames=state["n_frames"])
        torch.cuda.synchronize()
        crnn[f"crnn_wall_s_{name}"] = time.perf_counter() - t0
        crnn[f"crnn_peak_device_bytes_{name}"] = torch.cuda.max_memory_allocated()
        crnn[name] = pred.fetch_aggregated(agg, count, n_out)
    if not np.array_equal(crnn["windowed"][1], crnn["dense"][1]):
        raise AssertionError("dense trunk on the 20-minute recording: overlap counts differ")
    diff20 = float(np.abs(crnn.pop("windowed")[0] - crnn.pop("dense")[0]).max())
    return {"phase": "test_model", "wall_s": walls, "metrics": metrics,
            "metrics_u8_upload": metrics_u8,
            "confusion_totals": totals, "files_byte_equal_with_one_batch_slabs": True,
            "u8_files_byte_equal_with_one_batch_slabs": True,
            "slab_bytes_second_run": one_batch,
            "dense_vs_windowed_max_abs_diff_golden": float(np.abs(w_agg - d_agg).max()),
            "dense_vs_windowed_mean_abs_diff_golden": float(np.abs(w_agg - d_agg).mean()),
            "dense_vs_windowed_max_abs_diff_20min": diff20, **crnn}


DP_RECORDINGS, DP_MINUTES = 3, 20.0  # the data-prep project: 3 x 20 min at 48 kHz
DP_BATCHES = (8, 2, 2)  # n_batch_train / val / test at batch 64 (orcai-v1: 3750 / 375 / 375)
DP_MASKED = ("BR", "BUZZ")  # the calls one row marks as not possible


def _tree_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_data_prep(torch, tmp: Path, seed: int, total: dict) -> dict:
    """The data chain of the port on a synthetic project at orcai-v1's
    widths: create-recording-table, create-spectrograms on cuda (its
    report's stage walls), create-label-arrays, create-snippet-table,
    create-tvt-snippet-tables, create-tvt-data, then one train epoch on the
    datasets it made."""
    import numpy as np

    from orcai_tpu_torch.io.jsonio import read_json, write_json
    from orcai_tpu_torch.io.tables import Table
    from orcai_tpu_torch.io.zarrlite import open_zarr
    from orcai_tpu_torch.ops import frontend
    from orcai_tpu_torch.ops.dft import dft_magnitude_plain
    from orcai_tpu_torch.ops.radix_select import select_order_statistics_plain
    from orcai_tpu_torch.pipeline.helpers import create_recording_table
    from orcai_tpu_torch.pipeline.labels import create_label_arrays
    from orcai_tpu_torch.pipeline.snippets import (
        create_snippet_table, create_tvt_data, create_tvt_snippet_tables,
    )
    from orcai_tpu_torch.pipeline.spectrogram import create_spectrograms, load_recording_audio
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.tools.synthetic import make_synthetic_project
    from orcai_tpu_torch.train.trainer import train
    from orcai_tpu_torch.utils.seeds import MASK_VALUE

    root = tmp / "data_prep"
    walls = {}
    t0 = time.perf_counter()
    make_synthetic_project(root, DP_RECORDINGS, DP_MINUTES * 60, seed=seed)
    walls["synthesize_s"] = time.perf_counter() - t0
    wav_dir = root / "recordings"
    names = sorted(p.stem for p in wav_dir.glob("*.wav"))
    unannotated, masked_rec = names[-1], names[1]
    (wav_dir / f"{unannotated}.txt").unlink()  # one recording without annotation

    param = read_json(DEFAULT_ORCAI_PARAMETER)
    if (param["model"]["filters"], param["model"]["batch_size"], len(param["calls"]),
            param["snippets"]["fraction_removal"]) != ([30, 40, 50, 60], 64, 7, 0.99):
        raise AssertionError("the default parameter file is not orcai-v1's")
    param["seed"], param["name"] = seed, "smoke-data-prep"
    param["model"].update(dict(zip(("n_batch_train", "n_batch_val", "n_batch_test"),
                                   DP_BATCHES)), epochs=1)
    param_path = root / "param.json"
    write_json(param, param_path)
    calls = param["calls"]

    # the scan, then the user fills the call columns: every call possible,
    # two not possible in one recording
    table_path = root / "recording_table.csv"
    t0 = time.perf_counter()
    create_recording_table(wav_dir, output_path=root / "scanned.csv",
                           orcai_parameter=param_path)
    walls["recording_table_s"] = time.perf_counter() - t0
    table = Table.read_csv(root / "scanned.csv")
    for call in calls:
        table[call] = np.array([not (r == masked_rec and call in DP_MASKED)
                                for r in table["recording"]])
    table.to_csv(table_path, index=False)

    data_dir, tvt = root / "data", root / "tvt"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    report = create_spectrograms(table_path, data_dir, orcai_parameter=param_path,
                                 device="cuda")
    torch.cuda.synchronize()
    walls["create_spectrograms_s"] = time.perf_counter() - t0
    counts = read_counts(total)
    peak = torch.cuda.max_memory_allocated()
    annotated = [r for r in names if r != unannotated]
    check_counts(counts, 7 * len(annotated), "data_prep", b2=3 * len(annotated),
                 pick=3 * len(annotated))
    if report["n_recordings"] != len(annotated) or sorted(
            p.name for p in data_dir.iterdir()) != annotated:
        raise AssertionError(f"spectrograms for {sorted(p.name for p in data_dir.iterdir())}, "
                             f"expected {annotated}")

    # each store against the frontend run here, and against its plain versions
    sp = param["spectrogram"]
    args = (sp["sampling_rate"], sp["nfft"], sp["n_overlap"], sp["freq_range"],
            sp["quantiles"])
    plain_err, n_frames = 0.0, {}
    for rec in annotated:
        stored = open_zarr(data_dir / rec / "spectrogram" / "spectrogram.zarr")[:]
        audio = load_recording_audio(wav_dir / f"{rec}.wav", sp["sampling_rate"])
        spec, nf, _, _ = frontend.compute_spectrogram_device(audio, *args, device="cuda")
        if not np.array_equal(stored, spec[:nf].cpu().numpy()):
            raise AssertionError(f"{rec}: stored spectrogram differs from the frontend's")
        kernels = frontend.dft_magnitude, frontend.select_order_statistics
        frontend.dft_magnitude = dft_magnitude_plain
        frontend.select_order_statistics = select_order_statistics_plain
        try:
            plain, _, _, _ = frontend.compute_spectrogram_device(audio, *args, device="cuda")
        finally:
            frontend.dft_magnitude, frontend.select_order_statistics = kernels
        plain_err = max(plain_err, float(np.abs(plain[:nf].cpu().numpy() - stored).max()))
        times = read_json(data_dir / rec / "spectrogram" / "times.json")
        if times["length"] != nf or stored.shape != (nf, 171):
            raise AssertionError(f"{rec}: times.json {times}, store {stored.shape}, {nf} frames")
        n_frames[rec] = nf
    if not plain_err <= 2e-4:
        raise AssertionError(f"stored spectrograms vs the plain versions: {plain_err} > 2e-4")

    t0 = time.perf_counter()
    create_label_arrays(table_path, data_dir, orcai_parameter=param_path)
    walls["labels_s"] = time.perf_counter() - t0
    masked_idx = [calls.index(c) for c in DP_MASKED]
    for rec in annotated:
        y = open_zarr(data_dir / rec / "labels" / "labels.zarr")[:]
        if y.shape != (n_frames[rec], len(calls)):
            raise AssertionError(f"{rec}: labels {y.shape}")
        is_masked = (y[:, masked_idx] == MASK_VALUE).all()
        if is_masked != (rec == masked_rec) or not set(np.unique(y)) <= {MASK_VALUE, 0.0, 1.0}:
            raise AssertionError(f"{rec}: masked columns {is_masked}, values {np.unique(y)}")
    t0 = time.perf_counter()
    create_snippet_table(table_path, data_dir, output_dir=tvt, orcai_parameter=param_path)
    walls["snippet_table_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    create_tvt_snippet_tables(tvt, orcai_parameter=param_path)
    walls["tvt_tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    create_tvt_data(tvt, orcai_parameter=param_path)
    walls["tvt_data_s"] = time.perf_counter() - t0
    shapes = read_json(tvt / "dataset_shapes.json")
    if shapes != {"spectrogram": [736, 171, 1], "labels": [46, len(calls)]}:
        raise AssertionError(f"dataset_shapes.json {shapes}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train(tvt, root / "models", orcai_parameter=param_path, device="cuda")
    torch.cuda.synchronize()
    walls["train_epoch_s"] = time.perf_counter() - t0
    history = read_json(root / "models" / param["name"] / "training_history.json")
    if len(history["loss"]) != 1 or not np.isfinite([v[0] for v in history.values()]).all():
        raise AssertionError(f"train on the made datasets: {history}")
    return {
        "phase": "data_prep", "recordings": DP_RECORDINGS, "minutes": DP_MINUTES,
        "annotated": len(annotated), "masked": {masked_rec: list(DP_MASKED)},
        "reduced": {"n_batch_train/val/test": [3750, 375, 375], "to": list(DP_BATCHES),
                    "batch_size": 64},
        "launches": counts, "codec": report["codec"],
        "stage_wall_s": {"wav_load": report["load_s"], "frontend": report["frontend_s"],
                         "fetch_to_host": report["fetch_s"], "store_write": report["write_s"],
                         **walls},
        "spectrogram_bytes_written": report["bytes_written"],
        "data_dir_bytes": _tree_bytes(data_dir), "tvt_dir_bytes": _tree_bytes(tvt),
        "peak_device_bytes_create_spectrograms": peak,
        "stored_vs_frontend_bit_equal": True, "stored_vs_plain_max_abs_err": plain_err,
        "frames": n_frames, "dataset_shapes": shapes, "train_history": history,
    }


CODED_WIRES = ("mulaw8", "bfp6", "bfp5", "sp-bfp6", "sp-bfp5", "sp11-bfp5")
ROW_S = 16 * 256 / 48000  # one aggregation row of orcai-v1, seconds
# where bfp5 at the native rate departs from the golden annotations in both
# packages (tests/test_torch_wire_codec.py): the HERDING call splits around
# a dip, and a zero-length WHISTLE becomes one aggregation row long
BFP5_SPLIT = {(0.9387, 3.1573, "HERDING*"), (3.328, 6.0587, "HERDING*"),
              (54.6987, 54.784, "WHISTLE*")}
GOLDEN_SPLIT = {(0.9387, 6.0587, "HERDING*")}
# streamed against in-memory sp-bfp5, the largest aggregate difference. The
# reference's 0.05 (tests/test_streaming.py:206-245, a tiny model) does not
# hold for orcai-v1 in either package: the JAX package on the CPU reads 0.0776
# and 0.1004 on one-minute sweeps, the card 0.0963 on this run's 20 minutes
# (tests/test_torch_streaming.py::test_streamed_sp_bfp5_departs_from_in_memory_as_the_reference_does)
SP_BFP5_STREAMED_MAX = 0.2


def _b1_route(wire: str) -> str:
    """The B1 route a wire's predict takes with orcai-v1's n_fft 512: the
    spectral wires run at 384 or 352, the mixed-radix FFT."""
    return "mixed" if wire.startswith("sp") else "fft"


def _b1_wire_checks(torch, rng, dev) -> tuple[dict, dict, dict, dict, dict, dict]:
    """B1 at the wires' and the parameter files' sizes and types against its
    plain version (atol 2e-4), on a 32768-frame tile, the ragged 11251-frame
    one and a uint8 view one byte off alignment: the mixed route at 384/192,
    352/176, 1024/256, 4096/2048 and 8192/4096 in float32, int16 and uint8
    and at 768/384, 704/352, 2048/512, 416/208, 1088/544, 4352/2176 (radix
    17), 1216/608 (radix 19), 1472/736 and 368/184 (radix 23; 368 on the
    32768-frame tile) in int16 and uint8, at 464/232, 496/248, 1856/928 and
    1984/992 (radices 29 and 31, on the 32768-frame tile) in all three
    types, also at the streamed tiles (384/192 and 352/176, every type), and
    at 480/240 (a plan outside dft_mixed.cu's compiled table) in all three
    types on the 32768-frame tile, the compiled layout asserted at 384 and
    352 and the warp layout at 480; the cluster route at
    16384/8192 (4 CTAs) and 32768/16384 (8; both two CTAs an SM, their
    plans compiled whole) in all three types and at 65536/32768 (8 CTAs of
    one an SM, compiled whole) in int16 and uint8 on the 11251-frame tile,
    and at 20736/10368 (4 CTAs) and 40960/20480 (8; both two CTAs an SM,
    both on the generic kernel: radices 3 and 5) in all three types on the
    11251-frame tile; the chirp route at 2038/1019 and 470/235 (block layout), 8198/4099 and
    16418/8209 (cluster layout, 4 and 8 CTAs, two an SM; 16418 also on a
    GEMM_FRAMES-frame tile) in int16 and uint8, and at 24578/12289 (8 CTAs
    of one an SM) on the 11251-frame tile; the
    staged route at 14848/7424 (2^9 * 29) and 49154/24577 (its chirp mode)
    on a GEMM_FRAMES-frame tile, at STAGED_COLUMN_SIZES (n_fft/(n_fft/2))
    in all three types on a GEMM_FRAMES-frame tile, at GEMM_NFFT 40962/20481 (its chirp mode)
    on a GEMM_FRAMES- and a STAGED_FRAMES-frame tile, at 131072/65536 and
    98304/49152 (its FFT mode) on STAGED_FRAMES frames and at the top of
    its reach on C1_FRAMES frames (262144/131072 and 2^20/2^19 in its FFT
    mode, (2^20 - 2)/(2^19 - 1) in its chirp mode), in int16 and uint8,
    each call's kernels counted (staged_kernels_a_call: 3 a chunk in the
    chirp mode, 2 in the FFT mode); the FFT route at
    512/256 in uint8. B1 of the codes bit-equal to B1 of their int16 decode
    on each route; on the 32768-frame tile, the mixed route in int16 and
    every type at this PR's sizes no farther from the float64 rFFT than the
    plain version. Where the kernel is more than 2e-4 from the plain
    version, the plain fp32 GEMM must itself be more than 2e-4 from the
    float64 rFFT and the kernel within 2e-4 of it (recorded in
    plain_past_bar). Above PLAIN_MAX (plain tables of 2.4 GB at 24578 to
    68.7 GB at 131072 in float32, built through float64 on the host), and
    on the staged route at every size, the kernel is held against its arithmetic step by step (ops/dft.py::
    _fft_cluster_reference, _chirp_cluster_reference, _staged_reference,
    _chirp_staged_reference) run on the card on a B1_SHORT-frame tile, and
    against the float64 rFFT on every frame, both at 2e-4 (above
    C1_HOLDS_MAX, where no float32 FFT holds 2e-4, both within C1_FACTOR
    of float32 torch.fft.rfft's error from the float64 rFFT on the same
    windowed frames: c1_reach); at GEMM_NFFT on
    the GEMM_FRAMES-frame int16 tile also against its plain version (6.7 GB
    of tables, uploaded in each call, built on the host beside the other
    sizes' checks: gemm_plain_tables_s). Times, on the 32768-frame tile, at
    this PR's sizes on the other tiles too, and on the streamed tiles: the
    route's kernel, the GEMM kernel called directly at the same n_fft
    (above 8192 on a GEMM_FRAMES-frame tile: its time grows as N^2), the
    plain version, torch.stft(...).abs() and the byte bound; the cluster
    layout at each of its sizes and types (cluster_layouts: CTAs a cluster,
    threads, CTAs an SM, clusters the card holds at once, registers,
    spills, a plan compiled whole, each asserted); the staged layout at
    each of its sizes and types (staged_layouts: each kernel's threads,
    CTAs an SM, registers and spills, and in the FFT mode each side
    compiled whole where staged_sides_compiled says so; every kernel with
    as many CTAs an SM as the SM's shared memory lets, up to
    STAGED_COMPILED_CTAS compiled whole and STAGED_GENERIC_CTAS generic,
    within the registers those CTAs leave it, no spill, each asserted); the staged kernels called directly at 65536 beside the
    cluster route. Returns (the phase's
    record, the mixed, the cluster, the chirp, the staged and the GEMM
    route's kernels rows)."""
    import numpy as np

    from orcai_tpu_torch.ops.dft import (
        MIXED_MAX, STAGED_KERNELS, _DTYPE_CODES, _chirp_cluster_reference, _chirp_kernel,
        _chirp_staged_reference, _fft_cluster_reference, _kernel, _launch_staged,
        _route_tables, _staged_reference, chirp_length, cluster_layout,
        dft_magnitude, dft_magnitude_plain, dft_route, mixed_layout, staged_chunk_pairs,
        staged_layout, staged_mode, staged_plan, staged_sides_compiled, windowed_dft_mats)
    from orcai_tpu_torch.ops.frontend import hann_window
    from orcai_tpu_torch.ops.wire_codec import (
        mulaw_decode_f32, mulaw_decode_host, mulaw_encode)

    t_start = time.perf_counter()
    record = {"max_abs_err": {}, "codes_bit_equal_decoded": {}, "gemm_fp32_floor_ms": {},
              "gemm_direct_max_abs_err": {}, "max_abs_err_vs_float64": {}, "plain_past_bar": {},
              "max_abs_err_vs_reference": {}, "gemm_direct_past_bar": {},
              "gemm_plain_tables_s": {}, "cluster_layouts": {}, "seconds_by_size": {},
              "staged_plans": {}, "staged_kernels_a_call": {}, "c1_reach": {},
              "staged_layouts": {}}
    cases = {}
    every, coded, tiles = ("f32", "int16", "uint8"), ("int16", "uint8"), B1_TILES
    streamed = {CHUNK_TILE: "normalize_tile", STATS_TILE: "stats_tile"}
    sizes = ((384, 192, every, tiles + tuple(streamed)), (352, 176, every, tiles + tuple(streamed)),
             (1024, 256, every, tiles), (768, 384, coded, tiles), (704, 352, coded, tiles),
             (2048, 512, coded, tiles), (416, 208, coded, tiles), (4096, 2048, every, tiles),
             (8192, 4096, every, tiles), (1088, 544, coded, tiles), (4352, 2176, coded, tiles),
             (1216, 608, coded, tiles), (1472, 736, coded, tiles), (368, 184, coded, tiles[:1]),
             (16384, 8192, every, tiles),
             (32768, 16384, every, tiles), (65536, 32768, coded, tiles[1:]),
             (20736, 10368, every, tiles[1:]), (40960, 20480, every, tiles[1:]),
             (2038, 1019, coded, tiles), (470, 235, coded, tiles), (8198, 4099, coded, tiles),
             (16418, 8209, coded, (tiles[0], GEMM_FRAMES)), (24578, 12289, coded, tiles[1:]),
             (464, 232, every, tiles[:1]), (496, 248, every, tiles[:1]),
             (480, 240, every, tiles[:1]),
             (1856, 928, every, tiles[:1]), (1984, 992, every, tiles[:1]),
             (14848, 7424, coded, (GEMM_FRAMES,)),
             *((n, n // 2, every, (GEMM_FRAMES,)) for n in STAGED_COLUMN_SIZES),
             (GEMM_NFFT, 20481, every, (GEMM_FRAMES, STAGED_FRAMES)),
             (131072, 65536, coded, (STAGED_FRAMES,)), (98304, 49152, coded, (STAGED_FRAMES,)),
             (49154, 24577, every, (GEMM_FRAMES,)), (1 << 18, 1 << 17, coded, (C1_FRAMES,)),
             (1 << 20, 1 << 19, coded, (C1_FRAMES,)),
             ((1 << 20) - 2, (1 << 19) - 1, coded, (C1_FRAMES,)),
             (512, 256, ("uint8",), tiles))
    # every tile timed
    new_sizes = (464, 496, 1856, 1984, 14848, GEMM_NFFT, 131072, 98304, 49154, 20736, 40960,
                 *STAGED_COLUMN_SIZES)
    streaming = {}  # the mixed route's times at the streaming tiles (keys of 352 suffixed)
    stream = torch.cuda.current_stream().cuda_stream

    def build_plain_tables(n_fft):
        t0 = time.perf_counter()
        windowed_dft_mats(hann_window(n_fft))
        record["gemm_plain_tables_s"][f"{n_fft}"] = time.perf_counter() - t0

    # the plain version's tables at GEMM_NFFT (6.7 GB, most of a minute of
    # numpy through float64) and at 8192, 14848, 16384 and 16418 (0.27-1.1
    # GB, seconds each) are built on the host while the card checks the
    # other sizes; numpy lets go of the GIL in its loops
    builders = {n: threading.Thread(target=build_plain_tables, args=(n,), daemon=True)
                for n in (8192, 14848, 16384, 16418, GEMM_NFFT)}
    for builder in builders.values():
        builder.start()

    def gemm_direct(x, window, n_fft, hop, frames):
        """The GEMM route's kernel at this n_fft, whatever route dft_route
        gives it, on the first `frames` frames of x: a launch on a
        preallocated output, as a yardstick."""
        C, S = _route_tables("gemm", window.tobytes(), dev)
        out = torch.empty((frames, n_fft // 2 + 1), dtype=torch.float32, device=dev)

        def run():
            err = _kernel("gemm")(x.data_ptr(), _DTYPE_CODES[x.dtype], C.data_ptr(),
                                  S.data_ptr(), out.data_ptr(), frames, n_fft, hop, stream)
            if err != 0:
                raise RuntimeError(f"GEMM kernel at {n_fft}/{hop}: CUDA error {err}")
            return out
        return run

    def as_f32(x):
        return {torch.float32: x, torch.int16: x.float() * (1.0 / 32768.0),
                torch.uint8: mulaw_decode_f32(x)}[x.dtype]

    def vs_float64(y, x, window, n_fft, hop):
        """max |y - |rFFT(window * frame)|| over every frame, the rFFT in
        float64 of the samples' exact values, in chunks of 1 GB of frames."""
        x64 = x.double() / 32768.0 if x.dtype == torch.int16 else as_f32(x).double()
        w64 = torch.from_numpy(window).to(dev)
        chunk, worst = max(1, (1 << 27) // n_fft), 0.0
        for t0 in range(0, y.shape[0], chunk):
            t1 = min(y.shape[0], t0 + chunk)
            frames = x64[t0 * hop:(t1 - 1) * hop + n_fft].unfold(0, n_fft, hop)
            exact = torch.fft.rfft(frames * w64, dim=1).abs()
            worst = max(worst, float((y[t0:t1] - exact).abs().max()))
            del frames, exact
        return worst

    def rfft_f32_err(x, window, n_fft, hop):
        """max ||rFFT_f32(window * frame)| - |rFFT(window * frame)|| over every
        frame: float32 torch.fft.rfft's own error on the windowed frames
        (computed in float64 and rounded once)."""
        x64 = x.double() / 32768.0 if x.dtype == torch.int16 else as_f32(x).double()
        frames = x64.unfold(0, n_fft, hop) * torch.from_numpy(window).to(dev)
        exact = torch.fft.rfft(frames, dim=1).abs()
        return float((torch.fft.rfft(frames.float(), dim=1).abs() - exact).abs().max())

    def timed(x, window, win, n_fft, hop, frames, with_plain=True):
        n_bins = n_fft // 2 + 1
        fft_flop = 0.5 * frames * 5.0 * n_fft * np.log2(n_fft)
        t_bound, by = bound(x.numel() * x.element_size() + frames * n_bins * 4, fft_flop)
        samples = as_f32(x)
        rec = {"route": dft_route(n_fft),
               "ms": cuda_ms(lambda: dft_magnitude(x, window, n_fft=n_fft, hop=hop), iters=5),
               "library_ms": cuda_ms(lambda: torch.stft(
                   samples, n_fft, hop_length=hop, window=win, center=False,
                   return_complex=True).abs(), iters=5),
               "bound_ms": t_bound, "bound_by": by}
        if rec["route"] == "chirp":
            rec["layout"] = "block" if _chirp_kernel(n_fft) == "mixed" else "cluster"
        if rec["route"] == "mixed" or rec.get("layout") == "block":
            # dft_mixed.cu's layout, threads, resident warps, registers, spills
            rec["kernel"] = mixed_layout(n_fft, hop, x.dtype)
        elif rec["route"] == "cluster" or rec.get("layout") == "cluster":
            # dft_cluster.cu's CTAs a cluster, threads, CTAs an SM, resident
            # clusters, registers, spills, a plan compiled whole or not
            rec["kernel"] = cluster_layout(n_fft, hop, x.dtype)
        if rec["route"] == "staged":
            rec["mode"] = staged_mode(n_fft)
        # the yardsticks take up to 0.35 s a call at 16384: two timed calls;
        # the plain version at GEMM_NFFT uploads its 6.7 GB of tables in each
        # call, seconds: one
        if with_plain:
            big = n_fft > PLAIN_MAX
            rec["plain_ms"] = cuda_ms(lambda: dft_magnitude_plain(
                x, window, n_fft=n_fft, hop=hop), iters=1 if big else 2, warmup=0 if big else 1)
        if rec["route"] != "gemm" and n_fft <= MIXED_MAX:
            rec["gemm_ms"] = cuda_ms(gemm_direct(x, window, n_fft, hop, frames), iters=2,
                                     warmup=1)
        elif (rec["route"] != "gemm" and (n_fft <= PLAIN_MAX or n_fft == GEMM_NFFT)
              and frames in (tiles[0], GEMM_FRAMES)):
            rec[f"gemm_ms_{GEMM_FRAMES}_frames"] = cuda_ms(
                gemm_direct(x, window, n_fft, hop, GEMM_FRAMES), iters=2, warmup=1)
        return rec

    for n_fft, hop, kinds, frame_counts in sizes:
        t_size = time.perf_counter()
        window = hann_window(n_fft)
        win = torch.hann_window(n_fft, periodic=True, device=dev)
        n_bins = n_fft // 2 + 1
        route = dft_route(n_fft)

        def plain(kind, frames):
            """The plain version runs on this kind and tile: up to PLAIN_MAX,
            and at GEMM_NFFT (its 6.7 GB of tables uploaded in each call) on
            the GEMM_FRAMES-frame int16 tile alone, the codes held to their
            int16 decode bit for bit."""
            return n_fft <= PLAIN_MAX or (n_fft == GEMM_NFFT and frames == GEMM_FRAMES
                                          and kind == "int16")
        if n_fft in builders:
            builders[n_fft].join()
        if route == "cluster" or route == "chirp" and _chirp_kernel(n_fft) == "cluster":
            for kind in kinds:
                record["cluster_layouts"][f"{n_fft}/{kind}"] = cluster_layout(
                    n_fft, hop, {"f32": torch.float32, "int16": torch.int16,
                                 "uint8": torch.uint8}[kind])
        if route == "staged":
            m = n_fft if staged_mode(n_fft) == "fft" else chirp_length(n_fft)
            record["staged_plans"][f"{n_fft}"] = {"mode": staged_mode(n_fft), "length": m,
                                                  "n1_n2_g1_g2": list(staged_plan(m))}
            for kind in kinds:
                record["staged_layouts"][f"{n_fft}/{kind}"] = staged_layout(
                    n_fft, {"f32": torch.float32, "int16": torch.int16,
                            "uint8": torch.uint8}[kind])
        for frames in frame_counts:
            n = (frames - 1) * hop + n_fft
            pcm = rng.integers(-32768, 32768, n, dtype=np.int16)
            codes = mulaw_encode(pcm)
            xs = {"int16": torch.from_numpy(pcm), "uint8": torch.from_numpy(codes)}
            if "f32" in kinds:
                xs["f32"] = torch.from_numpy(0.3 * rng.standard_normal(n, dtype=np.float32))
            xs = {k: v.to(dev) for k, v in xs.items() if k in kinds}
            off = torch.empty(n + 1, dtype=torch.uint8, device=dev)
            off[1:] = xs["uint8"]
            xs["uint8_unaligned"] = off[1:]
            for kind, x in xs.items():
                key = f"{n_fft}/{hop}/{frames}/{kind}"
                kernels = dict(dft_magnitude.staged_kernels)
                got = dft_magnitude(x, window, n_fft=n_fft, hop=hop)
                torch.cuda.synchronize()
                if got.shape != (frames, n_bins):
                    raise AssertionError(f"B1 ({route} route) {key}: shape {tuple(got.shape)}")
                if route == "staged":
                    # the kernels of this call, chunk by chunk
                    mode = staged_mode(n_fft)
                    m = n_fft if mode == "fft" else chirp_length(n_fft)
                    chunks = -(-((frames + 1) // 2) // staged_chunk_pairs(m))
                    launched = dft_magnitude.staged_kernels[mode] - kernels[mode]
                    record["staged_kernels_a_call"][key] = {"chunks": chunks, "kernels": launched}
                    if launched != chunks * (3 if mode == "chirp" else 2):
                        raise AssertionError(f"B1 (staged route, {mode} mode) {key}: "
                                             f"{launched} kernels in {chunks} chunks")
                # above C1_HOLDS_MAX the bar is float32's own (ROADMAP C1)
                bar = 2e-4
                if n_fft > C1_HOLDS_MAX:
                    f32_err = rfft_f32_err(x, window, n_fft, hop)
                    bar = C1_FACTOR * f32_err
                    record["c1_reach"][key] = {"rfft_f32_vs_float64": f32_err, "bar": bar}
                with_plain = plain(kind, frames)
                if with_plain:
                    want = dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)
                    err = float((got - want).abs().max())
                    record["max_abs_err"][key] = err
                # above PLAIN_MAX, and on the staged route at every size,
                # against the arithmetic step by step and the float64 rFFT
                stepped = n_fft > PLAIN_MAX or route == "staged"
                if stepped:
                    if not with_plain:
                        want = None
                    short = x[:(B1_SHORT - 1) * hop + n_fft]
                    step_by_step = {"cluster": _fft_cluster_reference,
                                    "chirp": _chirp_cluster_reference}.get(route) or (
                        _staged_reference if staged_mode(n_fft) == "fft"
                        else _chirp_staged_reference)
                    ref = step_by_step(short, window, n_fft=n_fft, hop=hop)
                    ref_err = float((got[:B1_SHORT] - ref).abs().max())
                    record["max_abs_err_vs_reference"][key] = ref_err
                    del short, ref
                    if not ref_err <= bar:
                        raise AssertionError(f"B1 ({route} route) {key}: max |kernel - "
                                             f"reference| {ref_err} > {bar} on {B1_SHORT} frames")
                    if not with_plain:
                        err = ref_err
                to_float64 = stepped or frames == tiles[0] and (
                    kind == "int16" or n_fft in new_sizes and kind in every)
                if to_float64 or not err <= 2e-4:
                    # kernel and plain against the float64 rFFT of the same
                    # windowed frames: the kernel must be no farther
                    vs64 = {"kernel": vs_float64(got, x, window, n_fft, hop)}
                    if with_plain:
                        vs64["plain"] = vs_float64(want, x, window, n_fft, hop)
                    record["max_abs_err_vs_float64"][key] = vs64
                    if with_plain and to_float64 and not vs64["kernel"] <= vs64["plain"]:
                        raise AssertionError(f"B1 {key}: the kernel is farther from float64 "
                                             f"than the plain version: {vs64}")
                    if stepped and not vs64["kernel"] <= bar:
                        raise AssertionError(f"B1 {key}: the kernel is {vs64['kernel']} from "
                                             f"the float64 rFFT (> {bar})")
                    if key in record["c1_reach"]:
                        record["c1_reach"][key]["kernel_vs_float64"] = vs64["kernel"]
                        record["c1_reach"][key]["kernel_vs_reference"] = ref_err
                if with_plain and not err <= 2e-4:
                    # the bar holds against the plain version, or against the
                    # float64 rFFT where the plain fp32 GEMM itself misses it
                    # (its n_fft-term sums at 4096 and above; ROADMAP C)
                    if not (vs64["plain"] > 2e-4 and vs64["kernel"] <= 2e-4):
                        raise AssertionError(f"B1 ({route} route) {key}: max |kernel - plain| "
                                             f"{err} > 2e-4; against float64 {vs64}")
                    record["plain_past_bar"][key] = {"kernel_vs_plain": err, **vs64}
                if (route != "gemm" and with_plain and kind != "uint8_unaligned" and (
                        frames == tiles[0] or n_fft == GEMM_NFFT and frames == GEMM_FRAMES)):
                    # the yardstick, timed below, is right too (above 8192 on
                    # the frames it is timed on), by the same rule
                    t = frames if n_fft <= MIXED_MAX else GEMM_FRAMES
                    g = gemm_direct(x, window, n_fft, hop, t)()
                    err = float((g - want[:t]).abs().max())
                    record["gemm_direct_max_abs_err"][key] = err
                    if not err <= 2e-4:
                        vs = {"gemm": vs_float64(g, x, window, n_fft, hop),
                              "plain": vs_float64(want[:t], x, window, n_fft, hop)}
                        record["gemm_direct_past_bar"][key] = {"gemm_vs_plain": err, **vs}
                        if not (vs["plain"] > 2e-4 and vs["gemm"] <= 2e-4):
                            raise AssertionError(f"GEMM kernel called directly {key}: {err} "
                                                 f"> 2e-4; against float64 {vs}")
                    del g
                del got, want
            decoded = torch.from_numpy(mulaw_decode_host(codes)).to(dev)
            a = dft_magnitude(xs["uint8"], window, n_fft=n_fft, hop=hop)
            same = (torch.equal(a, dft_magnitude(decoded, window, n_fft=n_fft, hop=hop))
                    and torch.equal(a, dft_magnitude(xs["uint8_unaligned"], window,
                                                     n_fft=n_fft, hop=hop)))
            record["codes_bit_equal_decoded"][f"{n_fft}/{hop}/{frames}"] = same
            if not same:
                raise AssertionError(f"B1 ({route} route) {n_fft}/{hop}: the codes "
                                     "and their int16 decode give different magnitudes")
            if frames in streamed:
                for kind in kinds:
                    rec = timed(xs[kind], window, win, n_fft, hop, frames, with_plain=False)
                    name = f"{streamed[frames]}_{kind}" + ("" if n_fft == 384 else f"_{n_fft}")
                    streaming.update({f"{k}_{name}": v for k, v in rec.items()
                                      if k not in ("route", "bound_by", "kernel")})
            if frames == tiles[0] or n_fft in new_sizes:
                suffix = "" if frames == tiles[0] else f"/{frames}"
                for kind in kinds:
                    cases[f"{n_fft}/{hop}/{kind}{suffix}"] = timed(
                        xs[kind], window, win, n_fft, hop, frames, plain(kind, frames))
                # the GEMM's own floor, not the function's bound: 2 T n_fft
                # n_bins fp32 FMAs (re and im), 2 FLOP each
                record["gemm_fp32_floor_ms"][f"{n_fft}/{hop}{suffix}"] = (
                    4.0 * frames * n_fft * n_bins / FP32_FLOP_PER_S * 1e3)
            del xs, off, decoded, a
            torch.cuda.empty_cache()
        record["seconds_by_size"][f"{n_fft}/{hop}"] = time.perf_counter() - t_size

    # dft_cluster.cu: two CTAs of 256 threads, of two frame pairs, on every
    # SM where a plan fits twice (up to about 48000 points: 16384, 20736,
    # 32768, 40960 and the chirp mode's 8198 and 16418), one of 512 above
    # (65536, 24578); compiled whole the plans whose radices are all powers
    # of two (16384, 32768 and 65536), every other plan (20736 and 40960 in
    # the FFT mode, the chirp mode's) read at run time; no spill
    compiled = (16384, 32768, 65536)
    for key, got in record["cluster_layouts"].items():
        n_fft = int(key.split("/")[0])
        pair = n_fft not in (65536, 24578)
        want = {"ctas_per_sm": 2 if pair else 1, "threads": 256 if pair else 512,
                "compiled": n_fft in compiled, "local_bytes": 0}
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"B1 {key}: dft_cluster.cu's layout {got}, not {want}")
    # dft_staged.cu: in the FFT mode each side whose radices are all powers
    # of two, and 98304's rows, runs a kernel compiled whole (131072's and
    # 98304's both, and the columns of STAGED_COLUMN_SIZES), on one buffer;
    # in the chirp mode the column side by the same rule, in kernels 1 and 3
    # (STAGED_CHIRP_COMPILED: 40962's 256 = 16 x 16 columns compiled, 49154's
    # 289 = 17 x 17 not), its kernel 2 generic; every other kernel the
    # generic one. Each has as many CTAs an SM as the SM's shared memory
    # lets, up to STAGED_COMPILED_CTAS compiled whole (the chirp mode's
    # kernel 1 but on int16: STAGED_GENERIC_CTAS) and STAGED_GENERIC_CTAS
    # generic, so at most the registers that many CTAs of its
    # __launch_bounds__ threads (its own compiled whole, 256 generic) leave
    # each; no spill
    sm_shared = torch.cuda.get_device_properties(dev).shared_memory_per_multiprocessor
    sm_registers = 65536  # an sm_90 SM's register file, 32-bit registers
    for key, got in record["staged_layouts"].items():
        n_fft = int(key.split("/")[0])
        chirp = got["mode"] == "chirp"
        fixed = staged_sides_compiled(chirp_length(n_fft) if chirp else n_fft, chirp=chirp)
        if chirp and fixed[0] != STAGED_CHIRP_COMPILED[n_fft]:
            raise AssertionError(f"B1 {key}: the chirp mode's column side compiled {fixed[0]}, "
                                 f"not {STAGED_CHIRP_COMPILED[n_fft]}")
        for kernel in STAGED_KERNELS[got["mode"]]:
            k = got[kernel]
            compiled = fixed[kernel == "rows"]
            # the chirp mode's compiled kernel 1 takes STAGED_COMPILED_CTAS on
            # int16 samples alone (dft_staged.cu::chirp_columns_ctas)
            most = (STAGED_COMPILED_CTAS if compiled and not (
                chirp and kernel == "columns" and not key.endswith("/int16"))
                    else STAGED_GENERIC_CTAS)
            fit = min(most, sm_shared // (k["smem_bytes"] + CTA_RESERVED_BYTES))
            bound_threads = k["threads"] if compiled else 256
            ceiling = min(255, sm_registers // (fit * bound_threads))
            if (k["compiled"] != compiled or k["ctas_per_sm"] < fit
                    or k["registers"] > ceiling or k["local_bytes"]):
                raise AssertionError(
                    f"B1 {key}: dft_staged.cu's {kernel} kernel {k}: not compiled {compiled}, "
                    f"fewer than {fit} CTAs an SM, more than {ceiling} registers or a spill")
    # dft_mixed.cu's compiled layout runs the spectral wires' plans, the
    # warp layout a plan outside its table where four warps fit
    for size, layout in (("384/192", "compiled"), ("352/176", "compiled"), ("480/240", "warp")):
        for kind in every:
            got = cases[f"{size}/{kind}"]["kernel"]["layout"]
            if got != layout:
                raise AssertionError(f"B1 {size}/{kind}: dft_mixed.cu's {got} layout, "
                                     f"not the {layout} layout")

    def of_route(table, route):
        return {k: v for k, v in record[table].items()
                if dft_route(int(k.split("/")[0])) == route}

    def row(name, route, main_key, shape):
        main = cases[main_key]
        source = {"gemm": "dft_gemm", "cluster": "dft_cluster",
                  "staged": "dft_staged"}.get(route, "dft_mixed")
        also = {"sources": ["orcai_tpu_torch/csrc/dft_mixed.cu",
                            "orcai_tpu_torch/csrc/dft_cluster.cu"]} if route == "chirp" else {}
        return {
            "name": name, "route": "cuda", "source": f"orcai_tpu_torch/csrc/{source}.cu", **also,
            "replaces": "orcai_tpu/ops/pallas_dft.py:67",
            "max_abs_err": max(of_route("max_abs_err", route).values(), default=0.0),
            "tolerance": "2e-4 against the plain version, or against the float64 rFFT where "
                         "the plain fp32 GEMM is itself farther than 2e-4 from it "
                         "(plain_past_bar); above 16418, where the plain version runs at "
                         f"{GEMM_NFFT} alone (int16, {GEMM_FRAMES} frames), 2e-4 against the "
                         "step-by-step reference on the card and against the float64 rFFT",
            "max_abs_err_vs_float64": max([v["kernel"] for v in of_route(
                "max_abs_err_vs_float64", route).values()], default=None),
            "max_abs_err_vs_reference": max(of_route(
                "max_abs_err_vs_reference", route).values(), default=None),
            "plain_past_bar": of_route("plain_past_bar", route),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": shape,
            "cases": {k: v for k, v in cases.items() if v["route"] == route},
        }

    mixed_row = row(
        "dft_magnitude_mixed", "mixed", "384/192/int16",
        "B1's mixed-radix route (every {2,...,31}-smooth n_fft up to 8192 but 512): "
        "ms etc. at n_fft 384 / hop 192 (the sp-bfp5 and sp-bfp6 wires), a 32768-frame "
        "int16 tile x 193 bins; the *_normalize_tile_* and *_stats_tile_* keys: streamed "
        f"sp-bfp5's {CHUNK_TILE}- and {STATS_TILE}-frame tiles at 384 / 192 (a _352 suffix: "
        "at 352 / 176, sp11-bfp5's); cases: every size and type timed (a /11251 suffix: the "
        "ragged tile), kernel: dft_mixed.cu's layout (warp, block or compiled), threads, "
        "resident warps, registers and spilled bytes, gemm_ms: the GEMM kernel called "
        "directly at the same n_fft, library_ms: torch.stft(...).abs() at the same n_fft")
    mixed_row.update(streaming)
    cluster_row = row(
        "dft_magnitude_cluster", "cluster", "16384/8192/int16",
        "B1's cluster layout (csrc/dft_cluster.cu: a frame pair's FFT across a cluster of "
        "2, 4 or 8 CTAs; every {2,...,23}-smooth n_fft from 8193 to 81920): ms etc. at n_fft "
        "16384 / hop 8192, a 32768-frame int16 tile x 8193 bins; cases as the mixed row's "
        f"(gemm_ms_{GEMM_FRAMES}_frames: the GEMM kernel on a {GEMM_FRAMES}-frame tile)")
    cluster_row["cluster_layouts"] = {k: v for k, v in record["cluster_layouts"].items()
                                      if dft_route(int(k.split("/")[0])) == "cluster"}
    chirp_row = row(
        "dft_magnitude_chirp", "chirp", "2038/1019/int16",
        "B1's chirp-z (Bluestein) mode (every n_fft up to 40960 with a prime factor above "
        "31): on dft_mixed.cu's block layout where its length M is within 8192, on "
        "dft_cluster.cu above; ms etc. at n_fft 2038 / hop 1019, a 32768-frame int16 tile x "
        "1020 bins; cases as the mixed row's, each with its layout")
    chirp_row["cluster_layouts"] = {k: v for k, v in record["cluster_layouts"].items()
                                    if dft_route(int(k.split("/")[0])) == "chirp"}
    staged_row = row(
        "dft_magnitude_staged", "staged", f"{GEMM_NFFT}/20481/int16/{GEMM_FRAMES}",
        "B1's staged route (csrc/dft_staged.cu: the four-step split in kernels of their own "
        "through a scratch buffer in device memory; every n_fft from 8193 to 2^20 no other "
        "route takes): ms etc. at n_fft 40962 / hop 20481 (its chirp mode), a "
        f"{GEMM_FRAMES}-frame int16 tile x 20482 bins; cases as the mixed row's, each with "
        f"its mode (gemm_ms_{GEMM_FRAMES}_frames: the GEMM kernel called directly); "
        "staged_65536: the FFT mode called directly at 65536 (the cluster route's size) beside "
        "the cluster route in this call")
    staged_row["tolerance"] += (f"; above {C1_HOLDS_MAX} both within {C1_FACTOR}x of float32 "
                                "torch.fft.rfft's own error from the float64 rFFT (c1_reach)")
    staged_row["c1_reach"] = record["c1_reach"]
    staged_row["staged_layouts"] = record.pop("staged_layouts")
    staged_row["plans"] = record.pop("staged_plans")
    # the staged kernels at 65536, called directly with their plan, beside
    # the cluster route on the same 11251-frame tile: a finding, not a route
    n_fft, hop, frames = 65536, 32768, tiles[1]
    window = hann_window(n_fft)
    x = torch.from_numpy(rng.integers(-32768, 32768, (frames - 1) * hop + n_fft,
                                      dtype=np.int16)).to(dev)
    out = torch.empty((frames, n_fft // 2 + 1), dtype=torch.float32, device=dev)
    if _launch_staged(x, window, out, n_fft, hop) != 0:
        raise RuntimeError("the staged kernels at 65536: launch failed")
    got = dft_magnitude(x, window, n_fft=n_fft, hop=hop)  # the cluster route
    staged_row["staged_65536"] = {
        "frames": frames, "plan": list(staged_plan(n_fft)),
        "max_abs_err_vs_cluster_route": float((out - got).abs().max()),
        "max_abs_err_vs_float64": vs_float64(out, x, window, n_fft, hop),
        "ms": cuda_ms(lambda: _launch_staged(x, window, out, n_fft, hop), iters=5),
        "cluster_route_ms": cuda_ms(lambda: dft_magnitude(x, window, n_fft=n_fft, hop=hop),
                                    iters=5)}
    if not staged_row["staged_65536"]["max_abs_err_vs_float64"] <= 2e-4:
        raise AssertionError(f"the staged kernels at 65536: {staged_row['staged_65536']}")
    del x, out, got
    # the GEMM kernel, which no route reaches (the point kernel takes n_fft
    # 1; above 2^20 B1 raises): timed directly at GEMM_NFFT (the "Earlier"
    # yardstick) against the same plain version, torch.stft and bound as the
    # staged route's row
    main = cases[f"{GEMM_NFFT}/20481/int16/{GEMM_FRAMES}"]
    gemm_errs = {k: v for k, v in record["gemm_direct_max_abs_err"].items()
                 if k.startswith(f"{GEMM_NFFT}/")}
    gemm_row = {
        "name": "dft_magnitude_gemm", "route": "cuda",
        "source": "orcai_tpu_torch/csrc/dft_gemm.cu",
        "replaces": "orcai_tpu/ops/pallas_dft.py:67",
        "max_abs_err": max(gemm_errs.values()),
        "tolerance": "2e-4 against the plain version (or the float64 rFFT where the plain "
                     "fp32 GEMM is itself farther: gemm_direct_past_bar)",
        "ms": main[f"gemm_ms_{GEMM_FRAMES}_frames"],
        **{k: main[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms")},
        "gemm_direct_past_bar": {k: v for k, v in record["gemm_direct_past_bar"].items()
                                 if k.startswith(f"{GEMM_NFFT}/")},
        "shape": "B1's GEMM kernel, reached by no route (the yardstick; not in the kernels "
                 "line): ms: the kernel called directly at n_fft 40962 / hop 20481 on "
                 f"a {GEMM_FRAMES}-frame int16 tile (the staged route's size there), plain_ms, "
                 "library_ms and bound_ms as the staged row's",
    }
    record["fft_route_uint8"] = {k: v for k, v in cases.items() if v["route"] == "fft"}
    record["seconds"] = time.perf_counter() - t_start
    return record, mixed_row, cluster_row, chirp_row, staged_row, gemm_row


CLI_SPECTROGRAM_SIZES = ((416, 208), (1216, 608), (1856, 928), (2038, 1019), (16418, 8209),
                         (16384, 8192), (40962, 20481), (131072, 65536))
#   B1 on the mixed route (416 = 8*4*13, 1216 = 8*8*19, 1856 = 8*8*29), the chirp
#   mode on the block and on the cluster layout, the cluster route, the staged
#   route in its chirp mode and in its FFT mode
CPU_PATH_MAX = 40962  # the largest nfft whose CLI store is held against the CPU path: its
#   plain tables are 6.7 GB there and 68.7 GB at 131072


def _create_spectrograms_path(torch, tmp: Path, seed: int, total: dict, nfft: int,
                              n_overlap: int) -> dict:
    """B1's other routes through an entry point: create-spectrograms through
    the CLI on cuda on a one-minute synthetic project with the default
    parameter file at this nfft / n_overlap, 1 / 3 / 3 launches, B1 on
    dft_route(nfft); the stored spectrogram against the port's CPU path up
    to CPU_PATH_MAX (whose plain tables are 4 N (N/2 + 1) bytes), above it
    bit-equal to the frontend run on cuda in this process (B1 there is held
    against the float64 rFFT in _b1_wire_checks)."""
    import contextlib as ctx
    import io

    import numpy as np

    from orcai_tpu_torch import __main__ as cli
    from orcai_tpu_torch.io.jsonio import read_json, write_json
    from orcai_tpu_torch.io.zarrlite import open_zarr
    from orcai_tpu_torch.ops.dft import dft_route
    from orcai_tpu_torch.ops.frontend import compute_spectrogram_device
    from orcai_tpu_torch.pipeline.spectrogram import load_recording_audio
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.tools.synthetic import make_synthetic_project

    root = tmp / f"create_spectrograms_{nfft}"
    table = make_synthetic_project(root, 1, 60.0, seed=seed)
    param = read_json(DEFAULT_ORCAI_PARAMETER)
    param["spectrogram"].update(nfft=nfft, n_overlap=n_overlap)
    write_json(param, root / "param.json")
    reset_counts()
    t0 = time.perf_counter()
    with ctx.redirect_stdout(io.StringIO()):
        cli.main(["create-spectrograms", str(table), str(root / "data"), "-p",
                  str(root / "param.json"), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(total)
    check_counts(counts, 1, f"create-spectrograms at nfft {nfft}", route=dft_route(nfft))
    (rec,) = sorted((root / "data").iterdir())
    stored = open_zarr(rec / "spectrogram" / "spectrogram.zarr")[:]
    sp = param["spectrogram"]
    audio = load_recording_audio(root / "recordings" / f"{rec.name}.wav", sp["sampling_rate"])
    args = (audio, sp["sampling_rate"], sp["nfft"], sp["n_overlap"], sp["freq_range"],
            sp["quantiles"])
    if nfft <= CPU_PATH_MAX:
        cpu, nf, _, _ = compute_spectrogram_device(*args, device="cpu")
        err = float(np.abs(cpu[:nf].numpy() - stored).max())
        if stored.shape != (nf, cpu.shape[1]) or not err <= 2e-4:
            raise AssertionError(f"create-spectrograms at nfft {nfft}: store {stored.shape}, "
                                 f"{nf} frames, vs the CPU path {err} > 2e-4")
        check = {"stored_vs_cpu_max_abs_err": err}
    else:
        spec, nf, _, _ = compute_spectrogram_device(*args, device="cuda")
        same = stored.shape == (nf, spec.shape[1]) and np.array_equal(
            spec[:nf].cpu().numpy(), stored)
        if not same:
            raise AssertionError(f"create-spectrograms at nfft {nfft}: the store is not the "
                                 "frontend's run on cuda bit for bit")
        check = {"stored_bit_equal_cuda_frontend": True}
    return {"route": dft_route(nfft), "wall_s": wall, "launches": counts,
            "frames_bins": list(stored.shape), **check}


def _point_route_path(torch, rng, total: dict) -> dict:
    """The point route (csrc/dft_point.cu), B1's only route at n_fft 1 (hop
    1, a window of one value, 0.7 so that its multiply shows): B1 called on
    a minute of audio on cuda in float32, int16 and uint8 mu-law codes, and
    on a code view one byte off (the kernel's unaligned pass), with the
    counts reset before and read after each call (1 launch on the point
    route, no B2 or pick: no entry point reaches n_fft 1, whose one bin
    create-spectrograms' frequency range cannot crop), bit-equal to the
    plain version (and to _point_reference, its arithmetic); then, for each
    type, its time beside the plain version's, torch.stft(...).abs()'s on
    the same samples as float32 and the byte bound (each sample read once,
    each magnitude written once)."""
    import numpy as np

    from orcai_tpu_torch.ops.dft import (
        _point_reference, _to_f32, dft_magnitude, dft_magnitude_plain, dft_route)
    from orcai_tpu_torch.ops.wire_codec import mulaw_encode

    window = np.full(1, 0.7)
    pcm = rng.integers(-32768, 32768, 48000 * 60 + 1, dtype=np.int16)
    codes = torch.from_numpy(mulaw_encode(pcm)).to("cuda")
    inputs = {"int16": torch.from_numpy(pcm[:-1]).to("cuda"),
              "f32": torch.from_numpy((0.3 * rng.standard_normal(48000 * 60))
                                      .astype(np.float32)).to("cuda"),
              "uint8": codes[:-1], "uint8_unaligned": codes[1:]}
    rec = {"route": dft_route(1), "window": 0.7, "frames": 48000 * 60, "launches": {},
           "bit_equal_plain": {}, "max_abs_err": {}, "ms": {}, "plain_ms": {}, "library_ms": {},
           "bound_ms": {}, "bound_by": {}}
    for kind, x in inputs.items():
        reset_counts()
        got = dft_magnitude(x, window, n_fft=1, hop=1)
        torch.cuda.synchronize()
        counts = read_counts(total)
        check_counts(counts, 1, f"the point route at n_fft 1 ({kind})", b2=0, pick=0,
                     route="point")
        want = dft_magnitude_plain(x, window, n_fft=1, hop=1)
        rec["launches"][kind] = counts["dft_magnitude"]
        rec["bit_equal_plain"][kind] = bool(
            torch.equal(got.view(torch.int32), want.view(torch.int32))
            and torch.equal(want, _point_reference(x, window)))
        rec["max_abs_err"][kind] = float((got - want).abs().max())
        if got.shape != (x.numel(), 1) or not rec["bit_equal_plain"][kind]:
            raise AssertionError(f"B1 at n_fft 1 ({kind}): shape {tuple(got.shape)}, max "
                                 f"|kernel - plain| {rec['max_abs_err'][kind]}, not bit-equal")
        if kind == "uint8_unaligned":
            continue
        samples, win = _to_f32(x), torch.full((1,), 0.7, device="cuda")
        rec["bound_ms"][kind], rec["bound_by"][kind] = bound(
            x.numel() * x.element_size() + got.numel() * 4, 2.0 * x.numel())
        rec["ms"][kind] = cuda_ms(lambda: dft_magnitude(x, window, n_fft=1, hop=1), iters=20)
        rec["plain_ms"][kind] = cuda_ms(lambda: dft_magnitude_plain(x, window, n_fft=1, hop=1),
                                        iters=5)
        rec["library_ms"][kind] = cuda_ms(
            lambda: torch.stft(samples, 1, hop_length=1, window=win, center=False,
                               return_complex=True).abs(), iters=20)
    return rec


def _rows(path):
    """(start, stop, label) rows of a TSV, zero-length rows dropped."""
    from orcai_tpu_torch.tools.parity import read_annotations

    return [r for r in read_annotations(path) if r[1] > r[0]]


def _golden_wire_bar(wire: str, path) -> None:
    """The reference's golden bar for a coded wire: mulaw8 as
    tests/test_wire_codec.py:197-225, bfp6 as :405-440, bfp5 as that bar
    outside the rows it splits in both packages, the spectral wires as
    tests/test_spectral.py:369-466. Raises when the TSV misses it."""
    import numpy as np

    got, want = _rows(path), _rows(FIXTURES / "golden_expected.txt")
    tol = 2 * ROW_S

    def same_rows(a, b, **close):
        return ([r[2] for r in a] == [r[2] for r in b]
                and np.allclose([r[:2] for r in a], [r[:2] for r in b], **close))

    if wire == "mulaw8":
        ok = same_rows(got, want, rtol=1e-5, atol=1e-8)  # pandas' assert_frame_equal
    elif wire in ("bfp6", "sp-bfp6"):
        ok = same_rows(got, want, rtol=0, atol=tol)
    elif wire == "bfp5":
        kept = [r for r in got if r not in BFP5_SPLIT]
        ok = (len(kept) == len(got) - len(BFP5_SPLIT)
              and same_rows(kept, [r for r in want if r not in GOLDEN_SPLIT], rtol=0, atol=tol))
    elif wire == "sp-bfp5":
        used = set()
        ok = True
        for s0, e0, lab in want:
            hit = next((j for j, (s1, e1, l1) in enumerate(got) if j not in used
                        and l1 == lab and abs(s1 - s0) <= tol and abs(e1 - e0) <= tol), None)
            if hit is None:
                ok = False
                break
            used.add(hit)
        residual = [r for j, r in enumerate(got) if j not in used]
        ok = ok and len(residual) <= 2 and all(e - s < 0.5 for s, e, _ in residual)
    else:  # sp11-bfp5: coverage
        lost_short, ok = 0, True
        for s0, e0, lab in want:
            cov = sum(max(0.0, min(e1, e0) - max(s1, s0)) for s1, e1, l1 in got if l1 == lab)
            if e0 - s0 < 0.25 and cov < 0.9 * (e0 - s0):
                lost_short += 1
            elif cov < 0.9 * (e0 - s0):
                ok = False
        outside = [g for g in got if not any(
            g[0] >= s0 - tol and g[1] <= e0 + tol for s0, e0, lab in want if lab == g[2])]
        ok = ok and lost_short <= 2 and len(outside) <= 2 and all(
            e - s < 0.5 for s, e, _ in outside)
    if not ok:
        raise AssertionError(f"golden on {wire} misses the reference's bar:\n"
                             + Path(path).read_text())


def _profiled_wire_costs(torch, prof, trace: Path) -> dict:
    """A wire's host cost and upload, read from a profiled frontend call: the
    frontend's own spans (ops/frontend.py: the resample and whole-recording
    encode, each tile's bfp encode) and the bytes of the trace's
    host-to-device copies."""
    from orcai_tpu_torch.ops.frontend import SPAN_PREPARE, SPAN_TILE_ENCODE

    spans = {e.key: e.cpu_time_total * 1e-6 for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.key in (SPAN_PREPARE, SPAN_TILE_ENCODE)}
    prof.export_chrome_trace(str(trace))
    copies = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    trace.unlink()
    if not copies or any("bytes" not in e.get("args", {}) for e in copies):
        raise AssertionError(f"the trace holds no host-to-device copy with its bytes: {copies[:2]}")
    return {"host_resample_or_encode_s": spans.get(SPAN_PREPARE, 0.0),
            "host_tile_encode_s": spans.get(SPAN_TILE_ENCODE, 0.0),
            "h2d_copies": len(copies), "bytes_uploaded": sum(e["args"]["bytes"] for e in copies)}


def phase_wires(torch, tmp: Path, seed: int, state: dict,
                total: dict) -> tuple[dict, dict, dict, dict, dict, dict]:
    """The coded and spectral wires on the card: B1 at their sizes and types,
    golden through each, B1's mixed, cluster, chirp and staged routes
    through create-spectrograms and the point route at n_fft 1 (the GEMM
    kernel, which no route reaches, timed directly as a yardstick), the
    20-minute recording in memory and streamed, and the host C codecs.
    Returns (the phase line, the mixed, the cluster, the chirp, the staged
    and the point route's rows)."""
    import numpy as np

    from orcai_tpu_torch import native
    from orcai_tpu_torch.io.wav import load_wav_for_frontend
    from orcai_tpu_torch.ops.dft import _mats_cached, _route_tables
    from orcai_tpu_torch.ops.frontend import compute_spectrogram_device
    from orcai_tpu_torch.ops.spectral import design_taps
    from orcai_tpu_torch.ops.wire_codec import encode_table
    from orcai_tpu_torch.pipeline.predict import predict
    from orcai_tpu_torch.tools.parity import check_wire_parity, compare_annotations
    from orcai_tpu_torch.tools.profile_data_prep import _device_items

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    line = {"phase": "wires"}
    line["b1"], mixed_row, cluster_row, chirp_row, staged_row, gemm_row = _b1_wire_checks(
        torch, np.random.default_rng(seed + 6), dev)

    # golden through every coded wire, on the card, against the reference's bars
    predictor, sp = state["predictor"], state["param"]["spectrogram"]
    golden = {}
    for wire in CODED_WIRES:
        out = tmp / f"golden_{wire}.txt"
        reset_counts()
        t0 = time.perf_counter()
        predict(FIXTURES / "golden.wav", output_path=out, overwrite=True, predictor=predictor,
                wire=wire)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(total)
        check_counts(counts, 1, f"golden {wire}", route=_b1_route(wire))
        _golden_wire_bar(wire, out)
        parity = compare_annotations(out, FIXTURES / "golden_expected.txt")
        parity.pop("residual_durations_raw_s")
        golden[wire] = {"wall_s": wall, "launches": counts, "inside_reference_bar": True,
                        "vs_exact": parity,
                        "contract_at_1_min": check_wire_parity(parity, 1.0)}
    line["golden"] = golden
    line["create_spectrograms_cli"] = {
        f"{nfft}/{n_overlap}": _create_spectrograms_path(torch, tmp, seed, total, nfft, n_overlap)
        for nfft, n_overlap in CLI_SPECTROGRAM_SIZES}
    point = _point_route_path(torch, np.random.default_rng(seed + 7), total)
    line["point_route_n_fft_1"] = point
    # the point route's row: the int16 minute as its main shape, every type beside it
    point_row = {
        "name": "dft_magnitude_point", "route": "cuda",
        "source": "orcai_tpu_torch/csrc/dft_point.cu",
        "replaces": "orcai_tpu/ops/pallas_dft.py:67",
        "max_abs_err": max(point["max_abs_err"].values()),
        "tolerance": "bit-equal to the plain version (0, in every type and on a code view one "
                     "byte off)",
        **{k: point[k]["int16"] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
        "by_type": {k: point[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                          "bit_equal_plain")},
        "shape": "B1's point route, n_fft 1 / hop 1, window 0.7: a minute of 48 kHz audio "
                 "(2,880,000 frames of one bin); ms, plain_ms, library_ms "
                 "(torch.stft(...).abs() on the samples as float32) and bound_ms for int16, "
                 "by_type for float32, int16 and uint8 codes; launches: every B1 call at n_fft 1 "
                 "(phase wires, point_route_n_fft_1)",
    }
    # the GEMM kernel, reached by no route since the point kernel took n_fft 1:
    # kept as the yardstick called directly (its checks and times above)
    line["gemm_yardstick"] = gemm_row
    # the GEMM route's tables at 40962 (6.7 GB on the card, as much on the
    # host) are not read again
    _route_tables.cache_clear()
    _mats_cached.cache_clear()
    torch.cuda.empty_cache()

    # the 20-minute recording in memory: the cost of each wire on this card
    audio, _ = load_wav_for_frontend(state["wav"], sr=sp["sampling_rate"])
    args = (sp["sampling_rate"], sp["nfft"], sp["n_overlap"], sp["freq_range"], sp["quantiles"])
    in_memory = {}
    for wire in ("exact", "mulaw8", "bfp5", "sp-bfp5"):
        rec = {}
        out = tmp / f"min20_{wire}.txt"
        reset_counts()
        t0 = time.perf_counter()
        predict(state["wav"], output_path=out, overwrite=True, predictor=predictor, wire=wire)
        torch.cuda.synchronize()
        rec["predict_wall_s"] = time.perf_counter() - t0
        rec["launches"] = read_counts(total)
        check_counts(rec["launches"], 7, f"20-minute {wire}", route=_b1_route(wire))
        rec["tsv_rows"] = len(out.read_text().splitlines()) - 1
        if wire != "exact":
            rec["vs_exact"] = compare_annotations(out, state["tsv"])
            rec["vs_exact"].pop("residual_durations_raw_s")
            rec["contract"] = check_wire_parity(
                compare_annotations(out, state["tsv"]), MINUTES)
        compute_spectrogram_device(audio, *args, device="cuda", wire=wire)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec, n_frames, _, _ = compute_spectrogram_device(audio, *args, device="cuda",
                                                          wire=wire)
        torch.cuda.synchronize()
        rec["frontend_wall_s"] = time.perf_counter() - t0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            compute_spectrogram_device(audio, *args, device="cuda", wire=wire)
            torch.cuda.synchronize()
        rec["frontend_device_ms"] = _device_items(torch, prof)["device_ms"]
        rec.update(_profiled_wire_costs(torch, prof, tmp / f"trace_{wire}.json"))
        if wire != "exact":
            cpu, _, _, _ = compute_spectrogram_device(audio, *args, device="cpu", wire=wire)
            err = float((cpu[:n_frames] - spec[:n_frames].cpu()).abs().max())
            rec["spectrogram_max_abs_err_vs_cpu"] = err
            if not err <= 2e-4:
                raise AssertionError(f"20-minute {wire}: spectrogram cuda vs cpu {err} > 2e-4")
            del cpu
        rec["aggregate"] = predictor.fetch_aggregated(
            *predictor.aggregate_device(spec, n_frames=n_frames))
        del spec
        in_memory[wire] = rec

    # streamed on mulaw8 and sp-bfp5, the audio resident and host-sliced
    streamed = {}
    b1_20, b2_20 = streaming_launches(state["n_samples"], predictor, sp["n_overlap"])
    for wire in ("mulaw8", "sp-bfp5"):
        agg0, cnt0 = in_memory[wire]["aggregate"]
        runs = {}
        for name, env in (("resident", {}), ("host_sliced", {"ORCAI_TPU_HBM_AUDIO_BYTES": 0})):
            out = tmp / f"stream20_{wire}_{name}.txt"
            run = _streamed_predict(torch, state["wav"], out, predictor, total,
                                    f"20-minute streaming {wire} ({name})", b1_20, b2_20,
                                    wire=wire, route=_b1_route(wire),
                                    ORCAI_TPU_STREAM_SPEC_BYTES=1, **env)
            agg, cnt = run.pop("result")
            if not np.array_equal(cnt, cnt0):
                raise AssertionError(f"streaming {wire} ({name}): overlap counts differ "
                                     "from in-memory")
            diff = np.abs(agg - agg0)
            run["aggregate_vs_in_memory"] = {"max": float(diff.max()), "mean": float(diff.mean())}
            parity = compare_annotations(out, tmp / f"min20_{wire}.txt")
            run["contract_vs_in_memory"] = check_wire_parity(parity, MINUTES)
            parity.pop("residual_durations_raw_s")
            run["vs_in_memory_tsv"] = parity
            # mulaw8 slices its codes anywhere: the exact wire's bar. The bfp
            # blocks sit on the recording's grid streamed and on each tile's
            # in memory (64 samples apart at hop 192), two encodings of one
            # wire: the reference's mean bar (tests/test_streaming.py:206-245),
            # its annotation contract (tools/parity.py) and SP_BFP5_STREAMED_MAX
            if wire == "mulaw8" and not diff.max() <= 1e-5:
                raise AssertionError(f"streaming mulaw8 ({name}): aggregate off by "
                                     f"{diff.max()} > 1e-5")
            if wire != "mulaw8" and not (diff.max() <= SP_BFP5_STREAMED_MAX
                                         and diff.mean() < 0.01
                                         and run["contract_vs_in_memory"]["ok"]):
                raise AssertionError(f"streaming {wire} ({name}): aggregate off by "
                                     f"{diff.max()} (mean {diff.mean()}), contract "
                                     f"{run['contract_vs_in_memory']}")
            runs[name] = (run, out, agg)
        if runs["resident"][1].read_bytes() != runs["host_sliced"][1].read_bytes():
            raise AssertionError(f"streaming {wire}: resident and host-sliced TSVs differ")
        if not np.array_equal(runs["resident"][2], runs["host_sliced"][2]):
            raise AssertionError(f"streaming {wire}: resident and host-sliced aggregates differ")
        streamed[wire] = {name: run for name, (run, _, _) in runs.items()}
        streamed[wire]["resident_host_sliced_tsv_byte_equal"] = True
    for rec in in_memory.values():
        rec.pop("aggregate")
    line["min20_in_memory"] = in_memory
    line["min20_streamed"] = streamed

    # the host C codecs were loaded, not their numpy paths
    x = np.zeros(4096, np.int16)
    taps34 = design_taps(48000, 15937.5, 3, 4)
    taps11 = design_taps(48000, 15937.5, 11, 16)
    loaded = {
        "library": native.library_path().name,
        "mulaw_encode": native.mulaw_encode_native(x, encode_table()) is not None,
        "bfp_encode": native.bfp_encode_native(x, 5, 128, 80) is not None,
        "resample34": native.resample34_native(x, taps34, 3072) is not None,
        "resample_poly": native.resample_poly_native(x, taps11, 11, 16, 2816) is not None,
    }
    if not all(v for k, v in loaded.items() if k != "library"):
        raise AssertionError(f"native host codecs not loaded: {loaded}")
    line["native"] = loaded
    line["seconds"] = time.perf_counter() - t_phase
    return line, mixed_row, cluster_row, chirp_row, staged_row, point_row


HPS_SEED = 7  # the search's project seed
HPS_MAX_EPOCHS, HPS_FACTOR = 2, 2  # 2 brackets, 5 rung-trials, 8 trial-epochs (10, 3 by
#                                     default; 4, 2 until the parallel phase's TP part needed
#                                     the wall)


class _EpochClock:
    """on_epoch_end hook of a search: the wall of each trained epoch (from
    the previous stamp, so a trial's first epoch includes its model build)
    and the peak device memory since the previous stamp, by trial."""

    def __init__(self, torch):
        self.torch = torch
        self.trials: dict[str, dict] = {}
        self.start()

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        self.last = time.perf_counter()

    def __call__(self, trial_id, state, history, epoch, lr, counters) -> None:
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        trial = self.trials.setdefault(trial_id, {"epoch_walls_s": [], "peak_device_bytes": 0})
        trial["epoch_walls_s"].append(now - self.last)
        trial["peak_device_bytes"] = max(trial["peak_device_bytes"],
                                         self.torch.cuda.max_memory_allocated())
        self.torch.cuda.reset_peak_memory_stats()
        self.last = time.perf_counter()


def _without_status(csv_text: str) -> list[list[str]]:
    """all_trials.csv's rows with the status column left out."""
    rows = [line.split(",") for line in csv_text.splitlines()]
    col = rows[0].index("status")
    return [r[:col] + r[col + 1:] for r in rows]


def phase_hpsearch(torch, tmp: Path, trained: dict, total: dict) -> dict:
    """The slab's main path: Hyperband over default_hps_parameter.json at
    its full widths, twice on one output directory, then the best model's
    predict."""
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.pipeline.predict import predict
    from orcai_tpu_torch.resources import DEFAULT_HPS_PARAMETER, DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.train.hpsearch import hyperband_schedule, hyperparameter_search

    hps = read_json(DEFAULT_HPS_PARAMETER)
    if (sorted(map(tuple, hps["filters"].values())), hps["lstm_units"], hps["batch_size"]) != (
            [(10, 20, 30, 40), (20, 30, 40, 50), (30, 40, 50, 60)], [64, 128], [64]):
        raise AssertionError(f"the default search space is not the published one: {hps}")
    param = {**read_json(DEFAULT_ORCAI_PARAMETER), "seed": HPS_SEED}
    out = tmp / "hps_out"
    brackets = hyperband_schedule(HPS_MAX_EPOCHS, HPS_FACTOR)
    n_trials = sum(n for rungs in brackets for n, _ in rungs)

    clock = _EpochClock(torch)
    t0 = time.perf_counter()
    hyperparameter_search(trained["data_dir"], out, orcai_parameter=param, hps_parameter=hps,
                          max_epochs=HPS_MAX_EPOCHS, factor=HPS_FACTOR, on_epoch_end=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logs = out / "hps_logs"
    csv_first = (logs / "all_trials.csv").read_text()
    best_first = (logs / "best_hyperparameters.json").read_bytes()
    records = {}
    for path in sorted((logs / param["name"]).glob("trial_*.json")):
        records[path.stem[len("trial_"):]] = json.loads(path.read_text())
    if len(records) != n_trials or sorted(clock.trials) != sorted(records):
        raise AssertionError(f"{len(records)} trial records and {len(clock.trials)} trained "
                             f"trials, expected {n_trials}")
    trials, epochs_trained = [], 0
    for trial_id, rec in records.items():
        walls = clock.trials[trial_id]["epoch_walls_s"]
        epochs_trained += len(walls)
        history = rec["history"]
        if not (all(math.isfinite(v) for k in ("loss", "val_loss", "val_MBA")
                    for v in history[k]) and 0.0 <= rec["score"] <= 1.0):
            raise AssertionError(f"trial {trial_id}: history {history}")
        trials.append({
            "trial_id": trial_id,
            "config": {k: rec[k] for k in ("filters", "kernel_size", "dropout_rate",
                                           "batch_size", "lstm_units")},
            "epochs": rec["epochs"], "epochs_trained": len(walls),
            "first_epoch_wall_s": walls[0],
            "warm_epoch_wall_s": walls[-1] if len(walls) > 1 else None,
            "epoch_walls_s": walls,
            "peak_device_bytes": clock.trials[trial_id]["peak_device_bytes"],
            "score": rec["score"],
        })
    promoted = [t["trial_id"] for t in trials if t["epochs"] > t["epochs_trained"]]
    if not promoted:
        raise AssertionError("no promotion carried weights")

    # the same call again on the same directory: every trial CACHED
    t0 = time.perf_counter()
    hyperparameter_search(trained["data_dir"], out, orcai_parameter=param, hps_parameter=hps,
                          max_epochs=HPS_MAX_EPOCHS, factor=HPS_FACTOR)
    torch.cuda.synchronize()
    wall_cached = time.perf_counter() - t0
    csv_again = (logs / "all_trials.csv").read_text()
    statuses = [r[-1] for r in (line.split(",") for line in csv_again.splitlines()[1:])]
    if statuses != ["CACHED"] * n_trials:
        raise AssertionError(f"the second search ran trials again: {statuses}")
    if _without_status(csv_again) != _without_status(csv_first):
        raise AssertionError("all_trials.csv differs on the second search")
    if (logs / "best_hyperparameters.json").read_bytes() != best_first:
        raise AssertionError("best_hyperparameters.json differs on the second search")

    # the best model, from its model directory, predicts golden
    best_dir = out / param["name"] / "hps"
    reset_counts()
    tsv = predict(FIXTURES / "golden.wav", model_dir=best_dir,
                  output_path=tmp / "golden_hps.txt", overwrite=True, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts(total)
    check_counts(counts, 1, "predict with the searched model")
    if tsv.read_text().splitlines()[0].split("\t") != ["start", "stop", "label"]:
        raise AssertionError("predict with the searched model wrote no TSV")
    return {"phase": "hpsearch", "max_epochs": HPS_MAX_EPOCHS, "factor": HPS_FACTOR,
            "brackets": brackets, "rung_trials": n_trials, "trial_epochs": epochs_trained,
            "steps_per_epoch": TVT_SNIPPETS[0] // 64, "trials": trials,
            "promoted_with_carried_weights": promoted, "search_wall_s": wall,
            "trials_per_hour": n_trials / wall * 3600.0,
            "first_epoch_wall_s_sum": sum(t["first_epoch_wall_s"] for t in trials),
            "best": json.loads(best_first), "second_search_wall_s": wall_cached,
            "second_search_all_cached": True, "outputs_equal_but_status": True,
            "best_model_predict_launches": counts}


def _fresh_process_trial(data_dir: Path, *extra: str) -> dict:
    """tools/profile_first_epoch.py in a process of its own."""
    args = [sys.executable, "-m", "orcai_tpu_torch.tools.profile_first_epoch", str(data_dir),
            "--seed", str(HPS_SEED), *extra]
    proc = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[1:])} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_first_epoch(torch, state: dict, trained: dict, searched: dict) -> dict:
    """Where a first epoch's extra wall goes (tools/profile_first_epoch.py).
    In this process, which has trained already: a shape of the search space
    that no trial ran (A), the same shape in a fresh model (A again) and a
    second new shape (B, under torch.profiler), each built, moved and
    trained two resident epochs with its stages timed. Then the bundled
    model's width in fresh processes that have trained nothing: as it is,
    with the initialiser's operations called once first, and after a
    predict of the 20-minute recording (a fresh process under
    torch.profiler, 44 s of this phase, is tools/profile_first_epoch.py
    --profile's to run on its own; B is profiled here)."""
    import itertools

    from orcai_tpu_torch.io.dataset import ArrayDataset
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.resources import DEFAULT_HPS_PARAMETER, DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.tools.profile_first_epoch import timed, trial_stages
    from orcai_tpu_torch.train.hpsearch import _apply_config
    from orcai_tpu_torch.train.trainer import DeviceData
    from orcai_tpu_torch.utils.seeds import SEED_ID_LOAD_TRAIN_DATA, SEED_ID_LOAD_VAL_DATA

    hps = read_json(DEFAULT_HPS_PARAMETER)
    param = {**read_json(DEFAULT_ORCAI_PARAMETER), "seed": HPS_SEED}
    run = {(t["config"]["filters"], t["config"]["kernel_size"], t["config"]["lstm_units"])
           for t in searched["trials"]}
    fresh = [s for s in itertools.product(hps["filters"], hps["kernel_size"],
                                          hps["lstm_units"]) if s not in run]
    a = fresh[0]
    b = next(s for s in fresh if s[1] != a[1])
    train_ds = ArrayDataset.load(trained["data_dir"] / "train_dataset")
    val_ds = ArrayDataset.load(trained["data_dir"] / "val_dataset")
    data, upload_s = timed(lambda: (DeviceData(train_ds), DeviceData(val_ds)))
    seeds = ([SEED_ID_LOAD_TRAIN_DATA, HPS_SEED], [SEED_ID_LOAD_VAL_DATA, HPS_SEED])
    line = {"phase": "first_epoch", "upload_s": upload_s,
            "train_phase_epoch_walls_s": trained["epoch_walls"]}
    for name, (filters, kernel, units) in (("A", a), ("A_again", a), ("B", b)):
        cfg = {"filters": filters, "kernel_size": kernel, "dropout_rate": 0.5,
               "batch_size": 64, "lstm_units": units}
        rec = trial_stages(_apply_config(param, hps, cfg), data, seeds, HPS_SEED,
                           profile=name == "B")
        line[name] = {"config": cfg, **rec}
    del data
    for name, extra in (("fresh", ()), ("fresh_first_calls", ("--first_calls",)),
                        ("after_predict", ("--predict_wav", str(state["wav"])))):
        t0 = time.perf_counter()
        line[f"process_{name}"] = _fresh_process_trial(trained["data_dir"], *extra)
        line[f"process_{name}"]["process_wall_s"] = time.perf_counter() - t0
    return line


def phase_bf16(torch, tmp: Path, state: dict, total: dict) -> dict:
    """predict with ORCAI_TPU_PREDICT_DTYPE=bf16: golden in memory and
    streamed against golden_expected.txt, and the 20-minute cell's wall and
    aggregated probabilities beside float32's."""
    import numpy as np

    from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR
    from orcai_tpu_torch.pipeline.predict import build_predictor, predict
    from orcai_tpu_torch.tools.profile_first_epoch import timed

    golden = (FIXTURES / "golden_expected.txt").read_bytes()
    line = {"phase": "bf16"}
    with environ(ORCAI_TPU_PREDICT_DTYPE="bf16"):
        out = tmp / "golden_bf16.txt"
        reset_counts()
        _, line["golden_wall_s_first_call"] = timed(lambda: predict(
            FIXTURES / "golden.wav", output_path=out, overwrite=True, device="cuda"))
        counts = read_counts(total)
        check_counts(counts, 1, "golden bf16")
        line["golden_launches"] = counts
        line["golden_tsv_byte_equal"] = out.read_bytes() == golden
        bf16, _, _ = build_predictor(DEFAULT_MODEL_DIR, 128, "cuda")
        if next(bf16.model.parameters()).dtype != torch.float32:
            raise AssertionError("bf16 predict: the parameters are not float32")
        sp = state["param"]["spectrogram"]
        out_s = tmp / "golden_bf16_stream.txt"
        run = _streamed_predict(torch, FIXTURES / "golden.wav", out_s, bf16, total,
                                "golden bf16 streaming",
                                *streaming_launches(2_880_000, bf16, sp["n_overlap"]),
                                ORCAI_TPU_STREAM_SPEC_BYTES=1)
        run.pop("result")
        line["golden_streamed"] = run
        line["golden_streamed_tsv_byte_equal"] = out_s.read_bytes() == golden
        # the 20-minute cell, warm, bf16 then f32 on the same recording
        walls = {}
        for name, predictor in (("bf16", bf16), ("f32", state["predictor"])):
            walls[name] = []
            for i in range(3):
                reset_counts()
                _, wall = timed(lambda: predict(
                    state["wav"], output_path=tmp / f"min20_{name}.txt", overwrite=True,
                    predictor=predictor))
                check_counts(read_counts(total), 7, f"20-minute {name}")
                walls[name].append(wall)
        agg, count, n_out = bf16.aggregate_device(state["spec"], n_frames=state["n_frames"])
        aggregated, overlap = bf16.fetch_aggregated(agg, count, n_out)
    line["min20_predict_wall_s"] = walls
    line["min20_bf16_over_f32_warm"] = walls["bf16"][-1] / walls["f32"][-1]
    diff = np.abs(aggregated - state["aggregated"])
    line["min20_aggregated_max_abs_diff_vs_f32"] = float(diff.max())
    line["min20_aggregated_mean_abs_diff_vs_f32"] = float(diff.mean())
    line["min20_tsv_byte_equal_f32"] = (tmp / "min20_bf16.txt").read_bytes() == \
        state["tsv"].read_bytes()
    if not np.array_equal(overlap, state["overlap"]):
        raise AssertionError("bf16 20-minute: overlap counts differ from float32's")
    if not (line["golden_tsv_byte_equal"] and line["golden_streamed_tsv_byte_equal"]):
        raise AssertionError(
            "bf16 golden TSV differs from golden_expected.txt:\n"
            + (out.read_text() if not line["golden_tsv_byte_equal"] else out_s.read_text()))
    return line


def phase_bf16_train(torch, tmp: Path, trained: dict) -> dict:
    """`train` with compute_dtype bfloat16 at orcai-v1's width: one epoch,
    then warm steps; the weights saved in float32 and loaded back."""
    import numpy as np

    from orcai_tpu_torch.io.dataset import ArrayDataset
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.io.model_store import load_orcai_model, load_variables
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.train.trainer import Trainer

    param = read_json(DEFAULT_ORCAI_PARAMETER)
    param.update(name="smoke-bf16", seed=trained["seed"])
    param["model"].update(compute_dtype="bfloat16", learning_rate=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model_dir, walls = _train_run(torch, trained["data_dir"], tmp / "models", param, max_epochs=1)
    peak = torch.cuda.max_memory_allocated()
    history = _finite_history(model_dir, 1)
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(load_variables(model_dir / "smoke-bf16.msgpack"))
    if {np.asarray(v).dtype for v in leaves} != {np.dtype(np.float32)}:
        raise AssertionError("bf16 training saved weights that are not float32")
    model, _, _ = load_orcai_model(model_dir, dtype=torch.bfloat16, device="cuda")
    batch = param["model"]["batch_size"]
    ds = ArrayDataset.load(trained["data_dir"] / "train_dataset")
    x = torch.from_numpy(np.asarray(ds.x[:batch])).cuda()
    y = torch.from_numpy(np.asarray(ds.y[:batch])).cuda()
    trainer = Trainer(model, TRAIN_LR, device="cuda")
    state = trainer.state_from_variables(seed=trained["seed"])
    torch.cuda.reset_peak_memory_stats()
    step_ms = _steps_ms(torch, trainer, state, x, y)
    f32 = trained["history"]
    return {"phase": "bf16_train", "epoch_wall_s": walls, "peak_device_bytes_train": peak,
            "peak_device_bytes_steps": torch.cuda.max_memory_allocated(),
            "step_ms_median_warm": statistics.median(step_ms), "step_ms": step_ms,
            "step_ms_median_f32": trained["step_ms"],
            "loss_epoch_1": history["loss"][0], "loss_epoch_1_f32": f32["loss"][0],
            "val_loss_epoch_1": history["val_loss"][0],
            "val_loss_epoch_1_f32": f32["val_loss"][0],
            "weights_float32_and_load": True}


ARCH_CPU_ATOL = 2e-5  # the CRNN bar (tests/test_model_parity.py:59), card against CPU


def phase_architectures(torch, tmp: Path, trained: dict, total: dict) -> dict:
    """ResNet1DConv and ResNetTCN at orcai-v1's widths: two resident epochs
    through `train`, warm steps, the forward on the card against the CPU,
    and golden through `predict` with the trained directory."""
    import numpy as np

    from orcai_tpu_torch.io.dataset import ArrayDataset
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.pipeline.predict import predict
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.train.trainer import Trainer

    line = {"phase": "architectures"}
    test_ds = ArrayDataset.load(trained["data_dir"] / "test_dataset")
    xs = torch.from_numpy(np.asarray(test_ds.x[:8]))
    for arch in ("ResNet1DConv", "ResNetTCN"):
        param = read_json(DEFAULT_ORCAI_PARAMETER)
        param.update(name=f"smoke-{arch}", architecture=arch, seed=trained["seed"])
        param["model"].update(learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model_dir, walls = _train_run(torch, trained["data_dir"], tmp / "models", param,
                                      max_epochs=2)
        peak = torch.cuda.max_memory_allocated()
        history = _finite_history(model_dir, 2)
        model, _, _ = load_orcai_model(model_dir, device="cuda")
        batch = param["model"]["batch_size"]
        ds = ArrayDataset.load(trained["data_dir"] / "train_dataset")
        trainer = Trainer(model, TRAIN_LR, device="cuda")
        state = trainer.state_from_variables(seed=trained["seed"])
        step_ms = _steps_ms(torch, trainer, state,
                            torch.from_numpy(np.asarray(ds.x[:batch])).cuda(),
                            torch.from_numpy(np.asarray(ds.y[:batch])).cuda())
        card, _, _ = load_orcai_model(model_dir, device="cuda")
        cpu, _, _ = load_orcai_model(model_dir, device="cpu")
        with torch.inference_mode():
            err = float((card(xs.cuda()).cpu() - cpu(xs)).abs().max())
        if not err <= ARCH_CPU_ATOL:
            raise AssertionError(f"{arch}: card against CPU forward {err} > {ARCH_CPU_ATOL}")
        reset_counts()
        tsv = predict(FIXTURES / "golden.wav", model_dir=model_dir,
                      output_path=tmp / f"golden_{arch}.txt", overwrite=True, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts(total)
        check_counts(counts, 1, f"predict with the trained {arch}")
        if tsv.read_text().splitlines()[0].split("\t") != ["start", "stop", "label"]:
            raise AssertionError(f"predict with the trained {arch} wrote no TSV")
        line[arch] = {"history": history, "first_epoch_wall_s": walls[0],
                      "warm_epoch_wall_s": walls[1], "peak_device_bytes": peak,
                      "step_ms_median_warm": statistics.median(step_ms), "step_ms": step_ms,
                      "card_vs_cpu_forward_max_abs_diff": err, "atol": ARCH_CPU_ATOL,
                      "trainable_parameters": sum(p.numel() for p in model.parameters()
                                                  if p.requires_grad),
                      "predict_launches": counts}
    line["step_ms_median_resnetlstm"] = trained["step_ms"]
    return line


def _cli(args: list[str], timeout: int = 600) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "orcai_tpu_torch", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m orcai_tpu_torch {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc, wall


def _served_latency(report: str, name: str) -> float:
    """The service's `<wav> -> <tsv> (<s> s)` line for `name`."""
    for wav, seconds in _served_latencies(report):
        if wav == name:
            return seconds
    raise AssertionError(f"the service reported no latency for {name}:\n{report[-2000:]}")


def phase_warmup_serve(torch, tmp: Path) -> dict:
    """`warmup --minutes 1` and `serve` through the command line, each in a
    process of its own: a cold service and one given --warm_minutes 1,
    each over a folder holding golden (its TSV byte-equal to golden's).
    Their kernel launches are their processes', not counted here."""
    golden = (FIXTURES / "golden_expected.txt").read_bytes()
    line = {"phase": "warmup_serve"}
    proc, line["warmup_process_wall_s"] = _cli(["warmup", "--minutes", "1", "-v", "2"])
    line["warmup_stdout"] = proc.stdout.strip().splitlines()[-1]
    line["warmup_shape_walls_s"] = [float(t.rsplit(" in ", 1)[1].split()[0])
                                    for t in proc.stdout.splitlines() if "bucket ready in" in t]
    for name, warm in (("cold", []), ("warm", ["--warm_minutes", "1"])):
        watch, out = tmp / f"serve_{name}_in", tmp / f"serve_{name}_out"
        watch.mkdir()
        shutil.copy(FIXTURES / "golden.wav", watch / "golden.wav")
        proc, wall = _cli(["serve", str(watch), "-o", str(out), "-mf", "1", "-ps", "0",
                           "-v", "2", *warm])
        tsv = out / "golden_c1_orcai-v1_predicted.txt"
        if tsv.read_bytes() != golden:
            raise AssertionError(f"serve ({name}): golden TSV differs from golden_expected.txt")
        line[f"serve_{name}"] = {"process_wall_s": wall, "tsv_byte_equal": True,
                                 "first_file_latency_s": _served_latency(proc.stdout,
                                                                         "golden.wav"),
                                 "console_report": proc.stdout.splitlines()}
    return line


REFERENCE_FORMATS = FIXTURES / "reference_formats"


def _sha256_tree(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _convert_cli(tvt: Path, *args: str) -> tuple[dict, float, str]:
    """`convert-dataset` in a subprocess: (sha256 of each file it wrote or
    changed under the output dir, wall, its summary line)."""
    out = Path(args[args.index("-o") + 1]) if "-o" in args else tvt
    before = _sha256_tree(out) if out.exists() else {}
    proc, wall = _cli(["convert-dataset", str(tvt), *args])
    after = _sha256_tree(out)
    # the report's last section header, without its mark and times
    summary = re.sub(r"^🐳 (.*) \[[^\]]*\]$", r"\1", proc.stdout.strip().splitlines()[-1])
    return {k: v for k, v in after.items() if before.get(k) != v}, wall, summary


def _state_equal(state: dict, want: dict, where: str) -> None:
    for key, value in want.items():
        got = state[key].detach().cpu().contiguous().numpy()
        if got.dtype != value.dtype or got.tobytes() != value.tobytes():
            raise AssertionError(f"{where}: {key} is not bit-equal to the bundled msgpack's")


def phase_reference_formats(torch, tmp: Path, seed: int, state: dict, total: dict) -> dict:
    """The reference formats on the card (tests/fixtures/reference_formats,
    written by Keras and TensorFlow): `convert-dataset` on the GZIP tf.data
    snapshots through the CLI (every file's sha256 as the JAX package wrote
    it, a second run skipping both splits, -ow and -o writing the same
    bytes), one epoch on the converted data at orcai-v1's widths, the
    orcai-v1.keras dir and its bare model_weights.h5 loaded bit-equal to the
    bundled msgpack and predicting golden in memory and streamed, and
    `train --load_model` starting from the archive's weights."""
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.io.model_store import (
        DEFAULT_MODEL_DIR, convert_flax_variables, load_orcai_model, load_variables,
    )
    from orcai_tpu_torch.io.tfdata_convert import convert_tvt_datasets
    from orcai_tpu_torch.native import native_available
    from orcai_tpu_torch.pipeline.predict import build_predictor, predict
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.train import trainer as trainer_module

    if not native_available():
        raise AssertionError("the host C library (crc32c) did not build")
    line = {"phase": "reference_formats"}
    src = REFERENCE_FORMATS / "tvt"
    expected = json.loads((src / "expected.json").read_text())
    tvt = tmp / "ref_tvt"
    shutil.copytree(src, tvt, ignore=shutil.ignore_patterns("expected.json"))
    written, line["convert_cli_wall_s"], summary = _convert_cli(tvt)
    if written != expected:
        raise AssertionError(f"convert-dataset wrote {written}, expected.json has {expected}")
    if summary != "Converted train_dataset (8 samples), val_dataset (4 samples)":
        raise AssertionError(f"convert-dataset printed {summary!r}")
    written, _, summary = _convert_cli(tvt)
    if written or summary != "Nothing to convert (all splits already converted)":
        raise AssertionError(f"the second run did not skip both splits: {summary!r} {written}")
    before = _sha256_tree(tvt)
    _, line["convert_cli_overwrite_wall_s"], _ = _convert_cli(tvt, "-ow")
    if _sha256_tree(tvt) != before:
        raise AssertionError("convert-dataset -ow wrote other bytes")
    elsewhere = tmp / "ref_tvt_out"
    written, _, _ = _convert_cli(tvt, "-o", str(elsewhere))
    want = {**expected, "dataset_shapes.json": before["dataset_shapes.json"]}
    if written != want:
        raise AssertionError(f"convert-dataset -o wrote {written}, expected {want}")
    # the conversion's own wall, in this process, on a fresh copy
    again = tmp / "ref_tvt_again"
    shutil.copytree(src, again)
    read_bytes = sum(p.stat().st_size for p in again.rglob("*.snapshot"))
    t0 = time.perf_counter()
    convert_tvt_datasets(again)
    wall = time.perf_counter() - t0
    out_bytes = sum(p.stat().st_size for p in again.rglob("*.npy"))
    line["convert"] = {"wall_s": wall, "snapshot_bytes": read_bytes, "npy_bytes": out_bytes,
                       "snapshot_MB_per_s": read_bytes / wall / 1e6,
                       "npy_MB_per_s": out_bytes / wall / 1e6}

    # one epoch at orcai-v1's widths, batch 4, on the converted snapshots
    param = read_json(DEFAULT_ORCAI_PARAMETER)
    param.update(name="smoke-converted", seed=seed)
    param["model"].update(batch_size=4, learning_rate=TRAIN_LR)
    model_dir, walls = _train_run(torch, tvt, tmp / "models", param, max_epochs=1)
    line["train_converted"] = {"history": _finite_history(model_dir, 1), "epoch_wall_s": walls}

    # the .keras dir and a dir with only its model.weights.h5 as model_weights.h5
    bundled = convert_flax_variables(load_variables(DEFAULT_MODEL_DIR / "orcai-v1.msgpack"))
    keras_dir = REFERENCE_FORMATS / "orcai-v1"
    h5_dir = tmp / "ref_h5_model"
    h5_dir.mkdir()
    for name in ("orcai_parameter.json", "model_shape.json"):
        shutil.copy2(keras_dir / name, h5_dir / name)
    with zipfile.ZipFile(keras_dir / "orcai-v1.keras") as archive:
        (h5_dir / "model_weights.h5").write_bytes(archive.read("model.weights.h5"))
    load_walls = {"msgpack": [], "keras": [], "model_weights_h5": []}
    for name in ("msgpack", "keras", "model_weights_h5", "model_weights_h5", "keras",
                 "msgpack"):
        where = {"msgpack": DEFAULT_MODEL_DIR, "keras": keras_dir,
                 "model_weights_h5": h5_dir}[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, _, _ = load_orcai_model(where, device="cuda")
        torch.cuda.synchronize()
        load_walls[name].append(time.perf_counter() - t0)
        _state_equal(model.state_dict(), bundled, f"load_orcai_model({where.name})")
    line["load_wall_s"] = load_walls
    golden = (FIXTURES / "golden_expected.txt").read_bytes()
    sp = state["param"]["spectrogram"]
    for name, where in (("keras", keras_dir), ("model_weights_h5", h5_dir)):
        out = tmp / f"golden_{name}.txt"
        reset_counts()
        predict(FIXTURES / "golden.wav", model_dir=where, output_path=out, overwrite=True,
                device="cuda")
        torch.cuda.synchronize()
        counts = read_counts(total)
        check_counts(counts, 1, f"golden from the {name} dir")
        if out.read_bytes() != golden:
            raise AssertionError(f"golden from the {name} dir differs:\n{out.read_text()}")
        predictor, _, _ = build_predictor(where, 128, "cuda")
        out_s = tmp / f"golden_{name}_stream.txt"
        run = _streamed_predict(torch, FIXTURES / "golden.wav", out_s, predictor, total,
                                f"golden streamed from the {name} dir",
                                *streaming_launches(2_880_000, predictor, sp["n_overlap"]),
                                ORCAI_TPU_STREAM_SPEC_BYTES=1)
        if out_s.read_bytes() != golden:
            raise AssertionError(f"golden streamed from the {name} dir differs:\n"
                                 + out_s.read_text())
        line[f"golden_{name}"] = {"tsv_byte_equal": True, "launches": counts,
                                  "streamed_tsv_byte_equal": True,
                                  "streamed_launches": run["launches"]}

    # train --load_model with the .keras dir as the model dir
    models = tmp / "keras_models"
    shutil.copytree(keras_dir, models / "orcai-v1")
    param = read_json(keras_dir / "orcai_parameter.json")
    param["seed"] = seed
    param["model"].update(batch_size=4, learning_rate=TRAIN_LR)
    first = {}
    real_step = trainer_module.Trainer.train_step

    def step(self, train_state, x, y):
        if not first:
            first.update(train_state.model.state_dict())
            _state_equal(first, bundled, "train --load_model before its first step")
        return real_step(self, train_state, x, y)

    trainer_module.Trainer.train_step = step
    try:
        model_dir, walls = _train_run(torch, tvt, models, param, max_epochs=1,
                                      load_model=True)
    finally:
        trainer_module.Trainer.train_step = real_step
    if not first:
        raise AssertionError("train --load_model took no step")
    line["train_load_keras"] = {"history": _finite_history(model_dir, 1), "epoch_wall_s": walls,
                                "weights_before_first_step_bit_equal": True}
    line["nvidia_smi"] = nvidia_smi_line()
    return line


PAR_STEPS = 8  # the NCCL comparison: steps at batch 64 over the train data's batches
PAR_CHANGE_RTOL = 5e-2  # the weights' change over PAR_STEPS, two ranks against one process,
#                         of the change itself (read 1.0e-2: the first step's gradients
#                         read 1.0e-4 apart and Adam's normalised steps carry that into every
#                         weight; one process against itself 7.4e-4, a plain DDP wrap 0.60)
PAR_SPLIT_ATOL = 1e-6  # window split against one replica: the reference's bar for its
#                        sharded predictor (tests/test_overlap.py:154)
PAR_HPS_MAX_EPOCHS, PAR_HPS_FACTOR = 2, 2  # the two-process search: 2 brackets, 5 rung-trials
TP_GRID = (1, 2)  # (data, model) ranks of the tensor-parallel part
TP_STEPS = 3  # its steps: gloo carries its gathers through host memory, 7-10 s a step
PAR_CHILD = r"""
import json, sys, time
from orcai_tpu_torch.parallel.distributed import initialize_distributed, process_count, process_index

initialize_distributed()  # WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT
from orcai_tpu_torch.io.jsonio import read_json
from orcai_tpu_torch.pipeline.predict import DEFAULT_CALL_DURATION_LIMITS, predict
from orcai_tpu_torch.pipeline.spectrogram import create_spectrograms
from orcai_tpu_torch.resources import DEFAULT_HPS_PARAMETER
from orcai_tpu_torch.train.hpsearch import hyperparameter_search

a = json.loads(sys.argv[1])
line = {"rank": process_index(), "count": process_count()}
t0 = time.perf_counter()
report = create_spectrograms(a["spec_table"], a["spec_out"], orcai_parameter=a["spec_param"],
                             device="cuda")
line["create_spectrograms_s"] = time.perf_counter() - t0
line["spectrograms"] = report["n_recordings"]
t0 = time.perf_counter()
saved = predict(a["pred_table"], output_path=a["pred_out"], save_probabilities=True,
                call_duration_limits=DEFAULT_CALL_DURATION_LIMITS, device="cuda")
line["predict_table_s"] = time.perf_counter() - t0
line["predicted"] = [p.name for p in saved]
for run in ("search", "rerun"):
    t0 = time.perf_counter()
    hyperparameter_search(a["tvt"], a["hps_out"], orcai_parameter=a["hps_param"],
                          hps_parameter=read_json(DEFAULT_HPS_PARAMETER),
                          max_epochs=a["max_epochs"], factor=a["factor"], device="cuda")
    line[f"{run}_s"] = time.perf_counter() - t0
    csv = a["hps_out"] + "/hps_logs/all_trials.csv"
    if process_index() == 0:
        line[f"{run}_all_trials_csv"] = open(csv).read()
print("PAR-CHILD " + json.dumps(line), flush=True)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _norm_rel(a: dict, b: dict, keys) -> float:
    """||a - b|| / ||b|| over the tensors named: Adam moves a weight whose
    gradient is near float noise by about the learning rate either way, so
    an elementwise bar would read that noise, not the split."""
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in keys)
    den = sum(float((b[k].double() ** 2).sum()) for k in keys)
    return math.sqrt(num / max(den, 1e-300))


def _max_elem_rel(a: dict, b: dict, keys) -> float:
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp(min=1e-30))
               for k in keys)


def _dp_batches(torch, data_dir: Path, device) -> list:
    """The train data's first PAR_STEPS batches of 64, on `device`."""
    import numpy as np

    from orcai_tpu_torch.io.dataset import ArrayDataset

    ds = ArrayDataset.load(Path(data_dir) / "train_dataset")
    return [(torch.from_numpy(np.asarray(ds.x[i * 64:(i + 1) * 64])).to(device),
             torch.from_numpy(np.asarray(ds.y[i * 64:(i + 1) * 64], np.float32)).to(device))
            for i in range(PAR_STEPS)]


def _dp_steps(torch, trainer, seed: int, batches) -> dict:
    """PAR_STEPS train steps from the trainer's weights, each on this
    process's block of the batch: the first step's gradients (DDP's average
    when distributed), every step's global loss and ms (CUDA events), the
    state after; a sharded model's blocks gathered whole."""
    import numpy as np
    import torch.distributed as dist

    from orcai_tpu_torch.models.layers import shard_of
    from orcai_tpu_torch.parallel.sharding_rules import gather_params

    st = trainer.state_from_variables(seed=seed)
    model = trainer.model
    shard = next((shard_of(m) for m in model.modules() if shard_of(m) is not None), None)
    losses, grads, ms = [], None, []
    for x, y in batches:
        idx = torch.from_numpy(trainer.block(np.arange(x.shape[0]))).to(x.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = trainer.train_step(st, x[idx], y[idx])
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        if grads is None:
            grads = {k: (shard.gather(p.grad, 0) if shard and k in shard.names else p.grad)
                     .detach().double().cpu()
                     for k, p in model.named_parameters() if p.grad is not None}
        if trainer.distributed:
            dist.all_reduce(m, group=trainer.data_group)
        losses.append(float(m[0]))
    state = {k: v.detach().double().cpu() for k, v in gather_params(model).items()
             if v.dtype.is_floating_point}
    return {"grads": grads, "losses": losses, "state": state, "step_ms": ms}


def _dp_worker(data_dir: str, seed: int, naive: bool, out: str, device) -> None:
    """One of two processes on the card (launch): _dp_steps from the
    bundled weights over the distributed Trainer, or with `naive` over a
    plain DDP wrap (each process's own BatchNorm statistics and dropout
    masks, the mean of the processes' loss means), the control that the
    comparison must tell apart. Rank 0 saves what it read."""
    import torch

    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.models import l2_regularization
    from orcai_tpu_torch.ops.losses import weighted_masked_bce_from_logits
    from orcai_tpu_torch.train.trainer import Trainer

    model, _, _ = load_orcai_model(device=device)
    trainer = Trainer(model, TRAIN_LR, device=device, distributed=True)
    if naive:
        model.set_data_parallel(None)
        trainer._loss = lambda logits, y: (weighted_masked_bce_from_logits(logits, y, None)
                                           + l2_regularization(model))
    result = _dp_steps(torch, trainer, seed, _dp_batches(torch, data_dir, device))
    if trainer.rank == 0:
        torch.save(result, out)


def _tp_worker(data_dir: str, seed: int, out: str, device) -> None:
    """One of the TP_GRID processes on the card (launch): _dp_steps from
    the bundled weights over a (data, model) mesh, the parameters sharded
    over its model axis. Each rank saves its own parameter bytes; rank 0
    saves what it read and the sharded leaves' names."""
    import torch

    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.parallel.mesh import make_mesh
    from orcai_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(n_model=TP_GRID[1])
    model, _, _ = load_orcai_model(device=device)
    trainer = Trainer(model, TRAIN_LR, device=device, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    result = _dp_steps(torch, trainer, seed, _dp_batches(torch, data_dir, device)[:TP_STEPS])
    result["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    result["sharded"] = sorted({k for m in model.modules()
                                for k in getattr(getattr(m, "tp", None), "names", ())})
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.save(result, f"{out}.{torch.distributed.get_rank()}")


def _change_rel(run: dict, plain: dict, start: dict, keys) -> float:
    """||(run - start) - (plain - start)|| / ||plain - start||: the
    difference of two updates against the update itself."""
    return _norm_rel({k: run[k].double() - start[k].double() for k in keys},
                     {k: plain[k].double() - start[k].double() for k in keys}, keys)


def _two_ranks_against_control(torch, tmp: Path, data_dir: Path, seed: int,
                               float64_grads: dict) -> tuple[dict, dict]:
    """PAR_STEPS steps at 64 from the bundled weights: one process, the
    same again (cuDNN's backward is not deterministic: the floor), two gloo
    ranks sharing the card (32 + 32) through the distributed Trainer, and
    the same two ranks under a plain DDP wrap. Each run is read against the
    one process on the first step's gradients and on the change of the
    weights and of the BatchNorm statistics over the steps; the distributed
    run must read within the bars and the plain wrap above them, so the
    check can fail a wrong split. Every run's first gradients are also read
    against `float64_grads` (the same step in float64, _grad_split), and
    the two ranks against one process running their BatchNorm
    (one_process_synced_bn); neither reading is held. Returns the line and
    the starting state."""
    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.parallel.distributed import launch
    from orcai_tpu_torch.train.trainer import Trainer

    import torch.distributed as dist

    start = {k: v.detach().double().cpu()
             for k, v in load_orcai_model(device="cpu")[0].state_dict().items()
             if v.dtype.is_floating_point}
    batches = _dp_batches(torch, data_dir, "cuda")
    plain, again = (_dp_steps(torch, Trainer(load_orcai_model(device="cuda")[0], TRAIN_LR,
                                             device="cuda"), seed, batches)
                    for _ in range(2))
    # the distributed Trainer's arithmetic (the synced BatchNorm) in one
    # process: a gloo group of one
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "synced_store"), 1),
                            rank=0, world_size=1)
    try:
        synced = _dp_steps(torch, Trainer(load_orcai_model(device="cuda")[0], TRAIN_LR,
                                          device="cuda", distributed=True), seed, batches)
    finally:
        dist.destroy_process_group()
    params = sorted(plain["grads"])
    stats = [k for k in start if "running" in k]
    line = {"steps": PAR_STEPS, "batch": 64, "losses_one_process": plain["losses"],
            "one_process_grads_vs_float64": _norm_rel(plain["grads"], float64_grads, params)}
    runs = {"one_process_again": again, "one_process_synced_bn": synced}
    for name, naive in (("two_ranks", False), ("plain_ddp_control", True)):
        out = tmp / f"dp_steps_{name}.pt"
        t0 = time.perf_counter()
        launch(_dp_worker, ["cuda:0", "cuda:0"], tmp, args=(str(data_dir), seed, naive, str(out)))
        runs[name] = torch.load(out)
        runs[name]["wall_s"] = time.perf_counter() - t0
    for name, run in runs.items():
        moved = {k: float(((run["state"][k] - plain["state"][k]) ** 2).sum()) for k in params}
        line[name] = {
            "grads_norm_rel_diff": _norm_rel(run["grads"], plain["grads"], params),
            "weights_change_rel_diff": _change_rel(run["state"], plain["state"], start, params),
            "bn_stats_change_rel_diff": _change_rel(run["state"], plain["state"], start, stats),
            "loss_max_rel_diff": max(abs(a - b) / abs(b)
                                     for a, b in zip(run["losses"], plain["losses"])),
            "grads_vs_float64": _norm_rel(run["grads"], float64_grads, params),
            "losses": run["losses"], "wall_s": run.get("wall_s"),
            "weights_change_diff_top": sorted(moved, key=moved.get)[-5:]}
    # the two ranks against the same arithmetic in one process (read, not held)
    two, one = runs["two_ranks"], synced
    line["two_ranks_vs_one_process_synced_bn"] = {
        "grads_norm_rel_diff": _norm_rel(two["grads"], one["grads"], params),
        "weights_change_rel_diff": _change_rel(two["state"], one["state"], start, params),
        "bn_stats_change_rel_diff": _change_rel(two["state"], one["state"], start, stats),
        "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(two["losses"],
                                                                     one["losses"]))}
    bars = {"grads_norm_rel_diff": RUNNER_RTOL, "bn_stats_change_rel_diff": RUNNER_RTOL,
            "weights_change_rel_diff": PAR_CHANGE_RTOL}
    real, control = line["two_ranks"], line["plain_ddp_control"]
    if not all(real[k] <= bar < control[k] for k, bar in bars.items()):
        raise AssertionError(f"two gloo ranks against one process and a plain DDP wrap: "
                             f"the first must read within {bars}, the second above: {line}")
    line["bars"] = bars
    return line, start


def _tensor_parallel(torch, tmp: Path, data_dir: Path, seed: int, start: dict) -> dict:
    """TP_STEPS steps at 64 from the bundled weights over a TP_GRID (data,
    model) grid of gloo ranks sharing the card, the parameters sharded over
    the model axis (parallel/sharding_rules.py), against the same steps in
    one plain process: the losses and the first step's gradients within
    RUNNER_RTOL, the change of the BatchNorm statistics within RUNNER_RTOL
    and of the weights within PAR_CHANGE_RTOL; each rank's parameter bytes
    against one process's (the sharded leaves halved), the TP step's ms
    against the plain step's."""
    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.parallel.distributed import launch
    from orcai_tpu_torch.train.trainer import Trainer

    plain = _dp_steps(torch, Trainer(load_orcai_model(device="cuda")[0], TRAIN_LR, device="cuda"),
                      seed, _dp_batches(torch, data_dir, "cuda")[:TP_STEPS])

    out = tmp / "tp_steps.pt"
    t0 = time.perf_counter()
    launch(_tp_worker, ["cuda:0"] * (TP_GRID[0] * TP_GRID[1]), tmp,
           args=(str(data_dir), seed, str(out)))
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.{r}") for r in range(TP_GRID[0] * TP_GRID[1])]
    tp = ranks[0]
    params = sorted(plain["grads"])
    stats = [k for k in start if "running" in k]
    line = {
        "grid": {"data": TP_GRID[0], "model": TP_GRID[1]}, "steps": TP_STEPS, "batch": 64,
        "losses": tp["losses"], "losses_one_process": plain["losses"],
        "loss_max_rel_diff": max(abs(a - b) / abs(b)
                                 for a, b in zip(tp["losses"], plain["losses"])),
        "grads_norm_rel_diff": _norm_rel(tp["grads"], plain["grads"], params),
        "weights_change_rel_diff": _change_rel(tp["state"], plain["state"], start, params),
        "bn_stats_change_rel_diff": _change_rel(tp["state"], plain["state"], start, stats),
        "sharded_leaves": len(tp["sharded"]),
        "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
        "param_bytes_one_process": sum(p.numel() * p.element_size()
                                       for p in load_orcai_model(device="cpu")[0].parameters()),
        "step_ms": tp["step_ms"], "step_ms_median_warm": statistics.median(tp["step_ms"][2:]),
        "step_ms_plain": plain["step_ms"],
        "step_ms_median_warm_plain": statistics.median(plain["step_ms"][2:]),
        "peak_gb_per_rank": [r["peak_gb"] for r in ranks], "wall_s": wall,
        "note": "two ranks share one card; gloo carries the gathers through host memory"}
    bars = {"loss_max_rel_diff": RUNNER_RTOL, "grads_norm_rel_diff": RUNNER_RTOL,
            "bn_stats_change_rel_diff": RUNNER_RTOL, "weights_change_rel_diff": PAR_CHANGE_RTOL}
    if not all(line[k] <= bar for k, bar in bars.items()):
        raise AssertionError(f"tensor-parallel steps against one process: {line}")
    if not line["sharded_leaves"] or not all(
            b < line["param_bytes_one_process"] for b in line["param_bytes_per_rank"]):
        raise AssertionError(f"no parameter was sharded: {line}")
    line["bars"] = bars
    return line


def _grad_split(torch, tmp: Path, data_dir: Path, seed: int) -> tuple[dict, dict]:
    """tools/probe_grad_split.py on the train data's first batch of 64 in
    this process (no DDP; the synced BatchNorm in a gloo group of one): its
    readings and the float64 gradients of the first training step."""
    from orcai_tpu_torch.tools.probe_grad_split import probe

    x, y = _dp_batches(torch, data_dir, "cuda")[0]
    # the cuDNN-off gradients (about 25 s) are the tool's own run's
    return probe(torch, x, y, seed, tmp / "probe_store", cudnn_off=False)


def _nccl_one_rank(torch, tmp: Path, data_dir: Path, seed: int) -> dict:
    """The plain Trainer and the distributed one (DDP, global BatchNorm,
    the loss's count all-reduced) in an NCCL group of one rank, PAR_STEPS
    steps each from the bundled weights over the train data's first
    batches: per-step losses and weights within RUNNER_RTOL, step ms."""
    import torch.distributed as dist

    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.train.trainer import Trainer

    batches = _dp_batches(torch, data_dir, "cuda")

    def run(distributed: bool):
        model, _, _ = load_orcai_model(device="cuda")
        trainer = Trainer(model, TRAIN_LR, device="cuda", distributed=distributed)
        st = trainer.state_from_variables(seed=seed)
        losses, ms = [], []
        for x, y in batches:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            m = trainer.train_step(st, x, y)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m[0]))
        return losses, ms, {k: v.detach().clone() for k, v in model.state_dict().items()}

    plain = run(False)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "nccl_store"), 1),
                            rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        ddp = run(True)
    finally:
        dist.destroy_process_group()
    params = [k for k in plain[2] if "running" not in k and "bias_hh" not in k]
    stats = [k for k in plain[2] if "running" in k]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ddp[0], plain[0]))
    w_rel, s_rel = _norm_rel(ddp[2], plain[2], params), _norm_rel(ddp[2], plain[2], stats)
    if backend != "nccl" or not max(loss_rel, w_rel, s_rel) <= RUNNER_RTOL:
        raise AssertionError(f"NCCL group of one ({backend}) against the plain Trainer: "
                             f"losses {loss_rel}, weights {w_rel}, statistics {s_rel} > "
                             f"{RUNNER_RTOL}")
    version = torch.cuda.nccl.version()
    return {"backend": backend,
            "nccl_version": ".".join(map(str, version)) if isinstance(version, tuple)
            else str(version),
            "steps": PAR_STEPS, "batch": 64, "losses_plain": plain[0], "losses_ddp": ddp[0],
            "loss_max_rel_diff": loss_rel, "weights_norm_rel_diff": w_rel,
            "weights_max_elem_rel_diff": _max_elem_rel(ddp[2], plain[2], params),
            "bn_stats_norm_rel_diff": s_rel,
            "step_ms_plain": plain[1], "step_ms_ddp": ddp[1],
            "step_ms_median_warm_plain": statistics.median(plain[1][2:]),
            "step_ms_median_warm_ddp": statistics.median(ddp[1][2:])}


def _two_gloo_ranks(torch, tmp: Path, data_dir: Path, seed: int) -> dict:
    """`train(load_model=True)` from the bundled weights over ["cuda:0",
    "cuda:0"] (two spawned processes in a gloo group, 32 + 32 of every batch
    of 64) against the same call on "cuda" in this process, one epoch each.
    From a trained model: near its initialisation half the probabilities sit
    by 0.5 and a validation MBA reads the card's float noise."""
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR, load_orcai_model
    from orcai_tpu_torch.train.trainer import train

    param = read_json(DEFAULT_MODEL_DIR / "orcai_parameter.json")
    param["seed"] = seed
    param["model"].update(epochs=1, learning_rate=TRAIN_LR)
    walls, dirs = {}, {}
    for name, device in (("one_process", "cuda"), ("two_ranks", ["cuda:0", "cuda:0"])):
        dirs[name] = tmp / f"dp_{name}" / param["name"]
        shutil.copytree(DEFAULT_MODEL_DIR, dirs[name], ignore=shutil.ignore_patterns(
            "test", "*.md", "training_history.json", "train_state.json"))
        t0 = time.perf_counter()
        train(data_dir, dirs[name].parent, orcai_parameter=param, device=device,
              load_model=True)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    hist = {k: read_json(d / "training_history.json") for k, d in dirs.items()}
    metric_rel = max(abs(hist["two_ranks"][k][0] - v[0]) / max(abs(v[0]), 1e-12)
                     for k, v in hist["one_process"].items())
    states = {k: load_orcai_model(d, device="cpu")[0].state_dict() for k, d in dirs.items()}
    one, two = states["one_process"], states["two_ranks"]
    params = [k for k in one if "running" not in k and "bias_hh" not in k]
    stats = [k for k in one if "running" in k]
    w_rel, s_rel = _norm_rel(two, one, params), _norm_rel(two, one, stats)
    if not max(metric_rel, w_rel, s_rel) <= RUNNER_RTOL:
        raise AssertionError(f"two gloo ranks against one process: metrics {metric_rel}, "
                             f"weights {w_rel}, statistics {s_rel} > {RUNNER_RTOL}: {hist}")
    start = load_orcai_model(device="cpu")[0].state_dict()
    return {"histories": hist, "metrics_max_rel_diff": metric_rel,
            "weights_norm_rel_diff": w_rel,
            "weights_max_elem_rel_diff": _max_elem_rel(two, one, params),
            "bn_stats_norm_rel_diff": s_rel,
            "weights_change_rel_diff": _change_rel(two, one, start, params),
            "bn_stats_change_rel_diff": _change_rel(two, one, start, stats),
            "train_wall_s": walls}


def _search_trial_mesh(torch, tmp: Path, data_dir: Path) -> dict:
    """`hyperparameter_search` without `parallel` over ["cuda:0", "cuda:0"]
    (each trial data-parallel over both, two spawned gloo processes, as
    mesh_for_batch gives the reference's trial its mesh) against the same
    search on "cuda": one bracket of one trial (max_epochs 1) at the
    default space's widths; the same trial and config, its losses within
    RUNNER_RTOL. From fresh weights the validation MBA reads the card's
    noise (half the probabilities sit by 0.5): reported, not held."""
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.resources import DEFAULT_HPS_PARAMETER, DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.train.hpsearch import hyperparameter_search

    param = {**read_json(DEFAULT_ORCAI_PARAMETER), "seed": HPS_SEED}
    records, walls = {}, {}
    for name, device in (("one_device", "cuda"), ("two_ranks", ["cuda:0", "cuda:0"])):
        out = tmp / f"hps_mesh_{name}"
        t0 = time.perf_counter()
        hyperparameter_search(data_dir, out, orcai_parameter=param,
                              hps_parameter=read_json(DEFAULT_HPS_PARAMETER), max_epochs=1,
                              factor=2, device=device)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        store = out / "hps_logs" / param["name"]
        records[name] = {p.stem: read_json(p) for p in sorted(store.glob("trial_*.json"))}
    one, two = records["one_device"], records["two_ranks"]
    if sorted(one) != sorted(two) or len(one) != 1:
        raise AssertionError(f"trials {sorted(one)} and {sorted(two)}")
    trial = next(iter(one))
    h1, h2 = one[trial].pop("history"), two[trial].pop("history")
    loss_rel = max(abs(h2[k][0] - h1[k][0]) / abs(h1[k][0]) for k in ("loss", "val_loss"))
    config = ("filters", "kernel_size", "dropout_rate", "batch_size", "lstm_units", "epochs")
    if any(one[trial][k] != two[trial][k] for k in config) or not loss_rel <= RUNNER_RTOL:
        raise AssertionError(f"a trial over two ranks against one device: {h2} against {h1}")
    return {"trial": trial, "config": {k: one[trial][k] for k in config},
            "loss_max_rel_diff": loss_rel, "histories": {"one_device": h1, "two_ranks": h2},
            "search_wall_s": walls}


def _window_split(torch, tmp: Path, state: dict, total: dict) -> dict:
    """The bundled model's predictor over ["cuda:0", "cuda:0"]: golden in
    memory and streamed, the 20-minute recording's TSV and aggregate against
    one replica's, the kernels' launches as on one device."""
    import numpy as np

    from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR
    from orcai_tpu_torch.io.wav import load_wav_for_frontend
    from orcai_tpu_torch.pipeline.predict import build_predictor, predict

    golden = (FIXTURES / "golden_expected.txt").read_bytes()
    split, _, _ = build_predictor(DEFAULT_MODEL_DIR, 128, ["cuda:0", "cuda:0"])
    if len(split.replicas) != 2 or split.dense_trunk:
        raise AssertionError("the predictor did not split over two replicas")
    line = {}
    reset_counts()
    predict(FIXTURES / "golden.wav", output_path=tmp / "split_golden.txt", overwrite=True,
            predictor=split)
    torch.cuda.synchronize()
    counts = read_counts(total)
    check_counts(counts, 1, "split golden")
    if (tmp / "split_golden.txt").read_bytes() != golden:
        raise AssertionError("golden through the window split differs")
    line["golden_launches"] = counts
    sp = state["param"]["spectrogram"]
    n_golden = load_wav_for_frontend(FIXTURES / "golden.wav", sr=sp["sampling_rate"])[0].shape[-1]
    b1, b2 = streaming_launches(n_golden, split, sp["n_overlap"])
    run = _streamed_predict(torch, FIXTURES / "golden.wav", tmp / "split_golden_s.txt", split,
                            total, "split golden streamed", b1, b2,
                            ORCAI_TPU_STREAM_SPEC_BYTES=1)
    if (tmp / "split_golden_s.txt").read_bytes() != golden:
        raise AssertionError("golden streamed through the window split differs")
    line["golden_streamed_launches"] = run["launches"]
    reset_counts()
    t0 = time.perf_counter()
    predict(state["wav"], output_path=tmp / "split_20min.txt", overwrite=True, predictor=split)
    torch.cuda.synchronize()
    line["min20_predict_wall_s"] = time.perf_counter() - t0
    counts = read_counts(total)
    check_counts(counts, 7, "split 20 min")
    line["min20_launches"] = counts
    if (tmp / "split_20min.txt").read_bytes() != state["tsv"].read_bytes():
        raise AssertionError("the 20-minute TSV through the window split differs")
    walls = {}
    for name, pred in (("one_replica", state["predictor"]), ("two_replicas", split),
                       ("two_replicas_again", split), ("one_replica_again", state["predictor"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg, count, n_out = pred.aggregate_device(state["spec"], n_frames=state["n_frames"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if name == "two_replicas":
            aggregated, overlap = pred.fetch_aggregated(agg, count, n_out)
    diff = float(np.abs(aggregated - state["aggregated"]).max())
    if not np.array_equal(overlap, state["overlap"]) or not diff <= PAR_SPLIT_ATOL:
        raise AssertionError(f"20-minute aggregate through the split: {diff} > {PAR_SPLIT_ATOL}")
    line.update(min20_aggregate_max_abs_diff=diff, min20_crnn_walls_s=walls,
                split_atol=PAR_SPLIT_ATOL)
    return line


def _two_process_fan_out(torch, tmp: Path, state: dict, data_dir: Path, total: dict) -> dict:
    """create-spectrograms over the data_prep project, predict over a
    three-row table and a search on `data_dir`, each in two processes joined
    by a launcher's environment, against one process."""
    import gzip
    import socket

    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.pipeline.predict import DEFAULT_CALL_DURATION_LIMITS, predict
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.train.hpsearch import hyperband_schedule

    project = tmp / "data_prep"
    recs = tmp / "par_recordings"
    recs.mkdir()
    shutil.copy(FIXTURES / "golden.wav", recs / "golden.wav")
    os.link(state["wav"], recs / "synthetic_20min.wav")
    table = tmp / "par_table.csv"
    table.write_text(
        "recording,channel,base_dir_recording,rel_recording_path\n"
        f"golden,1,{recs},golden.wav\n"
        f"synthetic_20min,1,{recs},synthetic_20min.wav\n"
        f"missing,1,{recs},missing.wav\n"
    )
    reset_counts()
    one_pred = predict(table, output_path=tmp / "par_pred_one", save_probabilities=True,
                       call_duration_limits=DEFAULT_CALL_DURATION_LIMITS,
                       predictor=state["predictor"])
    torch.cuda.synchronize()
    check_counts(read_counts(total), 1 + 7, "the one-process table", b2=6, pick=6)
    hps_param = {**read_json(DEFAULT_ORCAI_PARAMETER), "seed": HPS_SEED}
    args = {"spec_table": str(project / "recording_table.csv"),
            "spec_param": str(project / "param.json"), "spec_out": str(tmp / "par_spec"),
            "pred_table": str(table), "pred_out": str(tmp / "par_pred"),
            "tvt": str(data_dir), "hps_out": str(tmp / "par_hps"), "hps_param": hps_param,
            "max_epochs": PAR_HPS_MAX_EPOCHS, "factor": PAR_HPS_FACTOR}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", PAR_CHILD, json.dumps(args)], cwd=ROOT,
        env={**os.environ, "WORLD_SIZE": "2", "RANK": str(rank), "MASTER_ADDR": "localhost",
             "MASTER_PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    lines, logs = [], []
    for rank, proc in enumerate(procs):
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"fan-out process {rank} exited {proc.returncode}:\n"
                                 f"{err[-4000:]}")
        lines.append(json.loads(out.split("PAR-CHILD ", 1)[1]))
        logs.append(out)  # the console report
    wall = time.perf_counter() - t0

    # create-spectrograms: disjoint shares, the stores byte-equal to data_prep's
    spec_out, spec_one = tmp / "par_spec", project / "data"
    made = sorted(p.name for p in spec_out.iterdir())
    if sum(line["spectrograms"] for line in lines) != len(made) or made != sorted(
            p.parent.name for p in spec_one.glob("*/spectrogram")):
        raise AssertionError(f"fanned-out spectrograms {made}, shares "
                             f"{[line['spectrograms'] for line in lines]}")
    for rec in made:
        for path in sorted((spec_out / rec / "spectrogram").rglob("*")):
            twin = spec_one / rec / "spectrogram" / path.relative_to(spec_out / rec / "spectrogram")
            if path.is_file() and path.read_bytes() != twin.read_bytes():
                raise AssertionError(f"fanned-out store {path} differs from one process's")
    # predict: rows 0 and 2 in process 0, row 1 in process 1; byte-equal TSVs
    shares = [line["predicted"] for line in lines]
    if shares != [["golden_orcai-v1_predicted.txt"], ["synthetic_20min_orcai-v1_predicted.txt"]]:
        raise AssertionError(f"predict shares {shares}")
    probabilities_equal = True
    for p in one_pred:
        twin = tmp / "par_pred" / p.name
        if twin.read_bytes() != p.read_bytes():
            raise AssertionError(f"fanned-out {p.name} differs from one process's")
        for q in p.parent.glob(p.name.replace("_predicted.txt", "*.csv.gz")):
            probabilities_equal &= (gzip.decompress(q.read_bytes()) == gzip.decompress(
                (tmp / "par_pred" / q.name).read_bytes()))
    # the search: every trial once, process 1 published nothing, rerun CACHED
    store = tmp / "par_hps" / "hps_logs" / hps_param["name"]
    n_trials = sum(n for rungs in hyperband_schedule(PAR_HPS_MAX_EPOCHS, PAR_HPS_FACTOR)
                   for n, _ in rungs)
    first = [r[-1] for r in (t.split(",") for t in
                             lines[0]["search_all_trials_csv"].splitlines()[1:])]
    rerun = [r[-1] for r in (t.split(",") for t in
                             lines[0]["rerun_all_trials_csv"].splitlines()[1:])]
    if (len(list(store.glob("trial_*.json"))) != n_trials or len(first) != n_trials
            or not {"COMPLETED", "CACHED"} <= set(first) or rerun != ["CACHED"] * n_trials):
        raise AssertionError(f"two-process search: {len(list(store.glob('trial_*.json')))} "
                             f"records, first {first}, rerun {rerun}")
    if "worker process" not in logs[1] or "Saved best model" in logs[1]:
        raise AssertionError("process 1 published search outputs")
    if _without_status(lines[0]["search_all_trials_csv"]) != _without_status(
            lines[0]["rerun_all_trials_csv"]):
        raise AssertionError("all_trials.csv differs on the rerun")
    return {"wall_s": wall, "processes": [{k: v for k, v in line.items()
                                           if not k.endswith("_csv")} for line in lines],
            "spectrograms_byte_equal": made, "predict_tsvs_byte_equal": True,
            "probabilities_equal": probabilities_equal,
            "search": {"max_epochs": PAR_HPS_MAX_EPOCHS, "factor": PAR_HPS_FACTOR,
                       "rung_trials": n_trials, "first_statuses": first,
                       "rerun_all_cached": True,
                       "best": read_json(tmp / "par_hps" / "hps_logs" /
                                         "best_hyperparameters.json")}}


def phase_parallel(torch, tmp: Path, seed: int, state: dict, data_dir: Path,
                   total: dict) -> dict:
    """parallel/ on one card: an NCCL group of one rank against the plain
    Trainer, two gloo ranks sharing the card against one process (an epoch
    of `train`, and 8 steps beside a plain DDP wrap as the control), the
    window split over the card named twice, and the two-process fan-out of
    the table commands and of a search."""
    line = {"phase": "parallel"}
    walls = {}
    plain = {}

    def grad_split():
        part, plain["float64"] = _grad_split(torch, tmp, data_dir, seed)
        return part

    def against_control():
        part, plain["start"] = _two_ranks_against_control(
            torch, tmp, data_dir, seed, plain["float64"])
        return part

    for name, part in (
            ("nccl_one_rank", lambda: _nccl_one_rank(torch, tmp, data_dir, seed)),
            ("two_gloo_ranks", lambda: _two_gloo_ranks(torch, tmp, data_dir, seed)),
            ("grad_split", grad_split),
            ("two_ranks_against_control", against_control),
            ("tensor_parallel", lambda: _tensor_parallel(torch, tmp, data_dir, seed,
                                                         plain["start"])),
            ("search_trial_mesh", lambda: _search_trial_mesh(torch, tmp, data_dir)),
            ("window_split", lambda: _window_split(torch, tmp, state, total)),
            ("fan_out", lambda: _two_process_fan_out(torch, tmp, state, data_dir, total))):
        t0 = time.perf_counter()
        line[name] = part()
        walls[name] = time.perf_counter() - t0
    line["walls_s"] = walls
    line["note"] = ("one card: the ranks and replicas share it, so no time here is a "
                    "multi-GPU speed-up")
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from orcai_tpu_torch.utils.device import exact_f32_math

    phase, t0 = "env", time.perf_counter()
    try:
        env = phase_env(torch)
        emit_phase(env, t0)
        phase, t0 = "build", time.perf_counter()
        emit_phase(phase_build(), t0)
        # the f32 CRNN checks and stage timings below call the model directly;
        # the port's console reports go to standard error, the results to
        # standard output
        with exact_f32_math(), tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(sys.stderr):
            phase, t0 = "kernels", time.perf_counter()
            line, rows, sel = phase_kernels(torch, args.seed)
            emit_phase(line, t0)
            total: dict = {}
            phase, t0 = "golden", time.perf_counter()
            emit_phase(phase_golden(torch, Path(tmp), total), t0)
            phase, t0 = "full", time.perf_counter()
            line, real, state = phase_full(torch, Path(tmp), args.seed, total)
            emit_phase(line, t0)
            phase, t0 = "streaming", time.perf_counter()
            emit_phase(phase_streaming(torch, Path(tmp), args.seed, state, total), t0)
            phase, t0 = "table_serve", time.perf_counter()
            emit_phase(phase_table_serve(torch, Path(tmp), state, total), t0)
            phase, t0 = "train", time.perf_counter()
            line, trained = phase_train(torch, Path(tmp), args.seed, state, total)
            emit_phase(line, t0)
            phase, t0 = "test_model", time.perf_counter()
            emit_phase(phase_test_model(torch, Path(tmp), state, trained), t0)
            phase, t0 = "data_prep", time.perf_counter()
            emit_phase(phase_data_prep(torch, Path(tmp), args.seed, total), t0)
            phase, t0 = "wires", time.perf_counter()
            line, mixed_row, cluster_row, chirp_row, staged_row, point_row = phase_wires(
                torch, Path(tmp), args.seed, state, total)
            rows["dft_magnitude_fft"]["cases"] = line["b1"].pop("fft_route_uint8")
            rows = {"dft_magnitude_fft": rows["dft_magnitude_fft"],
                    "dft_magnitude_mixed": mixed_row, "dft_magnitude_cluster": cluster_row,
                    "dft_magnitude_chirp": chirp_row, "dft_magnitude_staged": staged_row,
                    "dft_magnitude_point": point_row,
                    **{k: v for k, v in rows.items() if k != "dft_magnitude_fft"}}
            emit_phase(line, t0)
            phase, t0 = "hpsearch", time.perf_counter()
            searched = phase_hpsearch(torch, Path(tmp), trained, total)
            emit_phase(searched, t0)
            phase, t0 = "first_epoch", time.perf_counter()
            emit_phase(phase_first_epoch(torch, state, trained, searched), t0)
            phase, t0 = "bf16", time.perf_counter()
            emit_phase(phase_bf16(torch, Path(tmp), state, total), t0)
            phase, t0 = "bf16_train", time.perf_counter()
            emit_phase(phase_bf16_train(torch, Path(tmp), trained), t0)
            phase, t0 = "architectures", time.perf_counter()
            emit_phase(phase_architectures(torch, Path(tmp), trained, total), t0)
            phase, t0 = "warmup_serve", time.perf_counter()
            emit_phase(phase_warmup_serve(torch, Path(tmp)), t0)
            phase, t0 = "reference_formats", time.perf_counter()
            emit_phase(phase_reference_formats(torch, Path(tmp), args.seed, state, total), t0)
            phase, t0 = "parallel", time.perf_counter()
            emit_phase(phase_parallel(torch, Path(tmp), args.seed, state, trained["data_dir"],
                                      total), t0)
    except Exception as e:  # report the phase, then fail the run
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    # every kernel's launches, summed over the paths driven above (golden,
    # 20-minute, streaming, table, service, the trained models' and the
    # searched model's predicts, bf16 predict, create-spectrograms, golden
    # from the reference-format dirs, the window split's predicts and the
    # fan-out's one-process table; the fan-out's own processes count their
    # own); each
    # path asserted its own. Training, the search and evaluation read stored
    # spectrograms and launch none of these kernels; the warmup and serve
    # processes count their own.
    for name, row in rows.items():
        row["launches"] = total[name]
    unlaunched = [name for name, row in rows.items() if not row["launches"] > 0]
    if unlaunched:
        emit({"phase": "launches", "ok": False,
              "error": f"kernels no path launched: {unlaunched}"})
        return 1
    rows["digit_histograms"]["ms_real"] = real["b2_ms_real"]
    # not a kernel of its own: the sweeps and picks above, whose main-path
    # launches it made
    # (picks run only inside a selection, each beside one of its sweeps; the
    # streaming path's sweeps are B2's own and its pick is on the host)
    sel["b2_launches"] = sel["pick_launches"] = total["radix_pick"]
    sel["ms_real"] = real["selection_ms_real"]
    emit({"selection": sel})
    emit({"kernels": list(rows.values())})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
