"""Where the time of `create-spectrograms` goes, on a CUDA device.

    python -m orcai_tpu_torch.tools.profile_data_prep [--seed 0]
        [--recordings 2] [--minutes 20] [--trace_dir DIR]

Writes a synthetic project of annotated 48 kHz recordings from --seed
(tools/synthetic.py::make_synthetic_project) and runs the default parameter
file's frontend once to build and warm the kernels. Then:

- `create_spectrograms` on the card, unprofiled: its report (stage walls,
  codec, bytes written) as one JSON line;
- the same under torch.profiler into a fresh directory: the wall, the
  device time of the kernels and of the host-to-device and device-to-host
  copies, per recording, and the device's busy share of the wall;
- the store writer on one stored spectrogram, taken apart: chunk slicing
  and padding, byte shuffle, the C LZ4 calls (the bare C call separately
  from its ctypes wrapper), blosc frame assembly and the file writes, each
  summed over the store, against `save_as_zarr`'s own wall; the gzip codec
  on the same array for comparison;
- the GIL check: two blosc-lz4 store writes one after the other, then in
  two threads at once. Threads that hold the GIL take as long as the
  sequence; threads that run in C take about half.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np


def _emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def _device_items(torch, prof) -> dict:
    """Device time by kind (ms) and the top items of a profile."""
    kinds = {"memcpy_htod": 0.0, "memcpy_dtoh": 0.0, "memset": 0.0, "kernels": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total * 1e-3
        key = e.key.lower()
        if "memcpy" in key and "htod" in key:
            kinds["memcpy_htod"] += ms
        elif "memcpy" in key and "dtoh" in key:
            kinds["memcpy_dtoh"] += ms
        elif "memset" in key:
            kinds["memset"] += ms
        else:
            kinds["kernels"] += ms
        top.append({"item": e.key[:90], "ms": ms, "calls": e.count})
    top.sort(key=lambda r: -r["ms"])
    return {"device_ms": kinds, "top_items": top[:10]}


def writer_split(arr: np.ndarray, out: Path) -> dict:
    """save_as_zarr(arr, compress="blosc-lz4") taken apart into its steps,
    each timed over the whole store, beside the call's own wall."""
    from orcai_tpu_torch import native
    from orcai_tpu_torch.io import blosc
    from orcai_tpu_torch.io.zarrlite import save_as_zarr

    lib = native._load()
    if lib is None:
        raise RuntimeError("the C LZ4 encoder did not build on this host")
    t0 = time.perf_counter()
    save_as_zarr(arr, out / "whole.zarr", compress="blosc-lz4")
    whole_s = time.perf_counter() - t0

    steps = {"chunk_slice_pad_s": 0.0, "shuffle_s": 0.0, "lz4_wrapper_s": 0.0,
             "lz4_bare_c_s": 0.0, "frame_s": 0.0, "file_write_s": 0.0}
    rows = min(2000, arr.shape[0])
    chunk_dir = out / "parts" / "c"
    chunk_dir.mkdir(parents=True)
    raw_bytes = comp_bytes = 0
    for i in range(math.ceil(arr.shape[0] / rows)):
        t0 = time.perf_counter()
        block = arr[i * rows:(i + 1) * rows]
        if block.shape[0] != rows:
            full = np.zeros((rows, *arr.shape[1:]), arr.dtype)
            full[:block.shape[0]] = block
            block = full
        raw = np.ascontiguousarray(block, "<f4").tobytes()
        steps["chunk_slice_pad_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        frame = blosc.blosc_compress(raw, typesize=4, cname="lz4")
        frame_total = time.perf_counter() - t0
        # the same blocks again, step by step, for the split inside the frame
        blocksize = min(1 << 17, len(raw)) // 4 * 4
        inner = 0.0
        for b in range(0, len(raw), blocksize):
            t0 = time.perf_counter()
            shuffled = blosc._shuffle(raw[b:b + blocksize], 4)
            dt = time.perf_counter() - t0
            steps["shuffle_s"] += dt
            inner += dt
            n_sub = 4 if len(shuffled) == blocksize else 1
            sub_len = len(shuffled) // n_sub
            for s in range(n_sub):
                sub = shuffled[s * sub_len:(s + 1) * sub_len]
                t0 = time.perf_counter()
                native.lz4_compress_native(sub)
                dt = time.perf_counter() - t0
                steps["lz4_wrapper_s"] += dt
                inner += dt
                cap = len(sub) + len(sub) // 255 + 16
                dst = ctypes.create_string_buffer(cap)
                t0 = time.perf_counter()
                lib.orcai_lz4_compress(sub, len(sub), dst, cap)
                steps["lz4_bare_c_s"] += time.perf_counter() - t0
        steps["frame_s"] += max(0.0, frame_total - inner)

        t0 = time.perf_counter()
        (chunk_dir / str(i)).mkdir(exist_ok=True)
        (chunk_dir / str(i) / "0").write_bytes(frame)
        steps["file_write_s"] += time.perf_counter() - t0
        raw_bytes += len(raw)
        comp_bytes += len(frame)
    t0 = time.perf_counter()
    save_as_zarr(arr, out / "gzip.zarr", compress="gzip")
    gzip_s = time.perf_counter() - t0
    parts = (steps["chunk_slice_pad_s"] + steps["shuffle_s"] + steps["lz4_wrapper_s"]
             + steps["frame_s"] + steps["file_write_s"])
    return {"store_bytes_raw": raw_bytes, "store_bytes_written": comp_bytes,
            "save_as_zarr_blosc_lz4_s": whole_s, "steps": steps, "steps_sum_s": parts,
            "lz4_bare_c_MB_per_s": raw_bytes / 1e6 / steps["lz4_bare_c_s"],
            "save_as_zarr_gzip_s": gzip_s}


def gil_check(arrays: list[np.ndarray], out: Path) -> dict:
    """Two blosc-lz4 store writes one after the other, then in two threads."""
    from orcai_tpu_torch.io.zarrlite import save_as_zarr

    t0 = time.perf_counter()
    for i, a in enumerate(arrays):
        save_as_zarr(a, out / f"seq{i}.zarr", compress="blosc-lz4")
    sequential = time.perf_counter() - t0
    threads = [threading.Thread(target=save_as_zarr, args=(a, out / f"par{i}.zarr"),
                                kwargs={"compress": "blosc-lz4"})
               for i, a in enumerate(arrays)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    concurrent = time.perf_counter() - t0
    return {"stores": len(arrays), "sequential_s": sequential, "two_threads_s": concurrent,
            "ratio": concurrent / sequential}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--recordings", type=int, default=2)
    parser.add_argument("--minutes", type=float, default=20.0)
    parser.add_argument("--trace_dir", default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_data_prep: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.io.zarrlite import open_zarr
    from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device
    from orcai_tpu_torch.pipeline.spectrogram import create_spectrograms, load_recording_audio
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.tools.synthetic import make_synthetic_project

    param = read_json(DEFAULT_ORCAI_PARAMETER)
    sp = param["spectrogram"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        table = make_synthetic_project(root / "project", args.recordings, args.minutes * 60,
                                       seed=args.seed)
        first = sorted((root / "project" / "recordings").glob("*.wav"))[0]
        make_spectrogram_from_params_device(
            load_recording_audio(first, sp["sampling_rate"]), sp, device="cuda")
        torch.cuda.synchronize()
        _emit({"stage": "setup", "wall_s": time.perf_counter() - t0,
               "device": torch.cuda.get_device_name(0)})

        t0 = time.perf_counter()
        report = create_spectrograms(table, root / "data", orcai_parameter=param, device="cuda")
        torch.cuda.synchronize()
        _emit({"stage": "create_spectrograms_unprofiled",
               "wall_s": time.perf_counter() - t0, "report": report})

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            create_spectrograms(table, root / "data_profiled", orcai_parameter=param,
                                device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if args.trace_dir:
            Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(args.trace_dir) / "create_spectrograms.json"))
        items = _device_items(torch, prof)
        busy = sum(items["device_ms"].values())
        _emit({"stage": "create_spectrograms_profiled", "wall_s": wall,
               "recordings": args.recordings, "device_busy_ms": busy,
               "device_busy_ms_per_recording": busy / args.recordings,
               "device_busy_share": busy * 1e-3 / wall, **items})
        shutil.rmtree(root / "data_profiled")

        stores = sorted((root / "data").glob("*/spectrogram/spectrogram.zarr"))
        arrays = [open_zarr(p)[:] for p in stores[:2]]
        split = root / "split"
        split.mkdir()
        _emit({"stage": "store_writer_split", "shape": list(arrays[0].shape),
               **writer_split(arrays[0], split)})
        shutil.rmtree(split)
        if len(arrays) == 2:
            gil = root / "gil"
            gil.mkdir()
            _emit({"stage": "store_writer_gil_check", **gil_check(arrays, gil)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
