"""Where the time of one training epoch goes, on a CUDA device.

    python -m orcai_tpu_torch.tools.profile_train [--seed 0] [--trace_dir DIR]

Takes the training cell of chip_smoke.py: 512 train / 128 val snippets of
736 x 171 x 1 cut from the spectrogram of a 20-minute recording synthesized
from --seed (tools/synthetic.py), the bundled model's architecture at full
width (ResNetLSTM, filters 30/40/50/60, 2x BiLSTM-128, 7 labels) from fresh
weights, float32 without TF32, batch 64, dropout 0.5.

After one warm epoch it prints one JSON line each for:

  epoch_resident    the host wall of an unprofiled epoch (8 steps) with the
                    data resident on the device, and of its evaluation pass
  stages            per stage of a step (batch gather, forward, loss,
                    backward, optimizer, metrics), the device time between
                    CUDA events summed over the epoch, and the single fetch
                    of the epoch's metrics at the end
  profile           the same epoch under torch.profiler: summed device
                    kernel time, device idle share (1 - kernel time / wall)
                    and the top device items by name
  epoch_streaming   an epoch whose batches are uploaded one by one
  peak              peak device memory over all of it

With --trace_dir it also writes the profiled epoch's Chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

MINUTES = 20.0
N_TRAIN, N_VAL = 512, 128
LEARNING_RATE = 1e-3
STAGES = ("batch_gather", "forward", "loss", "backward", "optimizer", "metrics")
# device items grouped by what their names contain, first match wins
FAMILIES = (
    ("fft_convolution", ("fft2d", "fft1d", "cf32cf32")),
    ("layout_change", ("nchwToNhwc", "nhwcToNchw")),
    ("batchnorm", ("batchnorm", "bn_fw", "bn_bw")),
    ("convolution", ("wgrad", "dgrad", "fprop", "implicit_gemm", "conv")),
    ("lstm", ("RNN", "rnn", "LSTM", "lstm")),
    ("max_pool", ("max_pool",)),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
    ("copies", ("Memcpy", "memcpy", "Memset", "memset")),
    ("gemm", ("gemm", "gemv")),
    ("elementwise_and_reduce", ("elementwise", "reduce", "index", "cat", "fill")),
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def staged_epoch(torch, trainer, state, data, perm) -> dict:
    """One epoch with CUDA events between the stages of every step; the
    step is Trainer.train_step taken apart. Returns device ms per stage,
    the metric fetch's host ms and the epoch's host wall."""
    marks = []

    def mark():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    acc = torch.zeros(3, dtype=torch.float64, device=trainer.device)
    rows = torch.from_numpy(perm.astype("int64")).to(trainer.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in rows:
        events = [mark()]
        x, y = data.x.index_select(0, idx), data.y.index_select(0, idx)
        events.append(mark())
        state.optimizer.zero_grad(set_to_none=True)
        logits = trainer.model(x, train=True, return_logits=True)
        events.append(mark())
        loss = trainer._loss(logits, y)
        events.append(mark())
        loss.backward()
        events.append(mark())
        state.optimizer.step()
        events.append(mark())
        acc += trainer._metrics(loss, logits, y)[0].double()
        events.append(mark())
        marks.append(events)
    t1 = time.perf_counter()
    fetched = acc.tolist()
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    totals = dict.fromkeys(STAGES, 0.0)
    for events in marks:
        for name, a, b in zip(STAGES, events, events[1:]):
            totals[name] += a.elapsed_time(b)
    return {"device_ms": totals, "steps": len(marks),
            "host_dispatch_ms": (t1 - t0) * 1e3, "metric_fetch_wait_ms": (t2 - t1) * 1e3,
            "epoch_wall_ms": (t2 - t0) * 1e3, "loss_mean": fetched[0] / max(len(marks), 1)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace_dir", default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_train: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from orcai_tpu_torch.io.dataset import ArrayDataset, epoch_permutation
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.io.wav import load_wav_for_frontend
    from orcai_tpu_torch.models import build_model
    from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.tools.synthetic import synth_sweep_wav, synth_tvt
    from orcai_tpu_torch.train.trainer import (
        DeviceData, Trainer, device_runners, streaming_runners,
    )
    from orcai_tpu_torch.utils.device import exact_f32_math

    param = read_json(DEFAULT_ORCAI_PARAMETER)
    batch = param["model"]["batch_size"]
    seeds = ([7, args.seed], [8, args.seed])
    with exact_f32_math(), tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "synthetic.wav"
        synth_sweep_wav(wav, args.seed, MINUTES)
        audio, _ = load_wav_for_frontend(wav, sr=param["spectrogram"]["sampling_rate"])
        spec, n_frames, _, _ = make_spectrogram_from_params_device(audio, param["spectrogram"])
        synth_tvt(Path(tmp) / "tvt", spec[:n_frames].cpu().numpy(), args.seed, N_TRAIN, N_VAL, 8)
        del spec
        train_ds = ArrayDataset.load(Path(tmp) / "tvt" / "train_dataset")
        val_ds = ArrayDataset.load(Path(tmp) / "tvt" / "val_dataset")

        trainer = Trainer(build_model(param, (736, 171, 1)), LEARNING_RATE, device="cuda")
        state = trainer.init_state(seed=args.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_data, val_data = DeviceData(train_ds), DeviceData(val_ds)
        torch.cuda.synchronize()
        emit({"stage": "upload", "wall_s": time.perf_counter() - t0,
              "bytes": train_ds.x.nbytes + val_ds.x.nbytes,
              "device": torch.cuda.get_device_name(0)})
        run_train, run_val = device_runners(trainer, train_data, val_data, batch, *seeds)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_train(state, 0)  # warm: cuDNN picks its algorithms here
        torch.cuda.synchronize()
        emit({"stage": "first_epoch", "wall_s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        _, metrics = run_train(state, 1)
        t1 = time.perf_counter()
        val_metrics = run_val(state, 1)
        t2 = time.perf_counter()
        emit({"stage": "epoch_resident", "train_wall_s": t1 - t0, "eval_wall_s": t2 - t1,
              "steps": train_data.n_batches(batch), "eval_steps": val_data.n_batches(batch),
              "step_wall_ms": (t1 - t0) * 1e3 / train_data.n_batches(batch),
              **metrics, **val_metrics})

        perm = epoch_permutation(train_data.n, batch, seeds[0], 2)
        emit({"stage": "stages", **staged_epoch(torch, trainer, state, train_data, perm)})

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_train(state, 3)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy_s = sum(r[1] for r in rows) * 1e-6
        families = dict.fromkeys([name for name, _ in FAMILIES] + ["other"], 0.0)
        for key, us, _ in rows:
            family = next((n for n, words in FAMILIES if any(w in key for w in words)), "other")
            families[family] += us * 1e-3
        if args.trace_dir:
            Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(args.trace_dir) / "profile_train_epoch.json"))
        emit({"stage": "profile", "wall_s": wall, "device_kernel_s": busy_s,
              "device_idle_share": max(0.0, 1.0 - busy_s / wall),
              "device_launches": sum(c for _, _, c in rows), "family_ms": families,
              "top_kernels": [{"kernel": k[:90], "ms": us * 1e-3, "calls": c}
                              for k, us, c in rows[:20]]})

        stream_train, _ = streaming_runners(
            trainer, lambda e: train_ds.batches(batch, seed=seeds[0], epoch=e),
            lambda e: val_ds.batches(batch, seed=seeds[1], epoch=e))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream_train(state, 4)
        torch.cuda.synchronize()
        emit({"stage": "epoch_streaming", "train_wall_s": time.perf_counter() - t0,
              "uploaded_bytes": train_data.n_batches(batch) * batch * 736 * 171 * 4})
        emit({"stage": "peak", "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "resident_dataset_bytes": train_ds.x.nbytes + val_ds.x.nbytes})
    return 0


if __name__ == "__main__":
    sys.exit(main())
