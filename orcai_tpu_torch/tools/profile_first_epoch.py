"""Where a process's first training epoch goes, on a CUDA device.

    python -m orcai_tpu_torch.tools.profile_first_epoch DATA_DIR
        [--predict_wav WAV] [--profile] [--first_calls] [--seed 7]

Runs what one trial of `hpsearch`, or the start of `train`, runs, in a
process that has trained nothing yet: the bundled model's architecture at
full width (the default parameter file: ResNetLSTM, filters 30/40/50/60,
2x BiLSTM-128, 736 x 171 x 1, 7 labels, batch 64, float32 without TF32)
built, moved and initialised; the train and val datasets of DATA_DIR (a
directory such as tools/synthetic.py's synth_tvt writes) uploaded; then two
resident epochs. Each epoch's first step is taken apart (forward, loss,
backward, optimizer: host walls with the device drained around each), its
other steps and its evaluation are timed, and the caching allocator's
counters are read after it. With --predict_wav the process first predicts
that recording with the bundled model, as a service does before it trains.
With --profile each epoch runs under torch.profiler and its top host items
are printed (cuDNN calls, module loading, launches). With --first_calls the
operations of the weight initialiser are each called once, and timed,
before the trial. Prints one JSON line.

The same stages serve a trial inside a warm process (`trial_stages`), which
is how chip_smoke.py compares a new shape with one already run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import torch

LEARNING_RATE = 1e-3


def timed(fn):
    """(fn(), host seconds) with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def alloc_stats() -> dict:
    """The caching allocator's counters: bytes reserved, segments it
    allocated and freed (cudaMalloc / cudaFree), retries after a failed
    allocation."""
    stats = torch.cuda.memory_stats()
    return {"reserved_bytes": torch.cuda.memory_reserved(),
            "segments_allocated": stats.get("segment.all.allocated", 0),
            "segments_freed": stats.get("segment.all.freed", 0),
            "alloc_retries": stats.get("num_alloc_retries", 0)}


def step_stages(trainer, state, x, y) -> dict:
    """One train step taken apart as Trainer.train_step runs it: each
    stage's host wall with the device drained before and after it."""
    walls = {}

    def stage(name, fn):
        out, walls[name] = timed(fn)
        return out

    state.optimizer.zero_grad(set_to_none=True)
    logits = stage("forward", lambda: trainer.model(x, train=True, return_logits=True))
    loss = stage("loss", lambda: trainer._loss(logits, y))
    stage("backward", loss.backward)
    stage("optimizer", state.optimizer.step)
    return walls


def top_host_items(prof, n: int = 12) -> tuple[list[dict], float]:
    """The profiled block's top items by host time, and its device kernel ms."""
    averages = prof.key_averages()
    rows = sorted(averages, key=lambda e: -e.self_cpu_time_total)
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return [{"item": e.key[:80], "self_host_ms": e.self_cpu_time_total * 1e-3,
             "calls": e.count} for e in rows[:n]], busy_us * 1e-3


def trial_stages(param: dict, data, seeds, seed: int, profile: bool = False) -> dict:
    """A trial's stages on the card: build, move, init, then two resident
    epochs over `data` ((train, val) DeviceData), each with its first step
    taken apart; with `profile`, each epoch's train pass under
    torch.profiler."""
    from orcai_tpu_torch.io.dataset import epoch_permutation
    from orcai_tpu_torch.models import build_model
    from orcai_tpu_torch.train.trainer import Trainer

    batch = param["model"]["batch_size"]
    rec = {"alloc_before": alloc_stats()}
    model, rec["build_s"] = timed(lambda: build_model(param, (736, 171, 1)))
    trainer, rec["to_device_s"] = timed(
        lambda: Trainer(model, param["model"]["learning_rate"], device="cuda"))
    state, rec["init_s"] = timed(lambda: trainer.init_state(seed=seed))
    train_data, val_data = data
    for epoch in (0, 1):
        perm = epoch_permutation(train_data.n, batch, seeds[0], epoch)
        batches = iter(train_data.batches(perm))
        x, y = next(batches)
        ep = {}
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            ctx = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        else:
            ctx = contextlib.nullcontext()
        with ctx as prof:
            ep["first_step_stages_s"] = step_stages(trainer, state, x, y)
            _, ep["other_steps_s"] = timed(
                lambda: [trainer.train_step(state, xb, yb) for xb, yb in batches])
        vperm = epoch_permutation(val_data.n, batch, seeds[1], epoch)
        _, ep["eval_s"] = timed(
            lambda: [trainer.eval_step(xb, yb) for xb, yb in val_data.batches(vperm)])
        if profile:
            ep["top_host_items"], ep["device_kernel_ms"] = top_host_items(prof)
        ep["alloc_after"] = alloc_stats()
        ep["wall_s"] = (sum(ep["first_step_stages_s"].values()) + ep["other_steps_s"]
                        + ep["eval_s"])
        rec[f"epoch_{epoch + 1}"] = ep
    rec["first_epoch_extra_s"] = rec["epoch_1"]["wall_s"] - rec["epoch_2"]["wall_s"]
    return rec


def first_calls() -> dict:
    """Host seconds of the first call in this process of each operation
    Trainer.init_state makes: models/crnn.py::init_variables' float64 draws
    on the CPU, erfinv, a QR decomposition and copies to the card, then
    the dropout generator on the card and torch.optim.Adam's construction
    (whose first call imports torch._dynamo)."""
    g = torch.Generator().manual_seed(0)
    calls = {
        "rand_float64": lambda: torch.rand((4096,), generator=g, dtype=torch.float64),
        "erfinv_float64": lambda: torch.erfinv(torch.rand(4096, dtype=torch.float64)),
        "randn_float64": lambda: torch.randn((512, 128), generator=g, dtype=torch.float64),
        "linalg_qr_float64": lambda: torch.linalg.qr(torch.randn((512, 128),
                                                                 dtype=torch.float64)),
        "copy_to_card": lambda: torch.ones(4096).to("cuda"),
        "generator_on_card": lambda: torch.Generator(device="cuda").manual_seed(1),
        "adam_construction": lambda: torch.optim.Adam(
            [torch.nn.Parameter(torch.zeros(4, device="cuda"))], lr=1e-3),
    }
    return {name: timed(fn)[1] for name, fn in calls.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("data_dir", help="directory with train_dataset and val_dataset")
    parser.add_argument("--predict_wav", default=None,
                        help="predict this recording with the bundled model first")
    parser.add_argument("--profile", action="store_true",
                        help="run each epoch under torch.profiler")
    parser.add_argument("--first_calls", action="store_true",
                        help="time the first call of each operation the weight "
                             "initialiser makes before the trial")
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_first_epoch: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from orcai_tpu_torch.io.dataset import ArrayDataset
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.train.trainer import DeviceData
    from orcai_tpu_torch.utils.device import exact_f32_math
    from orcai_tpu_torch.utils.seeds import SEED_ID_LOAD_TRAIN_DATA, SEED_ID_LOAD_VAL_DATA

    line = {"device": torch.cuda.get_device_name(0),
            "cudnn_version": torch.backends.cudnn.version(),
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cuda_module_loading": os.environ.get("CUDA_MODULE_LOADING", "(unset)"),
            "profile": args.profile}
    _, line["cuda_init_s"] = timed(lambda: torch.zeros(1, device="cuda"))
    line["dynamo_imported_at_start"] = "torch._dynamo" in sys.modules
    if args.first_calls:
        line["first_calls_s"] = first_calls()
    with exact_f32_math():
        if args.predict_wav:
            from orcai_tpu_torch.pipeline.predict import predict

            out = Path(args.data_dir).parent / "profile_first_epoch_pred.txt"
            _, line["predict_s"] = timed(lambda: predict(
                args.predict_wav, output_path=out, overwrite=True, device="cuda"))
            line["alloc_after_predict"] = alloc_stats()
        param = read_json(DEFAULT_ORCAI_PARAMETER)
        param["model"]["learning_rate"] = LEARNING_RATE
        data_dir = Path(args.data_dir)
        train_ds = ArrayDataset.load(data_dir / "train_dataset")
        val_ds = ArrayDataset.load(data_dir / "val_dataset")
        data, line["upload_s"] = timed(lambda: (DeviceData(train_ds), DeviceData(val_ds)))
        seeds = ([SEED_ID_LOAD_TRAIN_DATA, args.seed], [SEED_ID_LOAD_VAL_DATA, args.seed])
        line["trial"] = trial_stages(param, data, seeds, args.seed, profile=args.profile)
    line["dynamo_imported_at_end"] = "torch._dynamo" in sys.modules
    line["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
