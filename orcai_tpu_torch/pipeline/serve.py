"""Watch-folder prediction service.

Counterpart of orcai_tpu/pipeline/serve.py. Field deployments produce
recordings continuously; a fresh process per recording pays the CUDA
context, the kernels' build check, cuDNN's set-up and the model load every
time. This service holds one predictor for the life of the process and
predicts each wav as it arrives.

Per-recording outputs are identical to `predict` on the same file (the
same `<stem>_c<channel>_<model>_predicted.txt` contract); a recording that
fails leaves a `<output>.failed` marker with the error text, so it is
reported once and not retried in a loop. A new file is picked up when its
(size, mtime) signature is the same in two consecutive polls, so a
half-written upload is never read early.

Failures (utils/device_health.py::classify_error):

- an ordinary per-file error (corrupt wav, recording too short) is never
  retried: marker, log, next file;
- an out-of-memory error leaves the device sound: the service drops its
  predictor, empties the allocator's cache, builds the predictor again
  from disk, warms it again, and retries the file once; only a second
  failure writes the marker, and later arrivals use the new predictor;
- a sticky CUDA error (illegal memory access, launch failure, device-side
  assert, uncorrectable ECC) kills the process's CUDA context, and no
  rebuild inside the process can help. The file is not at fault, so the
  service writes NO `.failed` marker for it, logs, and raises: a supervisor
  restarts the process, and the new process takes the file again.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR
from orcai_tpu_torch.pipeline import predict as predict_mod
from orcai_tpu_torch.tools.warmup import warm_predictor
from orcai_tpu_torch.utils.device_health import classify_error
from orcai_tpu_torch.utils.messenger import Messenger


def scan_ready(
    watch_dir: Path,
    prev_sigs: dict[Path, tuple[int, int]],
    done: set[Path],
) -> tuple[list[Path], dict[Path, tuple[int, int]]]:
    """One poll: (ready wav paths, current signatures).

    A file is ready when its (size, mtime_ns) matches the previous poll's
    signature, so nothing wrote to it for a full poll interval, and it is
    larger than a bare RIFF header. Files in `done` are skipped without a
    signature entry, so the dict stays bounded by the backlog, not by the
    directory's history.
    """
    cur: dict[Path, tuple[int, int]] = {}
    ready: list[Path] = []
    for p in sorted(watch_dir.glob("*.wav")):
        if p in done:
            continue
        try:
            st = p.stat()
        except OSError:
            continue  # vanished between glob and stat
        sig = (st.st_size, st.st_mtime_ns)
        cur[p] = sig
        if prev_sigs.get(p) == sig and st.st_size > 44:
            ready.append(p)
    return ready, cur


def serve(
    watch_dir: Path | str,
    model_dir: Path | str | None = None,
    output_dir: Path | str | None = None,
    channel: int = 1,
    overwrite: bool = False,
    save_probabilities: bool = False,
    call_duration_limits: Path | str | None = None,
    label_suffix: str = "*",
    predict_batch_size: int = 128,
    poll_seconds: float = 2.0,
    warm_minutes: float = 0.0,
    max_files: int | None = None,
    max_idle_polls: int | None = None,
    sleep=time.sleep,
    device: str | torch.device = "cuda",
    wire: str | None = None,
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> int:
    """Watch `watch_dir` for wav files and predict each as it arrives.

    Runs until interrupted; `max_files` / `max_idle_polls` bound the run
    for scripted and test use (`max_idle_polls` counts consecutive polls
    that found nothing ready). Returns the number of recordings processed,
    failures with a `.failed` marker included. A path is processed at most
    once in the life of the service: replacing a wav in place needs a
    restart (with overwrite) to predict it again.

    `warm_minutes > 0` runs every recording-length shape up to that duration
    through this predictor (tools/warmup.py) before the first poll, and
    again after a rebuild, on the same `wire` the files are predicted with
    (see `predict`). Raises on a sticky CUDA error (see the module
    docstring).
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Serving predictions")
    watch_dir = Path(watch_dir)
    if not watch_dir.is_dir():
        raise NotADirectoryError(f"watch_dir does not exist: {watch_dir}")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    model_dir = Path(model_dir) if model_dir is not None else DEFAULT_MODEL_DIR
    msgr.part(f"Loading model: {model_dir.stem}")

    def build():
        # also the recovery path: weights are read from disk again and the
        # whole device state is made anew
        predictor, orcai_parameter, shape = predict_mod.build_predictor(
            model_dir, predict_batch_size, device, msgr
        )
        if warm_minutes > 0:
            warm_predictor(predictor, orcai_parameter["spectrogram"], warm_minutes,
                           wire=wire, msgr=msgr)
        return predictor, orcai_parameter, shape

    predictor, orcai_parameter, shape = build()
    msgr.part(f"Watching {watch_dir} (poll every {poll_seconds:g} s; stop with ^C)")

    def predict_one(wav: Path, out_path: Path) -> None:
        predict_mod._predict_and_save(
            recording_path=wav,
            channel=channel,
            predictor=predictor,
            orcai_parameter=orcai_parameter,
            shape=shape,
            output_path=out_path,
            overwrite=True,  # checked below, with the marker's semantics
            save_probabilities=save_probabilities,
            call_duration_limits=call_duration_limits,
            label_suffix=label_suffix,
            wire=wire,
            msgr=Messenger(verbosity=0),
        )

    prev_sigs: dict[Path, tuple[int, int]] = {}
    done: set[Path] = set()
    n_processed = 0
    idle_polls = 0
    while True:
        ready, prev_sigs = scan_ready(watch_dir, prev_sigs, done)
        if not ready:
            idle_polls += 1
            if max_idle_polls is not None and idle_polls >= max_idle_polls:
                break
            sleep(poll_seconds)
            continue
        idle_polls = 0
        for wav in ready:
            done.add(wav)
            name = f"{wav.stem}_c{channel}_{orcai_parameter['name']}_predicted.txt"
            out_path = (output_dir or wav.parent) / name
            failed_marker = out_path.with_suffix(out_path.suffix + ".failed")
            if not overwrite and (out_path.exists() or failed_marker.exists()):
                msgr.info(f"{wav.name}: output exists, skipping")
                continue
            t0 = time.perf_counter()
            try:
                out_of_memory = False
                try:
                    predict_one(wav, out_path)
                except Exception as e:
                    if classify_error(e) != "out_of_memory":
                        raise  # the input's fault or a dead context: no retry
                    out_of_memory = True
                    msgr.error(
                        f"Out of device memory while predicting {wav.name} ({e}); "
                        "rebuilding the predictor and retrying once"
                    )
                if out_of_memory:
                    # outside the handler: the exception's traceback held
                    # the failed call's tensors, which are free only now
                    if torch.cuda.is_available():
                        torch.cuda.empty_cache()
                    predictor, orcai_parameter, shape = build()
                    predict_one(wav, out_path)
                failed_marker.unlink(missing_ok=True)
                msgr.info(f"{wav.name} -> {out_path.name} "
                          f"({time.perf_counter() - t0:.1f} s)")
            except Exception as e:  # keep serving on a per-file failure
                if classify_error(e) == "device_lost":
                    msgr.error(
                        f"CUDA context lost while predicting {wav.name} ({e}): no marker "
                        "written, the process must be restarted"
                    )
                    raise
                try:
                    failed_marker.write_text(f"{e}\n")
                except OSError as marker_err:
                    # the marker can fail for the reason the predict did
                    # (disk full, read-only folder); `done` already keeps
                    # this path out of a retry loop
                    msgr.error(f"Could not write {failed_marker.name}: {marker_err}")
                msgr.error(f"Error predicting {wav.name}: {e}")
            n_processed += 1
            if max_files is not None and n_processed >= max_files:
                return n_processed
        # no sleep after a productive poll: more files may be ready already
    return n_processed
