"""Spectrogram production: wav recordings -> normalized spectrogram zarr
stores + time/frequency vectors (counterpart of
orcai_tpu/pipeline/spectrogram.py).

Per recording, <output_dir>/<recording>/spectrogram/ holds spectrogram.zarr
(float32 (T, bins), chunks (2000, bins), blosc-lz4 or gzip), frequencies.json
and times.json in {min, max, length} form. The device engine is the port's
frontend on the card: kernel B1 for the magnitudes, B2 and the pick for the
percentile clip (ops/frontend.py). The host engine is the numpy copy of the
reference's host frontend. "auto" resolves to the device engine: the
reference's link probe measures the TPU's host link, which has no
counterpart here.

The run is a three-stage pipeline: a loader thread decodes the next wav
while the main thread computes, and a writer thread persists stores behind
it. On the device engine the main thread dispatches recording i+1 before it
fetches recording i to the host, as the reference does.
"""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path

import numpy as np

from orcai_tpu_torch.io.jsonio import read_json, write_vector_to_json
from orcai_tpu_torch.io.tables import Table, isna
from orcai_tpu_torch.io.wav import load_wav
from orcai_tpu_torch.io.zarrlite import resolve_zarr_codec, save_as_zarr
from orcai_tpu_torch.parallel.distributed import shard_table_for_process
from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER as DEFAULT_PARAMETER
from orcai_tpu_torch.utils.messenger import Messenger

SPEC_ENGINES = ("auto", "device", "host")
_PUT_POLL_S = 0.1  # how often a blocked enqueue looks at the other thread


def resolve_spectrogram_engine(engine: str = "auto") -> str:
    """'device' | 'host'; 'auto' is the device engine. Only the caller's
    argument chooses the host engine, so a run asked for on the card never
    moves to the CPU."""
    if engine not in SPEC_ENGINES:
        raise ValueError(f"unknown spectrogram engine {engine!r} ({'|'.join(SPEC_ENGINES)})")
    return "device" if engine == "auto" else engine


def load_recording_audio(path: Path | str, sampling_rate: int, channel: int = 1) -> np.ndarray:
    """float32 mono audio of `channel` (1-based), resampled to the rate."""
    audio, _ = load_wav(path, sr=sampling_rate, mono=False)
    if audio.ndim > 1:
        audio = audio[int(channel) - 1]
    return audio


def make_spectrogram(
    wav_file_path: Path | str,
    channel: int = 1,
    orcai_parameter: dict | Path | str = DEFAULT_PARAMETER,
    verbosity: int = 2,
    msgr: Messenger | None = None,
    wire: str = "exact",
    device: str = "cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """wav file -> (normalized spectrogram (T, bins), frequencies, times),
    computed on `device` and returned to the host.

    `wire` defaults to "exact" here, where predict's default is "auto": these
    spectrograms are stored for training and evaluation. A coded wire
    (ops/wire_codec.py) is the caller's choice."""
    from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device

    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Making spectrogram")
    if isinstance(orcai_parameter, (Path, str)):
        orcai_parameter = read_json(orcai_parameter)
    sp = orcai_parameter["spectrogram"]
    msgr.part("Computing spectrogram on device")
    msgr.info(f"Loading & resampling (to {sp['sampling_rate'] / 1000:.2f} kHz) "
              f"wav file: {Path(wav_file_path).stem}")
    audio, _ = load_wav(wav_file_path, sr=sp["sampling_rate"], mono=False)
    if audio.ndim > 1:
        msgr.warning(f"Multiple channels found, using channel {channel}")
        audio = audio[int(channel) - 1]
    spec, n_frames, frequencies, times = make_spectrogram_from_params_device(
        audio, sp, device=device, wire=wire)
    if len(times) > 1:
        msgr.info(f"Duration of wav file: {times[-1]:.2f} seconds")
    return spec[:n_frames].cpu().numpy(), frequencies, times


def save_spectrogram(
    spectrogram: np.ndarray,
    frequencies: np.ndarray,
    times: np.ndarray,
    output_dir: Path | str,
    verbosity: int = 2,
    msgr: Messenger | None = None,
) -> None:
    """Write spectrogram.zarr + frequencies.json + times.json to output_dir."""
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Saving spectrogram")
    msgr.part("Saving spectrogram")
    output_dir = Path(output_dir)
    save_as_zarr(spectrogram, output_dir / "spectrogram.zarr", compress="auto")
    write_vector_to_json(frequencies, output_dir / "frequencies.json")
    write_vector_to_json(times, output_dir / "times.json")


def _truthy(value) -> bool:
    """A call-possibility cell as DataFrame.any counts it: missing is False."""
    if value is None or (isinstance(value, float) and value != value):
        return False
    return bool(value)


def create_spectrograms(
    recording_table_path: Path | str,
    output_dir: Path | str,
    base_dir_recording: Path | str | None = None,
    orcai_parameter: dict | Path | str = DEFAULT_PARAMETER,
    include_not_annotated: bool = False,
    include_no_possible_annotations: bool = False,
    overwrite: bool = False,
    verbosity: int = 2,
    msgr: Messenger | None = None,
    wire: str = "exact",
    engine: str = "auto",
    device: str = "cuda",
) -> dict:
    """Spectrograms for the rows of a recording table.

    Skips recordings without annotation, recordings where no call is
    possible (a blank cell counts as not possible here) and recordings
    whose spectrogram directory exists, unless told otherwise. Returns a
    report: the engine, the number of recordings, the codec, the bytes
    written and the summed wall of each stage (wav load, frontend dispatch,
    fetch to the host, store write; the fetch waits for the device).
    `wire` is the device engine's upload (see make_spectrogram); the host
    engine reads the samples as they are, as the reference's does.
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Creating spectrograms")

    msgr.part("Reading recordings table")
    table = Table.read_csv(recording_table_path)
    output_dir = Path(output_dir)
    if isinstance(orcai_parameter, (Path, str)):
        orcai_parameter = read_json(orcai_parameter)

    if not include_not_annotated:
        not_annotated = isna(table["base_dir_annotation"])
        if not_annotated.sum() > 0:
            msgr.info(f"Excluded {int(not_annotated.sum())} recordings because they are "
                      "not annotated.")
        table = table.take(~not_annotated)

    if not include_no_possible_annotations:
        calls = orcai_parameter["calls"]
        included = np.array([any(_truthy(table[c][i]) for c in calls)
                             for i in range(len(table))], dtype=bool)
        if (~included).sum() > 0:
            msgr.info("Excluded recordings because they lack any possible annotations:",
                      indent=1)
            msgr.info(str(np.asarray(table["recording"][~included], dtype=object)), indent=-1)
        table = table.take(included)

    table = shard_table_for_process(table, msgr)

    if not overwrite:
        existing = np.array([output_dir.joinpath(str(r), "spectrogram").exists()
                             for r in table["recording"]], dtype=bool)
        if existing.sum() > 0:
            msgr.info(f"Skipping {int(existing.sum())} recordings because they already "
                      "have spectrograms.")
        table = table.take(~existing)

    if base_dir_recording is not None:
        table["base_dir_recording"] = str(base_dir_recording)

    engine = resolve_spectrogram_engine(engine)
    if engine == "device":
        from orcai_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
    rows = list(table.records())
    msgr.part(f"Creating {len(rows)} spectrograms ({engine} engine)")
    stats = _run_spectrogram_pipeline(
        rows, orcai_parameter, output_dir, engine, dev if engine == "device" else None,
        wire)
    msgr.success("Spectrograms created.")
    return {"engine": engine, "n_recordings": len(rows),
            "codec": resolve_zarr_codec("auto"), **stats}


def _put(q: queue.Queue, item, failed) -> None:
    """q.put that gives up when `failed()` returns an exception, which it
    raises; a consumer that died must not leave the producer blocked."""
    while True:
        err = failed()
        if err is not None:
            raise err
        try:
            q.put(item, timeout=_PUT_POLL_S)
            return
        except queue.Full:
            continue


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _run_spectrogram_pipeline(rows, orcai_parameter: dict, output_dir: Path, engine: str,
                              dev, wire: str) -> dict:
    """load || compute || store-write, one recording of lookahead each.

    Loader and writer errors propagate to the caller. Every enqueue polls
    the other side's error, so a dead writer with a full queue raises
    instead of blocking the run for ever.
    """
    from orcai_tpu_torch.ops.frontend import (
        compute_spectrogram_host,
        make_spectrogram_from_params_device,
    )

    sp = orcai_parameter["spectrogram"]
    loads: queue.Queue = queue.Queue(maxsize=1)
    writes: queue.Queue = queue.Queue(maxsize=2)
    write_err: list[BaseException] = []
    stop = threading.Event()
    walls = {"load_s": 0.0, "frontend_s": 0.0, "fetch_s": 0.0, "write_s": 0.0,
             "bytes_written": 0}

    def loader() -> None:
        def stopped():
            return InterruptedError("stopped") if stop.is_set() else None

        try:
            for rec in rows:
                t0 = time.perf_counter()
                audio = load_recording_audio(
                    Path(rec["base_dir_recording"]) / rec["rel_recording_path"],
                    sp["sampling_rate"], rec["channel"])
                walls["load_s"] += time.perf_counter() - t0
                _put(loads, (rec, audio), stopped)
            _put(loads, None, stopped)
        except InterruptedError:
            return
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
            try:
                _put(loads, exc, stopped)
            except InterruptedError:
                return

    def writer() -> None:
        while True:
            item = writes.get()
            if item is None:
                return
            try:
                spec, freqs, times, out = item
                t0 = time.perf_counter()
                save_spectrogram(spec, freqs, times, out)
                walls["write_s"] += time.perf_counter() - t0
                walls["bytes_written"] += _dir_bytes(out)
            except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
                write_err.append(exc)
                return

    lt = threading.Thread(target=loader, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    lt.start()
    wt.start()

    def writer_failed():
        if write_err:
            return write_err[0]
        if not wt.is_alive():
            return RuntimeError("the store writer stopped")
        return None

    def submit_write(spec, freqs, times, out) -> None:
        _put(writes, (spec, freqs, times, out), writer_failed)

    def fetch(pending) -> None:
        dev_spec, n_frames, freqs, times, out = pending
        t0 = time.perf_counter()
        host = dev_spec[:n_frames].cpu().numpy()
        walls["fetch_s"] += time.perf_counter() - t0
        submit_write(host, freqs, times, out)

    pending = None  # device engine: the recording dispatched but not fetched
    try:
        while True:
            item = loads.get()
            if isinstance(item, BaseException):
                raise item
            if item is None:
                break
            rec, audio = item
            out = output_dir / str(rec["recording"]) / "spectrogram"
            t0 = time.perf_counter()
            if engine == "host":
                spec, freqs, times = compute_spectrogram_host(
                    audio, sp["sampling_rate"], sp["nfft"], sp["n_overlap"],
                    sp["freq_range"], sp["quantiles"])
                walls["frontend_s"] += time.perf_counter() - t0
                submit_write(spec, freqs, times, out)
                continue
            dev_spec, n_frames, freqs, times = make_spectrogram_from_params_device(
                audio, sp, device=dev, wire=wire)
            walls["frontend_s"] += time.perf_counter() - t0
            prev, pending = pending, (dev_spec, n_frames, freqs, times, out)
            if prev is not None:
                fetch(prev)
        if pending is not None:
            fetch(pending)
            pending = None
        _put(writes, None, writer_failed)
        wt.join()
    finally:
        stop.set()
        if wt.is_alive():
            try:
                _put(writes, None, writer_failed)
            except BaseException:  # noqa: BLE001 - the writer is gone already
                pass
            wt.join(timeout=60.0)
        lt.join(timeout=5.0)
    if write_err:
        raise write_err[0]
    return walls
