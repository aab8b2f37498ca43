"""Hyperparameter search: Hyperband as a host-side scheduler.

Counterpart of orcai_tpu/train/hpsearch.py:
- the Hyperband brackets and successive halving are explicit
  (`hyperband_schedule`), configs are drawn from the choice grid of
  default_hps_parameter.json (`sample_configs`) by
  np.random.default_rng([13, search_seed]);
- every trial is one `fit` of a fresh model, over the largest share of the
  local devices that divides its batch (mesh_for_batch), as the reference
  trains a trial on its mesh: on one device in this process, over several
  data-parallel in one process each (parallel/distributed.py::launch); a
  promoted config continues from its previous rung's best weights, history
  and epoch, with fresh EarlyStopping / ReduceLROnPlateau counters;
- completed trials persist under <output_dir>/hps_logs/<name>/ (`TrialStore`:
  a JSON record and the weights as a flax msgpack each), so an interrupted
  search resumes without repeating a trial. The store's files are the JAX
  package's, byte for byte where the numbers are the same: either package
  resumes a search the other started;
- `parallel` runs a rung's trials in one thread per local CUDA device,
  each device holding its own resident copy of the datasets; with one
  device it warns and runs them in sequence;
- in a process group of several processes (parallel/distributed.py) every
  process computes the same schedule, runs its round-robin share of each
  rung and reads the other trials' records from the shared store, which is
  the rendezvous; process 0 alone draws a null seed's search seed and
  publishes the outputs.

Outputs: hps_logs/best_hyperparameters.json, hps_logs/all_trials.csv (the
records without their histories, as pandas writes them) and the best model
at <output_dir>/<name>/hps/.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from orcai_tpu_torch.io.dataset import ArrayDataset
from orcai_tpu_torch.io.jsonio import read_json, write_json
from orcai_tpu_torch.io.model_store import save_orcai_model, to_flax_variables
from orcai_tpu_torch.io.msgpack_lite import packb, unpackb
from orcai_tpu_torch.io.tables import Table, object_column
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.parallel.distributed import (
    launch,
    process_count,
    process_index,
    process_partition,
)
from orcai_tpu_torch.parallel.mesh import local_devices, mesh_for_batch
from orcai_tpu_torch.resources import DEFAULT_HPS_PARAMETER, DEFAULT_ORCAI_PARAMETER
from orcai_tpu_torch.train.trainer import (
    DeviceData,
    Trainer,
    device_runners,
    fit,
    resolve_compute_dtype,
    state_dict_from_flax,
    streaming_runners,
)
from orcai_tpu_torch.utils.device import exact_f32_math
from orcai_tpu_torch.utils.messenger import Messenger
from orcai_tpu_torch.utils.seeds import SEED_ID_LOAD_TRAIN_DATA, SEED_ID_LOAD_VAL_DATA



def sample_configs(hps_parameter: dict, n: int, rng: np.random.Generator):
    """n distinct hyperparameter combinations from the choice grid."""
    keys_sets = {
        "filters": list(hps_parameter["filters"].keys()),
        "kernel_size": hps_parameter["kernel_size"],
        "dropout_rate": hps_parameter["dropout_rate"],
        "batch_size": hps_parameter["batch_size"],
    }
    if "lstm_units" in hps_parameter:
        keys_sets["lstm_units"] = hps_parameter["lstm_units"]

    total = math.prod(len(v) for v in keys_sets.values())
    n = min(n, total)
    seen = set()
    configs = []
    while len(configs) < n:
        cfg = {k: v[rng.integers(len(v))] for k, v in keys_sets.items()}
        key = tuple(cfg.items())
        if key not in seen:
            seen.add(key)
            configs.append(cfg)
    return configs


def local_device_ranks(indices) -> dict[int, int]:
    """Submission index -> dense 0-based rank among the submissions this
    process runs; a trial runs on devices[rank % n_workers]. The rank, not
    the index: a round-robin share's indices are all congruent to the
    process id modulo the process count, so `devices[i % n_workers]` would
    put all of a process's trials on one device."""
    return {i: r for r, i in enumerate(sorted(indices))}


def _wait_for_trial(store: "TrialStore", trial_id: str, timeout_s: float) -> dict:
    """Block until another process's trial record lands in the shared store."""
    t0 = time.time()
    while True:
        record = store.load(trial_id)
        if record is not None:
            return {**record, "status": "CACHED"}
        if time.time() - t0 > timeout_s:
            raise TimeoutError(
                f"trial {trial_id} (assigned to another process) did not "
                f"appear in the trial store within {timeout_s:.0f}s"
            )
        time.sleep(2.0)


def hyperband_schedule(max_epochs: int, factor: int = 3):
    """Bracket schedule [(n_configs, [epochs per rung])] for Hyperband."""
    s_max = int(math.log(max_epochs) / math.log(factor))
    brackets = []
    for s in range(s_max, -1, -1):
        n = math.ceil((s_max + 1) / (s + 1) * factor**s)
        rungs = []
        for i in range(s + 1):
            n_i = max(1, math.floor(n * factor**-i))
            r_i = max(1, round(max_epochs * factor ** (i - s)))
            rungs.append((n_i, r_i))
        brackets.append(rungs)
    return brackets


def _apply_config(orcai_parameter: dict, hps_parameter: dict, cfg: dict) -> dict:
    param = {
        **orcai_parameter,
        "model": {**orcai_parameter["model"]},
    }
    param["model"]["filters"] = hps_parameter["filters"][cfg["filters"]]
    param["model"]["kernel_size"] = cfg["kernel_size"]
    param["model"]["dropout_rate"] = cfg["dropout_rate"]
    param["model"]["batch_size"] = cfg["batch_size"]
    if "lstm_units" in cfg:
        if "lstm_units" not in orcai_parameter["model"]:
            raise ValueError(
                "LSTM units not in model parameter. Is the right model specified?"
            )
        param["model"]["lstm_units"] = cfg["lstm_units"]
    elif "lstm_units" in orcai_parameter["model"]:
        raise ValueError(
            "LSTM units not in hyperparameter search parameter. "
            "Is the right model specified?"
        )
    return param


class TrialStore:
    """Completed-trial records and their weights under hps_logs/<name>/.

    One JSON per trial, keyed by a deterministic trial id, beside the
    trial's best weights (flax msgpack). The schedule is a pure function of
    the seed and the recorded scores, so replaying it against the store
    resumes an interrupted search exactly.
    """

    def __init__(self, directory: Path):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def record_path(self, trial_id: str) -> Path:
        return self.directory / f"trial_{trial_id}.json"

    def weights_path(self, trial_id: str) -> Path:
        return self.directory / f"trial_{trial_id}.msgpack"

    def load(self, trial_id: str) -> dict | None:
        path = self.record_path(trial_id)
        if not path.exists():
            return None
        with open(path) as f:
            return json.load(f)

    def save(self, trial_id: str, record: dict, state_bytes: bytes) -> None:
        self.weights_path(trial_id).write_bytes(state_bytes)
        tmp = self.record_path(trial_id).with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(record, f)
        tmp.replace(self.record_path(trial_id))  # atomic: a record implies its weights

    def load_weights(self, trial_id: str) -> bytes | None:
        path = self.weights_path(trial_id)
        return path.read_bytes() if path.exists() else None


def trials_table(all_trials: list[dict]) -> Table:
    """The records as pandas.DataFrame(all_trials) lays them out: columns
    in order of first appearance; an int, float or bool column typed as
    such; ints and floats mixed, or with missing cells, as float64 with
    NaN; anything else as objects."""
    names: list[str] = []
    for record in all_trials:
        names += [k for k in record if k not in names]
    columns = {}
    for name in names:
        cells = [record.get(name) for record in all_trials]
        kinds = {type(c) for c in cells}
        numbers = kinds - {type(None)}
        if kinds in ({int}, {float}, {bool}):
            columns[name] = np.array(cells)
        elif numbers and numbers <= {int, float}:
            columns[name] = np.array([np.nan if c is None else c for c in cells], np.float64)
        else:
            columns[name] = object_column(cells)
    return Table(None, columns)


def _search_seed(orcai_parameter: dict, store: TrialStore) -> int:
    """The project seed, or for a null one the seed this search drew on its
    first run, persisted beside the trials. In a group only process 0
    draws; the others wait for its file, so every process searches the
    same schedule."""
    seed = orcai_parameter["seed"]
    if seed is not None:  # seed 0 is a real seed; only null draws one
        return seed
    seed_file = store.directory / "search_seed.json"
    if process_index() != 0:
        deadline = time.time() + 300
        while not seed_file.exists():
            if time.time() > deadline:
                raise TimeoutError("waiting for process 0 to persist search_seed.json")
            time.sleep(0.5)
    if seed_file.exists():
        return json.loads(seed_file.read_text())["seed"]
    seed = int(np.random.SeedSequence().entropy % (2**63))
    tmp = seed_file.with_suffix(".tmp")
    tmp.write_text(json.dumps({"seed": seed}))
    tmp.replace(seed_file)  # atomic publish
    return seed


@dataclass(frozen=True)
class _Search:
    """What every trial of a search shares. Picklable: a trial trained over
    several devices runs in processes of its own."""

    orcai_parameter: dict
    hps_parameter: dict
    input_shape: tuple
    store_dir: Path
    train_seed: list
    val_seed: list
    seed_int: int
    monitor: str
    early_stopping_patience: int
    on_epoch_end: object = None


def _train_trial(
    search: _Search,
    cfg: dict,
    epochs: int,
    trial_id: str,
    device: torch.device,
    data: tuple,
    initial_epoch: int = 0,
    carry_from: str | None = None,
    distributed: bool = False,
) -> dict:
    """Train one trial on `device` over `data` (a DeviceData pair, or the
    ArrayDatasets to stream) and record it in the store; distributed, this
    process trains its block of every batch and process 0 records."""
    store = TrialStore(search.store_dir)
    param = _apply_config(search.orcai_parameter, search.hps_parameter, cfg)
    mp = param["model"]
    model = build_model(param, search.input_shape, dtype=resolve_compute_dtype(mp))
    trainer = Trainer(model, mp["learning_rate"], device=device, distributed=distributed)
    state = trainer.init_state(seed=search.seed_int)
    initial_history = None
    initial_best_state = None
    if carry_from is not None:
        carried = store.load_weights(carry_from)
        prev_record = store.load(carry_from)
        if carried is not None and prev_record is not None:
            # the previous rung's best weights, a fresh Adam
            initial_best_state = state_dict_from_flax(unpackb(carried))
            state = trainer.state_from_variables(initial_best_state, seed=search.seed_int)
            initial_history = prev_record.get("history")

    train_data, val_data = data
    if not isinstance(train_data, ArrayDataset):
        run_train, run_val = device_runners(
            trainer, train_data, val_data, mp["batch_size"], search.train_seed,
            search.val_seed,
        )
    else:
        run_train, run_val = streaming_runners(
            trainer,
            lambda e: train_data.batches(mp["batch_size"], seed=search.train_seed, epoch=e,
                                         rows=trainer.block),
            lambda e: val_data.batches(mp["batch_size"], seed=search.val_seed, epoch=e,
                                       rows=trainer.block),
        )
    hook = None if search.on_epoch_end is None else (
        lambda s, h, e, lr, c: search.on_epoch_end(trial_id, s, h, e, lr, c))
    state, history = fit(
        trainer,
        state,
        run_train,
        run_val,
        epochs=epochs,
        monitor=search.monitor,
        early_stopping_patience=search.early_stopping_patience,
        reduce_lr_patience=mp["ReduceLROnPlateau_patience"],
        reduce_lr_factor=mp["ReduceLROnPlateau_factor"],
        reduce_lr_min=mp["ReduceLROnPlateau_min_learning_rate"],
        on_epoch_end=hook,
        initial_lr=mp["learning_rate"],
        initial_epoch=initial_epoch,
        initial_history=initial_history,
        initial_best_state=initial_best_state,
        # a promoted config starts its rung with fresh callbacks (as
        # keras-tuner restarts them per fit): counters approximated from
        # the carried history could stop it after one epoch
        initial_counters={"stale_early": 0, "stale_lr": 0},
    )
    score = max(history[search.monitor])
    record = {
        **cfg,
        "trial_id": trial_id,
        "epochs": epochs,
        "score": score,
        search.monitor: score,
        "val_loss": min(history["val_loss"]),
        "status": "COMPLETED",
        "history": history,
    }
    if trainer.rank == 0:
        store.save(trial_id, record, packb(to_flax_variables(state.model.state_dict())))
    return record


def _trial_worker(search: _Search, data_dir: Path, resident: bool, cfg: dict, epochs: int,
                  trial_id: str, initial_epoch: int, carry_from: str | None,
                  device: torch.device) -> None:
    """One process of a trial trained over several devices (launch)."""
    data = (ArrayDataset.load(data_dir / "train_dataset"),
            ArrayDataset.load(data_dir / "val_dataset"))
    if resident:
        data = tuple(DeviceData(ds, device=device) for ds in data)
    _train_trial(search, cfg, epochs, trial_id, device, data, initial_epoch, carry_from,
                 distributed=True)


def hyperparameter_search(
    data_dir: Path | str,
    output_dir: Path | str,
    orcai_parameter: dict | Path | str = DEFAULT_ORCAI_PARAMETER,
    hps_parameter: dict | Path | str = DEFAULT_HPS_PARAMETER,
    parallel: bool = False,
    data_compression: str | None = None,
    max_epochs: int = 10,
    factor: int = 3,
    early_stopping_patience: int = 5,
    verbosity: int = 2,
    msgr: Messenger | None = None,
    on_epoch_end=None,
    device: str | torch.device = "cuda",
) -> None:
    """Hyperband search over the configured space.

    Writes hps_logs/best_hyperparameters.json and hps_logs/all_trials.csv
    under output_dir; per-trial state under hps_logs/<name>/ makes the
    search resumable. early_stopping_patience is the in-trial
    EarlyStopping's. `data_compression` is accepted as the command line
    gives it; each dataset's meta.json decides how it is read.
    on_epoch_end(trial_id, state, history, epoch, lr, counters) is called
    after every trained epoch. The datasets stay on the device when their
    spectrograms fit ORCAI_TPU_DEVICE_DATASET_BYTES (default 6e9) per
    device; larger ones are uploaded batch by batch. float32 math is IEEE
    (no TF32), as in `train`. `device` as `train` takes it: "cuda" means
    every local card (a list names the devices); a trial over several of
    them runs in processes of its own, so on_epoch_end must then be
    picklable.
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Hyperparameter search")

    msgr.part("Loading Hyperparameter search parameter")
    if isinstance(orcai_parameter, (Path, str)):
        orcai_parameter = read_json(orcai_parameter)
    if isinstance(hps_parameter, (Path, str)):
        hps_parameter = read_json(hps_parameter)
    msgr.debug(hps_parameter)
    model_name = orcai_parameter["name"]
    monitor = orcai_parameter["model"]["monitor"]

    msgr.part(f"Loading training and validation datasets from {data_dir}")
    data_dir = Path(data_dir)
    dataset_shape = read_json(data_dir / "dataset_shapes.json")
    input_shape = tuple(dataset_shape["spectrogram"])
    train_ds = ArrayDataset.load(data_dir / "train_dataset")
    val_ds = ArrayDataset.load(data_dir / "val_dataset")

    hps_logs_dir = Path(output_dir) / "hps_logs"
    hps_logs_dir.mkdir(parents=True, exist_ok=True)
    store = TrialStore(hps_logs_dir / model_name)

    # resuming needs the same sampling and data order: the project seed, or
    # one drawn on the first run and kept with the store. The train stream
    # takes the train seed id (the upstream search's test-data id is a slip
    # the JAX package does not copy either)
    search_seed = _search_seed(orcai_parameter, store)
    # several processes: each runs its round-robin share of every rung and
    # reads the rest from the store
    process_id, n_processes = process_index(), process_count()
    rendezvous_timeout = float(os.environ.get("ORCAI_TPU_HPS_RENDEZVOUS_TIMEOUT_S", 3600))
    if n_processes > 1:
        msgr.info(f"Multi-host search: process {process_id}/{n_processes}, trials "
                  "partitioned round-robin with the trial store as rendezvous")
    train_seed = [SEED_ID_LOAD_TRAIN_DATA, search_seed]
    val_seed = [SEED_ID_LOAD_VAL_DATA, search_seed]

    # this process's devices (its share of the host's in a group): one a
    # trial side by side under `parallel`, else every trial over the
    # largest share of them that divides its batch (mesh_for_batch), one
    # process each
    devices = local_devices(device)
    n_workers = len(devices) if parallel else 1
    if parallel and n_workers == 1:
        msgr.warning(
            "--parallel requested but only one device is visible; "
            "trials run sequentially"
        )

    # datasets resident on a device, shared by every trial there
    limit = int(os.environ.get("ORCAI_TPU_DEVICE_DATASET_BYTES", 6_000_000_000))
    resident = (train_ds.x.nbytes + val_ds.x.nbytes) * n_workers <= limit
    device_data_cache: dict[int, tuple[DeviceData, DeviceData]] = {}
    # check-then-insert under a lock: a thread freed early (by a cached
    # trial) must not upload a second copy onto a device another is filling
    device_data_lock = threading.Lock()

    def device_data_for(rank: int) -> tuple:
        if not resident:
            return train_ds, val_ds
        with device_data_lock:
            if rank not in device_data_cache:
                device_data_cache[rank] = (
                    DeviceData(train_ds, device=devices[rank]),
                    DeviceData(val_ds, device=devices[rank]),
                )
            return device_data_cache[rank]

    if resident:
        msgr.info("Datasets HBM-resident: shared across trials")
    rng = np.random.default_rng([13, search_seed])
    search = _Search(orcai_parameter, hps_parameter, input_shape, store.directory,
                     train_seed, val_seed, int(search_seed) % (2**31), monitor,
                     early_stopping_patience, on_epoch_end)

    def run_trial(
        cfg: dict,
        epochs: int,
        trial_id: str,
        rank: int,
        initial_epoch: int = 0,
        carry_from: str | None = None,
    ) -> dict:
        cached = store.load(trial_id)
        if cached is not None:
            return {**cached, "status": "CACHED"}
        if not parallel:
            batch_size = _apply_config(orcai_parameter, hps_parameter, cfg)["model"]["batch_size"]
            mesh = mesh_for_batch(batch_size, devices)
            if len(mesh) > 1:
                msgr.info(f"  trial {trial_id}: data-parallel over {len(mesh)} devices")
                launch(_trial_worker, mesh, store.directory, args=(
                    search, data_dir, resident, cfg, epochs, trial_id, initial_epoch,
                    carry_from))
                return store.load(trial_id)
        return _train_trial(search, cfg, epochs, trial_id, devices[rank],
                            device_data_for(rank), initial_epoch, carry_from)

    brackets = hyperband_schedule(max_epochs, factor)
    msgr.part(
        f"Searching hyperparameters: Hyperband max_epochs={max_epochs} "
        f"factor={factor}, {len(brackets)} brackets"
        + (f", {n_workers} trial workers" if n_workers > 1 else "")
    )

    all_trials: list[dict] = []
    trial_counter = 0
    best = {"score": -np.inf, "config": None, "trial_id": None}

    with exact_f32_math():
        for b, rungs in enumerate(brackets):
            n0, _ = rungs[0]
            configs = sample_configs(hps_parameter, n0, rng)
            msgr.info(f"Bracket {b}: rungs {rungs}, {len(configs)} configs")
            # per-config trial id of the previous rung (for weight carrying)
            prev_trial_id: dict[tuple, str] = {}
            prev_epochs = 0
            for rung_idx, (n_i, r_i) in enumerate(rungs):
                configs = configs[:n_i]
                submissions = []
                for cfg in configs:
                    trial_id = f"b{b}r{rung_idx}t{trial_counter:03d}"
                    trial_counter += 1
                    key = tuple(sorted(cfg.items()))
                    submissions.append((cfg, trial_id, prev_trial_id.get(key)))
                mine = set(process_partition(len(submissions), process_id, n_processes))
                local_rank = local_device_ranks(mine)
                records: list[dict | None] = [None] * len(submissions)
                if n_workers > 1:
                    with ThreadPoolExecutor(max_workers=n_workers) as pool:
                        futures = {
                            i: pool.submit(
                                run_trial, cfg, r_i, tid, local_rank[i] % n_workers,
                                initial_epoch=prev_epochs if carry else 0,
                                carry_from=carry,
                            )
                            for i, (cfg, tid, carry) in enumerate(submissions)
                            if i in mine
                        }
                        for i, f in futures.items():
                            records[i] = f.result()
                else:
                    for i, (cfg, tid, carry) in enumerate(submissions):
                        if i in mine:
                            records[i] = run_trial(
                                cfg, r_i, tid, 0,
                                initial_epoch=prev_epochs if carry else 0,
                                carry_from=carry,
                            )
                for i, (_, tid, _) in enumerate(submissions):
                    if records[i] is None:
                        records[i] = _wait_for_trial(store, tid, rendezvous_timeout)

                scored = []
                for (cfg, trial_id, _), record in zip(submissions, records):
                    # the recorded config wins over the freshly sampled one:
                    # a cached record says what was trained under this id
                    cfg = {k: record.get(k, v) for k, v in cfg.items()}
                    all_trials.append({k: v for k, v in record.items() if k != "history"})
                    scored.append((record["score"], cfg))
                    msgr.info(
                        f"  trial {trial_id}: {cfg} -> {monitor}={record['score']:.4f}"
                        + (" (cached)" if record["status"] == "CACHED" else "")
                    )
                    if record["score"] > best["score"]:
                        best = {"score": record["score"], "config": cfg,
                                "trial_id": trial_id}
                    prev_trial_id[tuple(sorted(cfg.items()))] = trial_id
                prev_epochs = r_i
                # promote the top 1/factor to the next rung
                scored.sort(key=lambda t: t[0], reverse=True)
                configs = [cfg for _, cfg in scored]

    if process_id != 0:
        # the shared store holds every record; process 0 publishes
        msgr.success("Hyperparameter search completed (worker process)")
        return

    msgr.part("Best Hyperparameters")
    msgr.info(best["config"])
    write_json(best["config"], hps_logs_dir / "best_hyperparameters.json")
    trials_table(all_trials).to_csv(hps_logs_dir / "all_trials.csv", index=False)
    msgr.info(f"Saved trial data to {hps_logs_dir / 'all_trials.csv'}")

    # the overall best model, loadable as a model directory
    best_bytes = store.load_weights(best["trial_id"]) if best["trial_id"] else None
    if best_bytes is not None:
        hps_model_dir = Path(output_dir) / model_name / "hps"
        param = _apply_config(orcai_parameter, hps_parameter, best["config"])
        model = build_model(param, input_shape)
        model.load_state_dict(state_dict_from_flax(unpackb(best_bytes)))
        save_orcai_model(hps_model_dir, param, model.state_dict(), input_shape=input_shape)
        msgr.info(f"Saved best model to {hps_model_dir}")
    msgr.success("Hyperparameter search completed")
