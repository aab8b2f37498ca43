"""The per-process fan-out of the port's batch commands and of hpsearch
(orcai_tpu_torch/parallel/distributed.py) against one process, on the CPU.

The recording-table commands (create-spectrograms, create-label-arrays,
predict on a table) split their rows round-robin over the processes of a
group, as the JAX package's do (tests/test_multihost_fanout.py): two
processes are simulated one after the other by setting the rank, and their
shares must be disjoint, follow the reference's positional split, and
together write what one process writes, byte for byte. hpsearch runs in two
real processes joined by initialize_distributed over gloo
(tests/test_hpsearch_multiprocess.py:81): every trial is recorded once,
process 1 publishes nothing, and the records and best_hyperparameters.json
equal a one-process search's."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orcai_tpu.parallel.distributed import process_partition as jax_process_partition
from orcai_tpu_torch.io.dataset import ArrayDataset
from orcai_tpu_torch.io.jsonio import read_json
from orcai_tpu_torch.io.tables import Table
from orcai_tpu_torch.parallel import distributed
from orcai_tpu_torch.pipeline.labels import create_label_arrays
from orcai_tpu_torch.pipeline.predict import predict
from orcai_tpu_torch.pipeline.spectrogram import create_spectrograms
from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
from orcai_tpu_torch.tools.synthetic import CALLS, make_synthetic_project
from orcai_tpu_torch.train import hpsearch

ROOT = Path(__file__).resolve().parent.parent


def setup_module():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("fanout")
    table_path = make_synthetic_project(root, n_recordings=4, duration_s=20.0, seed=5)
    param = read_json(DEFAULT_ORCAI_PARAMETER)
    param["calls"] = list(CALLS)
    return root, table_path, param


def _as_process(monkeypatch, pid: int, count: int) -> None:
    monkeypatch.setattr(distributed, "process_count", lambda: count)
    monkeypatch.setattr(distributed, "process_index", lambda: pid)


def _files(directory: Path) -> dict[str, bytes]:
    return {str(p.relative_to(directory)): p.read_bytes()
            for p in sorted(directory.rglob("*")) if p.is_file()}


def _recordings(table_path: Path) -> list[str]:
    return list(Table.read_csv(table_path)["recording"])


def _fan_out(monkeypatch, run, out: Path, kind: str) -> list[set[str]]:
    """run(out) as process 0 and then process 1 of 2; the recordings that
    have `kind` outputs after each."""
    done = []
    for pid in range(2):
        _as_process(monkeypatch, pid, 2)
        run(out)
        done.append({p.parent.name for p in out.glob(f"*/{kind}")})
    monkeypatch.undo()
    return done


def test_create_spectrograms_fans_out_per_process(project, tmp_path, monkeypatch):
    root, table_path, param = project
    names = _recordings(table_path)

    def run(out):
        create_spectrograms(table_path, out, orcai_parameter=param, device="cpu")

    done = _fan_out(monkeypatch, run, tmp_path / "fanned", "spectrogram")
    assert done[0] == {names[i] for i in jax_process_partition(len(names), 0, 2)}
    assert done[1] == set(names) and len(done[0]) == 2
    run(tmp_path / "one")
    assert _files(tmp_path / "fanned") == _files(tmp_path / "one")


def test_create_label_arrays_fans_out_per_process(project, tmp_path, monkeypatch):
    root, table_path, param = project
    names = _recordings(table_path)

    def run(out):
        create_label_arrays(table_path, out, orcai_parameter=param)

    for out in (tmp_path / "fanned", tmp_path / "one"):
        # the labels' time grid comes from the stored spectrograms
        create_spectrograms(table_path, out, orcai_parameter=param, device="cpu")
    done = _fan_out(monkeypatch, run, tmp_path / "fanned", "labels")
    assert done[0] == {names[i] for i in jax_process_partition(len(names), 0, 2)}
    assert done[1] == set(names)
    run(tmp_path / "one")
    assert _files(tmp_path / "fanned") == _files(tmp_path / "one")


def test_predict_table_fans_out_per_process(project, tmp_path, monkeypatch):
    root, table_path, _ = project
    names = _recordings(table_path)
    shares = []
    for pid in range(2):
        _as_process(monkeypatch, pid, 2)
        saved = predict(table_path, output_path=tmp_path / "fanned", overwrite=True,
                        predict_batch_size=16, device="cpu")
        shares.append({p.name for p in saved})
    monkeypatch.undo()
    # the JAX package's rule: process 0 takes rows 0, 2, ...
    assert shares[0] == {f"{n}_orcai-v1_predicted.txt" for n in names[::2]}
    assert shares[1] == {f"{n}_orcai-v1_predicted.txt" for n in names[1::2]}
    predict(table_path, output_path=tmp_path / "one", predict_batch_size=16, device="cpu")
    assert _files(tmp_path / "fanned") == _files(tmp_path / "one")


# -- hpsearch over two processes ---------------------------------------------------

INPUT_SHAPE = (32, 21, 1)
PARAM = {
    "name": "mp",
    "architecture": "ResNetLSTM",
    "model": {
        "epochs": 2, "batch_size": 8, "filters": [2, 3, 4, 5], "kernel_size": 3,
        "dropout_rate": 0.1, "lstm_units": 4, "learning_rate": 1e-2,
        "ReduceLROnPlateau_patience": 3, "ReduceLROnPlateau_factor": 0.5,
        "ReduceLROnPlateau_min_learning_rate": 1e-7, "monitor": "val_MBA",
    },
    "calls": ["A", "B"],
    "seed": None,
}
# a search over two devices against one (trial weights by norm, read up to
# 1.63e-3; a naive DDP wrap, per-process BatchNorm and loss means, reads
# 4.63e-2 to 4.92e-2), and its epoch losses (read up to 7.1e-3)
SEARCH_WEIGHTS_BAR = 5e-3
SEARCH_LOSS_RTOL = 1e-2
HPS = {"filters": {"tiny": [2, 3, 4, 5], "small": [3, 4, 5, 6]}, "lstm_units": [4],
       "dropout_rate": [0.1], "kernel_size": [3], "batch_size": [8]}

CHILD = r"""
import json, logging, sys
from pathlib import Path
import torch
torch.backends.mkldnn.enabled = False  # the CPU conv backward fault (ROADMAP C)
torch.set_num_threads(1)
logging.basicConfig(level=logging.INFO, format="%(message)s")
from orcai_tpu_torch.parallel.distributed import initialize_distributed, process_count
from orcai_tpu_torch.train.hpsearch import hyperparameter_search

address, pid, root = sys.argv[1], int(sys.argv[2]), Path(sys.argv[3])
initialize_distributed(coordinator_address=address, num_processes=2, process_id=pid)
assert process_count() == 2
hyperparameter_search(root / "data", root / "out",
                      orcai_parameter=json.loads((root / "param.json").read_text()),
                      hps_parameter=json.loads((root / "hps.json").read_text()),
                      max_epochs=2, factor=2, device="cpu")
print(f"HPS-PROC-{pid}-DONE")
"""


def _write_data(path: Path) -> Path:
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(16, *INPUT_SHAPE)).astype(np.float32)
    y = rng.integers(0, 2, size=(16, 2, 2)).astype(np.float32)

    class Loader:
        def __len__(self):
            return len(x)

        def __iter__(self):
            return iter(zip(x, y))

    path.mkdir(parents=True)
    for split in ("train", "val"):
        ArrayDataset.save_from_loader(Loader(), path / f"{split}_dataset")
    (path / "dataset_shapes.json").write_text(
        json.dumps({"spectrogram": list(INPUT_SHAPE), "labels": [2, 2]}))
    return path


def _two_process_search(root: Path) -> list[str]:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"localhost:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               ORCAI_TPU_HPS_RENDEZVOUS_TIMEOUT_S="240")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, address, str(pid), str(root)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for pid in range(2)]
    logs = []
    for pid, p in enumerate(procs):
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        assert f"HPS-PROC-{pid}-DONE" in out
        logs.append(out)  # the console report
    return logs


def _statuses(csv: str) -> list[str]:
    lines = csv.splitlines()
    column = lines[0].split(",").index("status")
    return [line.split(",")[column] for line in lines[1:]]


def test_two_process_search_equals_a_one_process_search(tmp_path):
    """A null project seed: process 0 draws the search seed and the other
    waits for it. Each process trains its round-robin share of every rung
    and reads the rest from the store; process 1 publishes nothing. A
    one-process search at the drawn seed records the same trials and picks
    the same best; a rerun of the two processes finds every trial CACHED."""
    root = tmp_path / "two"
    _write_data(root / "data")
    (root / "param.json").write_text(json.dumps(PARAM))
    (root / "hps.json").write_text(json.dumps(HPS))
    logs = _two_process_search(root)
    assert "worker process" in logs[1] and "Saved best model" not in logs[1]
    assert "Saved best model" in logs[0]
    store = root / "out" / "hps_logs" / "mp"
    seed = read_json(store / "search_seed.json")["seed"]
    published = root / "out" / "hps_logs"
    csv = (published / "all_trials.csv").read_text()
    statuses = _statuses(csv)
    # process 0 ran its own trials and read process 1's back from the store
    assert statuses.count("COMPLETED") >= 1 and statuses.count("CACHED") >= 1
    assert statuses.count("COMPLETED") + statuses.count("CACHED") == len(statuses)

    one = tmp_path / "one"
    with torch.backends.mkldnn.flags(enabled=False):  # as in the two processes
        hpsearch.hyperparameter_search(
            root / "data", one, orcai_parameter={**PARAM, "seed": seed}, hps_parameter=HPS,
            max_epochs=2, factor=2, device="cpu")
    one_store = one / "hps_logs" / "mp"
    records = sorted(p.name for p in one_store.glob("trial_*.json"))
    assert records == sorted(p.name for p in store.glob("trial_*.json")) and records
    for name in records:
        assert (store / name).read_bytes() == (one_store / name).read_bytes(), name
        weights = name.replace(".json", ".msgpack")
        assert (store / weights).read_bytes() == (one_store / weights).read_bytes(), weights
    assert (published / "best_hyperparameters.json").read_bytes() == \
        (one / "hps_logs" / "best_hyperparameters.json").read_bytes()
    one_csv = (one / "hps_logs" / "all_trials.csv").read_text()
    assert csv.replace("CACHED", "COMPLETED") == one_csv
    assert (root / "out" / "mp" / "hps").is_dir()

    _two_process_search(root)
    assert set(_statuses((published / "all_trials.csv").read_text())) == {"CACHED"}


def test_a_search_trains_each_trial_over_the_devices_its_batch_divides(tmp_path, capsys):
    """Without `parallel`, a search given two devices trains every trial
    data-parallel over both (mesh_for_batch of its batch 8), one process
    each, as the reference trains a trial on its mesh. Against a one-device
    search: the same trials, configs, epochs, scores, validation MBAs and
    best; each trial's weights within SEARCH_WEIGHTS_BAR by norm, the losses
    within SEARCH_LOSS_RTOL, the training MBA within two labels. At this learning rate (1e-2) the two reduction orders
    part after the first step: Adam moves a bias whose gradient is float
    noise (a dense unit alive over the whole batch, ahead of BatchNorm) by
    the learning rate either way, and a unit near its ReLU edge then reads
    BatchNorm's 1/sigma."""
    from orcai_tpu_torch.io.msgpack_lite import unpackb

    data = _write_data(tmp_path / "data")
    param = {**PARAM, "seed": 7}
    runs = {}
    with torch.backends.mkldnn.flags(enabled=False):
        for name, device in (("one", "cpu"), ("two", ["cpu", "cpu"])):
            hpsearch.hyperparameter_search(data, tmp_path / name, orcai_parameter=param,
                                           hps_parameter=HPS, max_epochs=2, factor=2,
                                           device=device)
            runs[name] = tmp_path / name / "hps_logs"
    assert capsys.readouterr().out.count("data-parallel over 2 devices") == 5  # every rung-trial
    one, two = runs["one"], runs["two"]
    assert (two / "best_hyperparameters.json").read_bytes() == \
        (one / "best_hyperparameters.json").read_bytes()
    names = sorted(p.name for p in (one / "mp").glob("trial_*.json"))
    assert names == sorted(p.name for p in (two / "mp").glob("trial_*.json")) and names
    for name in names:
        r1, r2 = read_json(one / "mp" / name), read_json(two / "mp" / name)
        h1, h2 = r1.pop("history"), r2.pop("history")
        for key in ("loss", "val_loss"):
            np.testing.assert_allclose(h2.pop(key), h1.pop(key), rtol=SEARCH_LOSS_RTOL,
                                       atol=0, err_msg=name)
        np.testing.assert_allclose(r2.pop("val_loss"), r1.pop("val_loss"),
                                   rtol=SEARCH_LOSS_RTOL, atol=0, err_msg=name)
        # an epoch's 64 training labels: the drift flips a label or two
        np.testing.assert_allclose(h2.pop("MBA"), h1.pop("MBA"), rtol=0, atol=2 / 64,
                                   err_msg=name)
        assert h2 == h1 and r2 == r1, name
        w1, w2 = (_leaves(unpackb((run / "mp" / name.replace(".json", ".msgpack")).read_bytes()))
                  for run in (one, two))
        assert w1.keys() == w2.keys()
        num = sum(float(((w2[k] - w1[k]) ** 2).sum()) for k in w1)
        den = sum(float((w1[k] ** 2).sum()) for k in w1)
        assert (num / den) ** 0.5 <= SEARCH_WEIGHTS_BAR, name
    assert not list((two / "mp").glob(".rendezvous-*"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree, dtype=np.float64)}
