"""The port's hyperparameter search (orcai_tpu_torch/train/hpsearch.py)
against the JAX package's on the CPU, at the reference tests' size (input
32 x 21 x 1, 16 snippets, tests/test_hpsearch.py:14-43): the schedule and
the sampled configs; a search whose `fit` is scripted in both packages
(trial ids, promotions, carried epochs, records, all_trials.csv and
best_hyperparameters.json text-equal); the trial store's weights as flax
bytes; each package resuming a store the other wrote with every trial
CACHED; the carried weights' forward in both packages; a seedless and a cut
search resumed; `parallel` over one and over two devices; `_apply_config`'s
refusals; and the `hpsearch` command."""

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orcai_tpu.io.dataset import ArrayDataset as JaxArrayDataset
from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.train import hpsearch as jax_hpsearch
from orcai_tpu.train.trainer import Trainer as JaxTrainer
from orcai_tpu.train.trainer import make_optimizer as jax_make_optimizer
from orcai_tpu.train.trainer import variables_from_bytes as jax_variables_from_bytes
from orcai_tpu.utils import Messenger
from orcai_tpu_torch.__main__ import main as cli_main
from orcai_tpu_torch.io.jsonio import read_json
from orcai_tpu_torch.io.model_store import load_orcai_model, to_flax_variables
from orcai_tpu_torch.io.msgpack_lite import unpackb
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.resources import DEFAULT_HPS_PARAMETER
from orcai_tpu_torch.train import hpsearch
from orcai_tpu_torch.train.trainer import state_dict_from_flax
from orcai_tpu_torch.utils.device import exact_f32_math

INPUT_SHAPE = (32, 21, 1)
N_SNIPPETS = 16

PARAM = {
    "name": "hps-test",
    "architecture": "ResNetLSTM",
    "model": {
        "epochs": 2,
        "batch_size": 8,
        "filters": [2, 3, 4, 5],
        "kernel_size": 3,
        "dropout_rate": 0.1,
        "lstm_units": 4,
        "learning_rate": 1e-2,
        "ReduceLROnPlateau_patience": 3,
        "ReduceLROnPlateau_factor": 0.5,
        "ReduceLROnPlateau_min_learning_rate": 1e-7,
        "monitor": "val_MBA",
    },
    "calls": ["A", "B"],
    "seed": 7,
}

HPS = {
    "filters": {"tiny": [2, 3, 4, 5], "small": [3, 4, 5, 6]},
    "lstm_units": [4],
    "dropout_rate": [0.1],
    "kernel_size": [3],
    "batch_size": [8],
}

# a wider grid for the scripted searches: 8 configs, so max_epochs 4 and
# factor 2 (14 rung-trials, 3 brackets) sample without exhausting it
HPS_WIDE = {**HPS, "kernel_size": [3, 5], "dropout_rate": [0.1, 0.2]}

SEARCH = {"max_epochs": 2, "factor": 2}  # 2 brackets, 5 rung-trials, 1 promotion


def setup_module():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_onednn():
    # torch 2.13's oneDNN convolution backward corrupts the heap at these
    # widths on the CPU (ROADMAP C); the card uses cuDNN
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _write_data(path: Path, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(N_SNIPPETS, *INPUT_SHAPE)).astype(np.float32)
    y = rng.integers(0, 2, size=(N_SNIPPETS, 2, 2)).astype(np.float32)

    class Loader:
        def __len__(self):
            return len(x)

        def __iter__(self):
            return iter(zip(x, y))

    path.mkdir(parents=True, exist_ok=True)
    for split in ("train", "val"):
        JaxArrayDataset.save_from_loader(Loader(), path / f"{split}_dataset", compression=None)
    (path / "dataset_shapes.json").write_text(
        json.dumps({"spectrogram": list(INPUT_SHAPE), "labels": [2, 2]}))
    return path


def _jax_search(data, out, param=PARAM, hps=HPS, **kwargs):
    jax_hpsearch.hyperparameter_search(
        data, out, orcai_parameter=param, hps_parameter=hps,
        msgr=Messenger(verbosity=0), verbosity=0, **{**SEARCH, **kwargs})


def _port_search(data, out, param=PARAM, hps=HPS, **kwargs):
    hpsearch.hyperparameter_search(data, out, orcai_parameter=param, hps_parameter=hps,
                                   device="cpu", **{**SEARCH, **kwargs})


def _logs(out: Path, name: str = PARAM["name"]) -> dict[str, bytes]:
    """The search's text outputs and trial records, by file name."""
    logs = out / "hps_logs"
    files = {p.name: p.read_bytes() for p in (logs / name).glob("trial_*.json")}
    for name in ("all_trials.csv", "best_hyperparameters.json"):
        files[name] = (logs / name).read_bytes()
    return files


def _statuses(out: Path) -> list[str]:
    lines = (out / "hps_logs" / "all_trials.csv").read_text().splitlines()
    column = lines[0].split(",").index("status")
    return [line.split(",")[column] for line in lines[1:]]


def _as_cached(csv: bytes) -> bytes:
    return csv.replace(b",COMPLETED\n", b",CACHED\n")


# -- the schedule and the sampled configs --------------------------------------


@pytest.mark.parametrize("max_epochs, factor", [(10, 3), (4, 2), (2, 2)])
def test_schedule_and_sampled_configs_match_the_reference(max_epochs, factor):
    brackets = hpsearch.hyperband_schedule(max_epochs, factor)
    assert brackets == jax_hpsearch.hyperband_schedule(max_epochs, factor)
    space = read_json(DEFAULT_HPS_PARAMETER)
    ours, ref = np.random.default_rng([13, 7]), np.random.default_rng([13, 7])
    for rungs in brackets:
        n0 = rungs[0][0]
        got = hpsearch.sample_configs(space, n0, ours)
        assert got == jax_hpsearch.sample_configs(space, n0, ref)
        assert len({tuple(c.items()) for c in got}) == n0
    # a grid smaller than the request gives each config once
    assert hpsearch.sample_configs(HPS, 10, np.random.default_rng(0)) == \
        jax_hpsearch.sample_configs(HPS, 10, np.random.default_rng(0))


# -- a scripted search in both packages ------------------------------------------


def _scripted_value(cfg: dict, epoch: int) -> float:
    """val_MBA of a config after `epoch` + 1 epochs, the same in both packages."""
    rank = (0.07 * ["tiny", "small"].index(cfg["filters"]) + 0.031 * cfg["kernel_size"]
            - 0.4 * cfg["dropout_rate"])
    return 0.5 + rank + 0.01 * (epoch + 1) * (1 + cfg["kernel_size"] % 3)


def _scripted(module, monkeypatch, calls: list):
    """Replace `module`'s fit by the scripted history of the config last
    given to its _apply_config; `calls` records what each fit was given."""
    configs = []
    real_apply = module._apply_config

    def apply_config(orcai_parameter, hps_parameter, cfg):
        configs.append(dict(cfg))
        return real_apply(orcai_parameter, hps_parameter, cfg)

    def fit(trainer, state, run_train, run_val, epochs, initial_epoch=0, initial_history=None,
            initial_counters=None, initial_lr=None, **kwargs):
        cfg = configs[-1]
        carried = kwargs.get("initial_best_state_bytes", kwargs.get("initial_best_state"))
        calls.append({"cfg": cfg, "epochs": epochs, "initial_epoch": initial_epoch,
                      "carried_history": initial_history, "carried_weights": carried is not None,
                      "counters": initial_counters, "lr": initial_lr})
        history = {k: list(v) for k, v in (initial_history or {}).items()}
        for e in range(initial_epoch, epochs):
            value = _scripted_value(cfg, e)
            for key, v in (("loss", 1.0 - value), ("MBA", value - 0.05),
                           ("val_loss", 1.1 - value), ("val_MBA", value),
                           ("learning_rate", initial_lr)):
                history.setdefault(key, []).append(v)
        return state, history

    monkeypatch.setattr(module, "_apply_config", apply_config)
    monkeypatch.setattr(module, "fit", fit)


def test_scripted_search_matches_the_reference(tmp_path, monkeypatch):
    data = _write_data(tmp_path / "data")
    # the JAX trainer compiles its init once for each model object; trials
    # of one shape start from the same weights, so one init a shape serves
    inits, real_init = {}, JaxTrainer.init_state

    def init_once(self, input_shape, seed=0):
        m = self.model
        key = (m.filters, m.kernel_size, m.lstm_units, tuple(input_shape), seed)
        if key not in inits:
            inits[key] = real_init(self, input_shape, seed=seed)
        return inits[key]

    monkeypatch.setattr(JaxTrainer, "init_state", init_once)
    port_calls, jax_calls = [], []
    _scripted(hpsearch, monkeypatch, port_calls)
    _scripted(jax_hpsearch, monkeypatch, jax_calls)
    _port_search(data, tmp_path / "port", hps=HPS_WIDE, max_epochs=4, factor=2)
    _jax_search(data, tmp_path / "jax", hps=HPS_WIDE, max_epochs=4, factor=2)

    assert port_calls == jax_calls
    assert len(port_calls) == 14
    promoted = [c for c in port_calls if c["carried_weights"]]
    assert [c["initial_epoch"] for c in promoted] == [1, 1, 2, 2]
    assert all(c["counters"] == {"stale_early": 0, "stale_lr": 0} for c in port_calls)
    ours, ref = _logs(tmp_path / "port"), _logs(tmp_path / "jax")
    assert sorted(ours) == sorted(ref)
    assert len([n for n in ours if n.startswith("trial_")]) == 14
    for name, text in ref.items():
        assert ours[name] == text, name
    for name in ("orcai_parameter.json", "model_shape.json"):
        assert (tmp_path / "port" / "hps-test" / "hps" / name).read_bytes() == \
            (tmp_path / "jax" / "hps-test" / "hps" / name).read_bytes()


def test_trials_table_writes_as_pandas_does(tmp_path):
    import pandas as pd

    records = [
        {"filters": "set1", "kernel_size": 3, "dropout_rate": 0.3, "score": 0.5,
         "flag": True, "mixed": 1, "sparse": 2, "status": "COMPLETED"},
        {"filters": "set2", "kernel_size": 7, "dropout_rate": 0.5, "score": 1.0 / 3.0,
         "flag": False, "mixed": 2.5, "status": "CACHED", "late": "x"},
    ]
    hpsearch.trials_table(records).to_csv(tmp_path / "ours.csv", index=False)
    pd.DataFrame(records).to_csv(tmp_path / "ref.csv", index=False)
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "ref.csv").read_text()


# -- the trial store across the packages -----------------------------------------


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """A search the JAX package ran, trained for real."""
    root = tmp_path_factory.mktemp("jax_store")
    data = _write_data(root / "data")
    _jax_search(data, root / "out")
    return data, root / "out"


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    """A search the port ran, trained for real."""
    root = tmp_path_factory.mktemp("port_store")
    data = _write_data(root / "data")
    with torch.backends.mkldnn.flags(enabled=False):
        _port_search(data, root / "out")
    return data, root / "out"


def test_the_port_resumes_a_jax_store(jax_store, tmp_path):
    data, written = jax_store
    out = tmp_path / "out"
    shutil.copytree(written, out)
    ref = _logs(written)
    calls = []
    _port_search(data, out, on_epoch_end=lambda *a: calls.append(a[0]))
    assert calls == [] and set(_statuses(out)) == {"CACHED"} and len(_statuses(out)) == 5
    ours = _logs(out)
    assert ours["all_trials.csv"] == _as_cached(ref["all_trials.csv"])
    assert ours["best_hyperparameters.json"] == ref["best_hyperparameters.json"]
    for name in ref:
        if name.startswith("trial_"):
            assert ours[name] == ref[name]
    # the best model the port writes from the JAX weights is the JAX package's
    for name in ("hps-test.msgpack", "orcai_parameter.json", "model_shape.json"):
        assert (out / "hps-test" / "hps" / name).read_bytes() == \
            (written / "hps-test" / "hps" / name).read_bytes(), name
    model, param, shape = load_orcai_model(out / "hps-test" / "hps", device="cpu")
    assert shape["input_shape"] == list(INPUT_SHAPE)


def test_carried_weights_give_the_jax_forward(jax_store):
    """The promoted trial's weights (trained in the JAX package from the
    weights its first rung carried) in the port's model: the forward of the
    JAX model within 2e-5."""
    import flax.serialization

    data, written = jax_store
    store = hpsearch.TrialStore(written / "hps_logs" / "hps-test")
    record = store.load("b0r1t002")
    assert record["epochs"] == 2 and len(record["history"]["val_MBA"]) == 2
    raw = store.load_weights("b0r1t002")
    cfg = {k: record[k] for k in ("filters", "kernel_size", "dropout_rate", "batch_size",
                                  "lstm_units")}
    param = hpsearch._apply_config(PARAM, HPS, cfg)
    x = np.random.default_rng(5).uniform(size=(4, *INPUT_SHAPE)).astype(np.float32)

    variables = flax.serialization.msgpack_restore(raw)
    want = np.asarray(jax_build_model(param).apply(variables, jnp.asarray(x), train=False))

    model = build_model(param, INPUT_SHAPE)
    model.load_state_dict(state_dict_from_flax(unpackb(raw)))
    with exact_f32_math(), torch.no_grad():
        got = model.eval()(torch.from_numpy(x), train=False).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_jax_resumes_a_port_store(port_store, tmp_path):
    data, written = port_store
    out = tmp_path / "out"
    shutil.copytree(written, out)
    ref = _logs(written)
    assert set(_statuses(written)) == {"COMPLETED"} and len(_statuses(written)) == 5
    _jax_search(data, out)
    assert set(_statuses(out)) == {"CACHED"}
    theirs = _logs(out)
    assert theirs["all_trials.csv"] == _as_cached(ref["all_trials.csv"])
    assert theirs["best_hyperparameters.json"] == ref["best_hyperparameters.json"]
    for name in ("hps-test.msgpack", "orcai_parameter.json", "model_shape.json"):
        assert (out / "hps-test" / "hps" / name).read_bytes() == \
            (written / "hps-test" / "hps" / name).read_bytes(), name


def test_trial_weights_are_flax_bytes(port_store):
    """Each trial's .msgpack is flax.serialization.to_bytes of its variables,
    and the JAX package restores it against its own model's template."""
    import flax.serialization

    _, written = port_store
    store = hpsearch.TrialStore(written / "hps_logs" / "hps-test")
    trials = sorted(p.stem[len("trial_"):] for p in store.directory.glob("trial_*.json"))
    assert len(trials) == 5
    templates = {}
    for trial_id in trials:
        raw = store.load_weights(trial_id)
        record = store.load(trial_id)
        param = hpsearch._apply_config(PARAM, HPS, {k: record[k] for k in (
            "filters", "kernel_size", "dropout_rate", "batch_size", "lstm_units")})
        model = build_model(param, INPUT_SHAPE)
        model.load_state_dict(state_dict_from_flax(unpackb(raw)))
        assert raw == flax.serialization.to_bytes(to_flax_variables(model.state_dict()))
        if record["filters"] not in templates:  # one JAX init a shape
            jtrainer = JaxTrainer(jax_build_model(param), jax_make_optimizer(1e-2))
            templates[record["filters"]] = jtrainer.init_state(INPUT_SHAPE, seed=0)
        restored = jax_variables_from_bytes(templates[record["filters"]], raw)
        assert flax.serialization.to_bytes(restored) == raw


# -- resuming the port's own searches --------------------------------------------


def test_seedless_search_persists_its_seed_and_resumes(tmp_path):
    data = _write_data(tmp_path / "data", seed=3)
    out = tmp_path / "out"
    param = {**PARAM, "name": "hps-seedless", "seed": None}
    _port_search(data, out, param=param)
    seed_file = out / "hps_logs" / "hps-seedless" / "search_seed.json"
    seed = json.loads(seed_file.read_text())["seed"]
    assert isinstance(seed, int) and 0 <= seed < 2**63
    first = _logs(out, "hps-seedless")
    assert set(_statuses(out)) == {"COMPLETED"}
    calls = []
    _port_search(data, out, param=param, on_epoch_end=lambda *a: calls.append(a[0]))
    assert calls == [] and set(_statuses(out)) == {"CACHED"}
    again = _logs(out, "hps-seedless")
    assert again["all_trials.csv"] == _as_cached(first["all_trials.csv"])
    assert again["best_hyperparameters.json"] == first["best_hyperparameters.json"]
    assert json.loads(seed_file.read_text())["seed"] == seed


class _Cut(Exception):
    pass


def test_a_search_cut_after_its_first_bracket_repeats_no_trial(tmp_path):
    data = _write_data(tmp_path / "data")
    out = tmp_path / "out"
    first = []

    def cut_in_bracket_1(trial_id, *args):
        first.append(trial_id)
        if trial_id.startswith("b1"):
            raise _Cut

    with pytest.raises(_Cut):
        _port_search(data, out, on_epoch_end=cut_in_bracket_1)
    done = {p.stem[len("trial_"):] for p in (out / "hps_logs" / "hps-test").glob("trial_*.json")}
    assert done == {"b0r0t000", "b0r0t001", "b0r1t002"}
    second = []
    _port_search(data, out, on_epoch_end=lambda trial_id, *a: second.append(trial_id))
    assert set(second) == {"b1r0t003", "b1r0t004"}
    assert _statuses(out) == ["CACHED"] * 3 + ["COMPLETED"] * 2

    uncut = tmp_path / "uncut"
    _port_search(data, uncut)
    assert (out / "hps_logs" / "all_trials.csv").read_bytes() == \
        (uncut / "hps_logs" / "all_trials.csv").read_bytes().replace(
            b",COMPLETED\n", b",CACHED\n", 3)


def test_datasets_over_the_device_budget_stream_to_the_same_search(tmp_path, monkeypatch):
    """Past ORCAI_TPU_DEVICE_DATASET_BYTES the trials upload batch by batch;
    the batches, and so the search, are the resident one's."""
    data = _write_data(tmp_path / "data")
    _port_search(data, tmp_path / "resident")
    uploads = []
    real_device_data = hpsearch.DeviceData
    monkeypatch.setattr(hpsearch, "DeviceData",
                        lambda *a, **k: uploads.append(1) or real_device_data(*a, **k))
    monkeypatch.setenv("ORCAI_TPU_DEVICE_DATASET_BYTES", "1")
    _port_search(data, tmp_path / "streamed")
    assert uploads == []
    assert _logs(tmp_path / "streamed") == _logs(tmp_path / "resident")


# -- parallel ----------------------------------------------------------------------


def test_parallel_with_one_device_warns_and_runs_in_sequence(tmp_path, capsys):
    data = _write_data(tmp_path / "data")
    _port_search(data, tmp_path / "seq")
    capsys.readouterr()
    _port_search(data, tmp_path / "par", parallel=True)
    assert "‼️ --parallel requested but only one device is visible" in capsys.readouterr().out
    assert _logs(tmp_path / "par") == _logs(tmp_path / "seq")


def test_parallel_over_two_devices_gives_the_sequential_search(tmp_path, monkeypatch):
    data = _write_data(tmp_path / "data")
    _port_search(data, tmp_path / "seq")
    threads, uploads = set(), []
    real_device_data = hpsearch.DeviceData

    def device_data(ds, device="cuda"):
        uploads.append(str(device))
        return real_device_data(ds, device=device)

    monkeypatch.setattr(hpsearch, "local_devices",
                        lambda device: [torch.device("cpu"), torch.device("cpu")])
    monkeypatch.setattr(hpsearch, "DeviceData", device_data)
    _port_search(data, tmp_path / "par", parallel=True,
                 on_epoch_end=lambda trial_id, *a: threads.add(
                     (trial_id, threading.get_ident())))
    ran_on = dict(threads)
    # each rung of two trials ran them in two threads
    assert ran_on["b0r0t000"] != ran_on["b0r0t001"]
    assert ran_on["b1r0t003"] != ran_on["b1r0t004"]
    assert uploads == ["cpu"] * 4  # train and val, once for each device
    assert _logs(tmp_path / "par") == _logs(tmp_path / "seq")
    for p in (tmp_path / "seq" / "hps_logs" / "hps-test").glob("trial_*.msgpack"):
        assert (tmp_path / "par" / "hps_logs" / "hps-test" / p.name).read_bytes() == \
            p.read_bytes()


# -- _apply_config and the command ------------------------------------------------


@pytest.mark.parametrize("case", ["lstm_in_both", "lstm_only_in_config",
                                  "lstm_only_in_model"])
def test_apply_config_raises_where_the_reference_raises(case):
    cfg = {"filters": "small", "kernel_size": 5, "dropout_rate": 0.2, "batch_size": 8,
           "lstm_units": 4}
    param = PARAM
    if case == "lstm_only_in_config":
        param = {**PARAM, "architecture": "ResNet1DConv",
                 "model": {k: v for k, v in PARAM["model"].items() if k != "lstm_units"}}
    elif case == "lstm_only_in_model":
        cfg = {k: v for k, v in cfg.items() if k != "lstm_units"}
    try:
        want = jax_hpsearch._apply_config(param, HPS, cfg)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(".")[0]):
            hpsearch._apply_config(param, HPS, cfg)
        assert case != "lstm_in_both"
    else:
        assert hpsearch._apply_config(param, HPS, cfg) == want
        assert want["model"]["filters"] == [3, 4, 5, 6] and PARAM["model"]["kernel_size"] == 3


def test_hpsearch_command_runs_on_the_cpu_when_told(tmp_path):
    data = _write_data(tmp_path / "data")
    (tmp_path / "param.json").write_text(json.dumps(PARAM))
    (tmp_path / "hps.json").write_text(json.dumps({**HPS, "filters": {"tiny": [2, 3, 4, 5]}}))
    args = ["hpsearch", str(data), str(tmp_path / "out"), "-p", str(tmp_path / "param.json"),
            "-hp", str(tmp_path / "hps.json"), "-dc", "None", "-v", "0"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            cli_main(args)
    assert cli_main(args + ["--device", "cpu"]) == 0
    best = read_json(tmp_path / "out" / "hps_logs" / "best_hyperparameters.json")
    assert best["filters"] == "tiny"
    # the default search: 10 epochs, factor 3, so 3 brackets; one config in the grid
    assert len(_statuses(tmp_path / "out")) == 6
    assert (tmp_path / "out" / "hps-test" / "hps" / "hps-test.msgpack").exists()


def test_profile_first_epoch_stops_without_a_card(tmp_path, capsys):
    """tools/profile_first_epoch.py times the card only: without one it
    exits 2 instead of timing the CPU."""
    from orcai_tpu_torch.tools import profile_first_epoch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert profile_first_epoch.main([str(tmp_path)]) == 2
    assert "is_available() is False" in capsys.readouterr().err
