"""The port's parallel/ (orcai_tpu_torch/parallel) against the JAX
package's on the CPU: the partitions, the mesh helpers, the window split of
WindowPredictor against the reference's sharded predictor on its 8-device
CPU mesh (tests/test_overlap.py:154), golden through the split in memory and
streamed, the forward-only split of `test`, and data-parallel training over
two gloo processes against one process at the same global batch: one
step's gradients, BatchNorm statistics, dropout masks and the masked loss's
global denominator, `train` end to end through the port's own launcher and
through a launcher's environment, and an epoch against the reference's
Trainer on its mesh_for_batch mesh. Each distributed check runs in spawned
worker processes; a single-process cluster takes one all-reduce over the
hybrid mesh (tests/test_distributed.py:51)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from orcai_tpu.io.dataset import ArrayDataset as JaxArrayDataset
from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.ops.overlap import WindowPredictor as JaxWindowPredictor
from orcai_tpu.parallel import mesh as jax_mesh
from orcai_tpu.parallel.distributed import process_partition as jax_process_partition
from orcai_tpu.train import hpsearch as jax_hpsearch
from orcai_tpu.train import trainer as jax_trainer
from orcai_tpu_torch.io.dataset import ArrayDataset
from orcai_tpu_torch.io.jsonio import read_json
from orcai_tpu_torch.io.model_store import DEFAULT_MODEL_DIR, convert_flax_variables, load_orcai_model
from orcai_tpu_torch.io.wav import load_wav_for_frontend
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.models.layers import BatchNorm
from orcai_tpu_torch.ops.losses import weighted_masked_bce_from_logits
from orcai_tpu_torch.ops.overlap import WindowPredictor
from orcai_tpu_torch.ops.streaming import StreamingPredictor
from orcai_tpu_torch.parallel import distributed, mesh
from orcai_tpu_torch.parallel.distributed import launch, process_partition
from orcai_tpu_torch.parallel.mesh import Replicas, block_bounds, local_devices, mesh_for_batch
from orcai_tpu_torch.pipeline.predict import _finish_wav, build_predictor, predict, save_predictions
from orcai_tpu_torch.train import hpsearch
from orcai_tpu_torch.train.evaluate import test_model
from orcai_tpu_torch.train.trainer import Trainer, device_runners, train
from orcai_tpu_torch.models import l2_regularization
from orcai_tpu_torch.utils.seeds import MASK_VALUE

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
INPUT_SHAPE = (32, 21, 1)
TWO_CPUS = ["cpu", "cpu"]

PARAM = {
    "name": "dp-test",
    "architecture": "ResNetLSTM",
    "model": {
        "epochs": 2,
        "batch_size": 8,
        "filters": [2, 3, 4, 5],
        "kernel_size": 3,
        "dropout_rate": 0.3,
        "lstm_units": 4,
        "learning_rate": 1e-2,
        "EarlyStopping_patience": 10,
        "ReduceLROnPlateau_patience": 3,
        "ReduceLROnPlateau_factor": 0.5,
        "ReduceLROnPlateau_min_learning_rate": 1e-7,
        "call_weights": None,
        "monitor": "val_MBA",
    },
    "calls": ["A", "B"],
    "seed": 42,
}
ARCHS = ["ResNetLSTM", "ResNet1DConv", "ResNetTCN"]
GRAD_BAR = 2e-5  # of the largest gradient: the port's bar against jax.grad
#                  (tests/test_torch_trainer.py); read up to 1.4e-5 here, the
#                  float32 BatchNorm backward summing in another order
HISTORY_RTOL = 1e-6  # per-epoch loss, two processes against one (read 3e-7)
WEIGHTS_BAR = 1e-4  # of each tensor's largest value after 8 Adam steps (read
#                     1.4e-5: Adam's first steps move every weight by about the
#                     learning rate whatever its gradient's size, so an element
#                     whose gradient is near float noise moves either way)


def setup_module():
    torch.set_num_threads(1)


def _param(arch="ResNetLSTM", **model):
    return {**PARAM, "architecture": arch, "model": {**PARAM["model"], **model}}


def _synthetic(n, seed=0, masked=0.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, *INPUT_SHAPE)).astype(np.float32)
    y = rng.integers(0, 2, size=(n, 2, 2)).astype(np.float32)
    y[rng.uniform(size=y.shape) < masked] = MASK_VALUE
    return x, y


def _write_tvt(path, n=32, masked=0.3):
    x, y = _synthetic(n, masked=masked)

    class Loader:
        def __len__(self):
            return len(x)

        def __iter__(self):
            return iter(zip(x, y))

    path.mkdir(parents=True, exist_ok=True)
    for split in ("train", "val", "test"):
        ArrayDataset.save_from_loader(Loader(), path / f"{split}_dataset")
    (path / "dataset_shapes.json").write_text(
        json.dumps({"spectrogram": list(INPUT_SHAPE), "labels": [2, 2]}))
    return path


def _near_init(param, seed=0):
    """flax's initial kernels, the other leaves a little off their initial
    values (as tests/test_torch_trainer.py draws them)."""
    jmodel = jax_build_model(param)
    template = jmodel.init(jax.random.key(seed + 1), jnp.zeros((1, *INPUT_SHAPE)))
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf, np.float32)
        if "kernel" in name:
            return leaf
        if "var" in name or "scale" in name:
            return (leaf * rng.uniform(0.8, 1.25, leaf.shape)).astype(np.float32)
        return (leaf + 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jmodel, jax.tree_util.tree_map_with_path(move, template)


def _max_rel(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b)


# -- partitions and the mesh ------------------------------------------------------


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_partitions_and_device_ranks_equal_the_jax_package(count):
    for n in (0, 1, 5, 8, 16):
        shares = []
        for pid in range(count):
            mine = process_partition(n, pid, count)
            assert mine == jax_process_partition(n, pid, count)
            # the search splits a rung's trials with process_partition itself
            assert jax_hpsearch.process_trial_partition(n, pid, count) == mine
            assert hpsearch.local_device_ranks(mine) == jax_hpsearch.local_device_ranks(mine)
            shares.append(mine)
        assert sorted(i for s in shares for i in s) == list(range(n))
    assert process_partition(5) == list(range(5))  # no group: everything


def test_shard_table_for_process_picks_the_jax_package_s_rows(monkeypatch):
    import pandas as pd

    from orcai_tpu.parallel.distributed import shard_table_for_process as jax_shard
    from orcai_tpu.utils import Messenger
    from orcai_tpu_torch.io.tables import Table, object_column

    names = [f"r{i}" for i in range(5)]
    table = Table(None, {"recording": object_column(names), "channel": np.arange(5)})
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    want = list(jax_shard(pd.DataFrame({"recording": names}), Messenger(verbosity=0))["recording"])
    assert want == ["r1", "r3"]
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    part = distributed.shard_table_for_process(table)
    assert list(part["recording"]) == want and list(part["channel"]) == [1, 3]
    rows = [{"recording": r} for r in names]
    assert [r["recording"] for r in distributed.shard_table_for_process(rows)] == want
    monkeypatch.setattr(distributed, "process_count", lambda: 1)
    assert distributed.shard_table_for_process(table) is table
    assert distributed.shard_table_for_process(rows) is rows


def test_mesh_helpers_follow_the_jax_package():
    cpus = [torch.device("cpu")] * 8
    for batch in (1, 2, 6, 7, 8, 12, 128):
        for n in (1, 2, 3, 4, 8):
            want = jax_mesh.mesh_for_batch(batch, devices=jax.devices()[:n]).shape["data"]
            assert len(mesh_for_batch(batch, cpus[:n])) == want
            jm = jax_mesh.make_mesh(n_data=n)
            assert mesh.shard_batch_size(batch, cpus[:n]) == jax_mesh.shard_batch_size(batch, jm)
    for n in (0, 1, 7, 8, 13):
        for parts in (1, 2, 3, 8):
            blocks = np.array_split(np.arange(n), parts)
            for i, b in enumerate(blocks):
                lo, hi = block_bounds(n, parts, i)
                assert list(range(lo, hi)) == list(b)
    assert mesh.make_mesh(devices=TWO_CPUS) == [torch.device("cpu")] * 2
    assert local_devices("cpu") == [torch.device("cpu")]
    assert local_devices(TWO_CPUS) == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError):
        local_devices("cuda")  # no CUDA here: never a quiet fallback


# -- the window split --------------------------------------------------------------

WP = {
    "name": "tiny",
    "architecture": "ResNetLSTM",
    "model": {"filters": [4, 6, 8, 10], "kernel_size": 3, "dropout_rate": 0.5,
              "lstm_units": 8},
    "calls": ["A", "B", "C"],
}
SNIPPET, NBINS = 64, 21


@pytest.fixture(scope="module")
def window_models():
    jmodel = jax_build_model(WP)
    template = jmodel.init(jax.random.key(0), jnp.zeros((1, SNIPPET, NBINS, 1)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        if "var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, template)
    model = build_model(WP, (SNIPPET, NBINS, 1))
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return jmodel, variables, model.eval()


@pytest.mark.parametrize("t", [200, 1024])
def test_window_split_matches_the_jax_sharded_predictor(window_models, t):
    """The port over ["cpu", "cpu"] against the reference's predictor sharded
    over its 8-device CPU mesh: counts and binary output equal, aggregate
    within 1e-6 (the reference's own bar for its split)."""
    jmodel, variables, model = window_models
    spec = np.random.default_rng(3).uniform(size=(t, NBINS)).astype(np.float32)
    sharded = JaxWindowPredictor(
        jmodel, variables, snippet_len=SNIPPET, n_filters=4, batch_size=4,
        max_windows_per_chunk=16, mesh=jax_mesh.make_mesh(n_data=len(jax.devices())))
    want_agg, want_cnt = sharded.aggregate(spec)
    single = WindowPredictor(model, snippet_len=SNIPPET, n_filters=4, batch_size=4,
                             max_windows_per_chunk=16)
    split = WindowPredictor(model, snippet_len=SNIPPET, n_filters=4, batch_size=4,
                            max_windows_per_chunk=16, devices=TWO_CPUS)
    assert split.replicas is not None and len(split.replicas) == 2
    agg, cnt = split.aggregate(spec)
    np.testing.assert_array_equal(cnt, want_cnt)
    np.testing.assert_allclose(agg, want_agg, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(split.binary_predictions(agg, cnt),
                                  sharded.binary_predictions(want_agg, want_cnt))
    one_agg, one_cnt = single.aggregate(spec)
    np.testing.assert_array_equal(cnt, one_cnt)
    np.testing.assert_allclose(agg, one_agg, atol=1e-6, rtol=0)


def test_window_split_rounds_the_batch_and_turns_the_dense_trunk_off(window_models):
    _, _, model = window_models
    three = WindowPredictor(model, snippet_len=SNIPPET, n_filters=4, batch_size=4,
                            dense_trunk=True, devices=["cpu"] * 3)
    assert three.batch_size == 6 and not three.dense_trunk
    assert WindowPredictor(model, snippet_len=SNIPPET, n_filters=4, dense_trunk=True,
                           devices=["cpu"]).dense_trunk


def test_replicas_gather_ragged_blocks_on_the_first_device(window_models):
    _, _, model = window_models
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(7, SNIPPET, NBINS, 1)).astype(np.float32))
    replicas = Replicas(model, ["cpu"] * 3)
    assert replicas.models[0] is model and replicas.models[1] is not model
    with torch.no_grad():
        want = model(x)
        got = replicas(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_golden_through_the_split_in_memory_and_streamed(tmp_path):
    """build_predictor over two devices: golden byte-equal in memory (the
    pipeline end to end) and through the streaming path's small tiles."""
    golden = (FIXTURES / "golden_expected.txt").read_bytes()
    predictor, param, _ = build_predictor(DEFAULT_MODEL_DIR, 16, TWO_CPUS)
    assert len(predictor.replicas) == 2
    out = predict(FIXTURES / "golden.wav", output_path=tmp_path / "g.txt",
                  predictor=predictor, device="cpu")
    assert out.read_bytes() == golden
    audio, _ = load_wav_for_frontend(FIXTURES / "golden.wav", sr=48000)
    streaming = StreamingPredictor(predictor, param["spectrogram"],
                                   stats_tile_frames=4096, windows_per_chunk=16)
    aggregated, count = streaming.aggregate(audio)
    disp = {"mode": "host", "agg": aggregated, "count": count,
            "delta_t": 256 / 48000, "est_bytes": 0}
    labels, _, delta_t = _finish_wav(disp, predictor, param)
    save_predictions(labels, tmp_path / "s.txt", delta_t)
    assert (tmp_path / "s.txt").read_bytes() == golden


def _train_one(tmp_path, param, device, name):
    out = tmp_path / name
    out.mkdir()
    train(tmp_path / "data", out, orcai_parameter=param, device=device)
    return out / param["name"]


def test_test_model_split_writes_the_one_device_files(tmp_path):
    _write_tvt(tmp_path / "data")
    model_dir = _train_one(tmp_path, _param(epochs=1), "cpu", "one")
    one = test_model(model_dir, tmp_path / "data", output_dir=tmp_path / "t1", device="cpu")
    two = test_model(model_dir, tmp_path / "data", output_dir=tmp_path / "t2", device=TWO_CPUS)
    names = sorted(p.name for p in one.iterdir())
    assert names == sorted(p.name for p in two.iterdir()) and len(names) >= 3
    for name in names:
        if name.endswith(".csv"):
            assert (one / name).read_bytes() == (two / name).read_bytes(), name
    m1, m2 = read_json(one / "test_data_metrics.json"), read_json(two / "test_data_metrics.json")
    assert m1["MBA"] == m2["MBA"]
    assert m2["loss"] == pytest.approx(m1["loss"], rel=1e-6)


# -- data-parallel training -------------------------------------------------------


def _step_worker(param, state, x, y, out, device="cpu"):
    """One forward and backward from `state` on this process's block of
    (x, y): the global loss, the averaged gradients, the BatchNorm running
    statistics after the step, the dropout masks drawn (each process draws
    the global batch's), and the gradients a plain mean of per-process
    means would give. Saved to out.<rank>.npz."""
    distributed_run = dist.is_initialized()
    model = build_model(param, INPUT_SHAPE)
    trainer = Trainer(model, 1e-3, device=device, distributed=distributed_run)
    st = trainer.state_from_variables(state, seed=0)
    rows = trainer.block(np.arange(len(x))[None])[0]
    xb, yb = torch.from_numpy(x[rows]), torch.from_numpy(y[rows])
    masks = []
    real_bernoulli = torch.Tensor.bernoulli_

    def recording(self, *args, **kwargs):
        drawn = real_bernoulli(self, *args, **kwargs)
        masks.append(drawn.clone())
        return drawn

    generator_state = st.generator.get_state()
    torch.Tensor.bernoulli_ = recording
    try:
        logits = trainer._train_forward(xb)
    finally:
        torch.Tensor.bernoulli_ = real_bernoulli
    loss = trainer._loss(logits, yb)
    loss.backward()
    metrics = trainer._metrics(loss, logits, yb)[0]
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    # the mean of per-process means, as a DDP wrap alone would train: the
    # same masks, this block's own denominator
    st.optimizer.zero_grad(set_to_none=True)
    st.generator.set_state(generator_state)
    naive = (weighted_masked_bce_from_logits(trainer._train_forward(xb), yb, None)
             + l2_regularization(model))
    naive.backward()
    naive_grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    if distributed_run:
        dist.all_reduce(metrics)
    np.savez(f"{out}.{trainer.rank}.npz", metrics=metrics.numpy(),
             **{f"grad:{k}": v.numpy() for k, v in grads.items()},
             **{f"naive:{k}": v.numpy() for k, v in naive_grads.items()},
             **{f"stat:{k}": v.numpy() for k, v in stats.items()},
             **{f"mask:{i}": m.numpy() for i, m in enumerate(masks)})


def _split(npz, prefix):
    return {k[len(prefix):]: npz[k] for k in npz.files if k.startswith(prefix)}


@pytest.fixture
def no_onednn():
    # torch 2.13's oneDNN convolution backward can corrupt the heap at small
    # widths on the CPU (ROADMAP C); launch() passes the switch to workers
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.mark.parametrize("arch", ARCHS)
def test_two_processes_take_the_one_process_step(arch, tmp_path, no_onednn):
    """One step at batch 8 split 4 + 4 over two gloo processes against one
    process: the global loss, the gradients (DDP's average), the BatchNorm
    running statistics and the dropout masks of the global batch. The two
    blocks hold different numbers of masked labels (12 of 16 against 2), so
    the masked loss's denominator must be the global count: the mean of
    the per-process means misses the one-process gradients by far more than
    the bar."""
    param = _param(arch)
    _, variables = _near_init(param)
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    x, y = _synthetic(8, seed=4)
    y[:4].reshape(-1)[:12] = MASK_VALUE  # 12 of rank 0's 16 labels
    y[4:].reshape(-1)[:2] = MASK_VALUE  # 2 of rank 1's
    _step_worker(param, state, x, y, tmp_path / "one")
    launch(_step_worker, TWO_CPUS, tmp_path, args=(param, state, x, y, tmp_path / "two"))
    one, two = np.load(tmp_path / "one.0.npz"), np.load(tmp_path / "two.0.npz")
    # the step metrics' bar of tests/test_torch_trainer.py (read 1.1e-6)
    np.testing.assert_allclose(two["metrics"][0], one["metrics"][0], rtol=1e-5)
    np.testing.assert_array_equal(two["metrics"][1:], one["metrics"][1:])
    g1, g2 = _split(one, "grad:"), _split(two, "grad:")
    largest = max(np.abs(g).max() for g in g1.values())
    for k in g1:
        np.testing.assert_allclose(g2[k], g1[k], atol=GRAD_BAR * largest, rtol=0, err_msg=k)
    naive = _split(two, "naive:")
    assert max(np.abs(naive[k] - g1[k]).max() for k in g1) > 100 * GRAD_BAR * largest
    s1, s2 = _split(one, "stat:"), _split(two, "stat:")
    for k in s1:
        np.testing.assert_allclose(s2[k], s1[k], atol=1e-6, rtol=0, err_msg=k)
    m1 = _split(one, "mask:")
    assert len(m1) >= 2
    for rank in range(2):
        m2 = _split(np.load(tmp_path / f"two.{rank}.npz"), "mask:")
        assert m2.keys() == m1.keys()
        for k in m1:
            np.testing.assert_array_equal(m2[k], m1[k], err_msg=f"rank {rank}, mask {k}")


def test_train_over_two_processes_equals_one_process(tmp_path, no_onednn):
    """`train` given two devices starts two processes (launch) and writes
    what one process writes at the same global batch: the same files, the
    history within 1e-6, the weights and statistics within WEIGHTS_BAR; a
    load_model continuation over two processes reads them back."""
    _write_tvt(tmp_path / "data")
    param = _param()
    one = _train_one(tmp_path, param, "cpu", "one")
    two = _train_one(tmp_path, param, TWO_CPUS, "two")
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())
    assert not list((tmp_path / "two").glob(".rendezvous-*"))
    h1, h2 = read_json(one / "training_history.json"), read_json(two / "training_history.json")
    assert h2["MBA"] == h1["MBA"] and h2["val_MBA"] == h1["val_MBA"]
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(h2[key], h1[key], rtol=HISTORY_RTOL, atol=0)
    w1 = {k: v.numpy() for k, v in load_orcai_model(one, device="cpu")[0].state_dict().items()}
    w2 = {k: v.numpy() for k, v in load_orcai_model(two, device="cpu")[0].state_dict().items()}
    assert _max_rel(w2, w1) <= WEIGHTS_BAR
    train(tmp_path / "data", tmp_path / "two", orcai_parameter=param, device=TWO_CPUS,
          load_model=True, max_epochs=1)
    assert len(read_json(two / "training_history.json")["loss"]) == 1
    assert read_json(two / "train_state.json") == {"epochs_run": 1}


def test_train_refuses_a_batch_that_does_not_divide_over_the_group(monkeypatch, tmp_path):
    monkeypatch.setattr("orcai_tpu_torch.train.trainer.process_count", lambda: 3)
    with pytest.raises(ValueError, match="does not divide"):
        train(tmp_path, tmp_path, orcai_parameter=_param(), device="cpu")


def _epoch_worker(param, state, x, y, out, device="cpu"):
    trainer = Trainer(build_model(param, INPUT_SHAPE), 1e-3, device=device,
                      distributed=dist.is_initialized())
    st = trainer.state_from_variables(state, seed=0)
    run_train, run_val = device_runners(trainer, ArrayDataset(x, y), ArrayDataset(x, y),
                                        8, [1, 9], [2, 9])
    st, got = run_train(st, 0)
    got.update(run_val(st, 0))
    if trainer.rank == 0:
        Path(out).write_text(json.dumps(got))


def test_an_epoch_over_two_processes_matches_the_jax_trainer_on_its_mesh(tmp_path, no_onednn):
    """The resident runners of both packages for one epoch from the same
    weights and seeds, dropout 0: the reference's Trainer on
    mesh_for_batch(8) of its 8 CPU devices, the port over two gloo
    processes; the bars of tests/test_torch_trainer.py's one-device
    comparison."""
    param = _param(dropout_rate=0.0)
    jmodel, variables = _near_init(param)
    x, y = _synthetic(16, seed=3, masked=0.2)
    jt = jax_trainer.Trainer(jmodel, jax_trainer.make_optimizer(1e-3),
                             mesh=jax_mesh.mesh_for_batch(8))
    assert jt.mesh.shape["data"] == 8
    jstate = jt.state_from_variables(variables)
    jrun_train, jrun_val = jax_trainer.device_runners(
        jt, JaxArrayDataset(x, y), JaxArrayDataset(x, y), 8, [1, 9], [2, 9])
    jstate, want = jrun_train(jstate, 0)
    want.update(jrun_val(jstate, 0))
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    launch(_epoch_worker, TWO_CPUS, tmp_path, args=(param, state, x, y, tmp_path / "m.json"))
    got = json.loads((tmp_path / "m.json").read_text())
    # the same counts: the reference divides in float32 here (0.58 against
    # 0.5799999833), one count apart would be 1/150
    for key in ("MBA", "val_MBA"):
        assert got[key] == pytest.approx(want[key], abs=1e-7), key
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)
    return env


def test_launcher_environment_runs_the_command_over_two_processes(tmp_path):
    """A launcher's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT: the
    command line joins the group and trains as `train` over two devices
    does (the same history)."""
    _write_tvt(tmp_path / "data")
    param = _param(epochs=1)
    (tmp_path / "param.json").write_text(json.dumps(param))
    port = _free_port()
    code = ("import sys, torch; torch.backends.mkldnn.enabled = False; "
            "torch.set_num_threads(1); from orcai_tpu_torch.__main__ import main; "
            "sys.exit(main(sys.argv[1:]))")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, "train", str(tmp_path / "data"),
             str(tmp_path / "out"), "-p", str(tmp_path / "param.json"), "--device", "cpu",
             "-v", "1"],
            env=_child_env(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost",
                           MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    with torch.backends.mkldnn.flags(enabled=False):
        two = _train_one(tmp_path, param, TWO_CPUS, "two")
    h_cli = read_json(tmp_path / "out" / param["name"] / "training_history.json")
    assert h_cli == read_json(two / "training_history.json")


CLUSTER = r"""
import sys
import torch
import torch.distributed as dist
from orcai_tpu_torch.parallel.distributed import (
    initialize_distributed, make_hybrid_mesh, process_count, process_index)

assert (process_index(), process_count()) == (0, 1)
initialize_distributed(coordinator_address=sys.argv[1], num_processes=1, process_id=0)
assert dist.is_initialized() and (process_index(), process_count()) == (0, 1)
mesh = make_hybrid_mesh()
assert mesh.mesh_dim_names == ("dcn", "data") and tuple(mesh.shape) == (1, 1), mesh
x = torch.arange(4, dtype=torch.float32)
dist.all_reduce(x, group=mesh.get_group("data"))
assert x.tolist() == [0.0, 1.0, 2.0, 3.0], x
print("DISTRIBUTED-OK", dist.get_backend())
# the mesh holds the group: dropped first, destroy_process_group joins the
# gloo and store threads here instead of leaving them to interpreter exit,
# where their teardown can abort the process
del mesh
dist.destroy_process_group()
"""


def test_single_process_cluster_hybrid_mesh_and_an_all_reduce():
    proc = subprocess.run(
        [sys.executable, "-c", CLUSTER, f"localhost:{_free_port()}"],
        env=_child_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DISTRIBUTED-OK gloo" in proc.stdout


def test_initialize_distributed_is_a_no_op_for_one_process(monkeypatch):
    for name in ("WORLD_SIZE", "MASTER_ADDR", "ORCAI_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize_distributed()
    assert not dist.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_distributed()
    assert distributed.launch_backend([torch.device("cpu")] * 2) == "gloo"
    assert distributed.launch_backend([torch.device("cuda", 0)] * 2) == "gloo"
    assert distributed.launch_backend(
        [torch.device("cuda", 0), torch.device("cuda", 1)]) == "cpu:gloo,cuda:nccl"


def test_the_split_probe_on_a_narrow_model(tmp_path, no_onednn):
    """tools/probe_grad_split.py's parts on the narrow ResNetLSTM at 8 rows
    on the CPU (the card runs them on orcai-v1 at 64, chip_smoke.py phase
    parallel): with every row independent the two halves' averaged
    gradients are the whole batch's up to float32 noise and repeat exactly;
    in training mode the plain and the synced BatchNorm (a gloo group of
    one) give gradients within the trainer's bar of each other and of
    float64, and every BatchNorm's synced forward and backward sit within
    float32 noise of F.batch_norm's."""
    from orcai_tpu_torch.models import init_variables
    from orcai_tpu_torch.tools import probe_grad_split as probe

    model = init_variables(build_model(_param(), INPUT_SHAPE), seed=0)
    x, y = (torch.from_numpy(a) for a in _synthetic(8, seed=4, masked=0.2))
    rows = probe.rows_independent(torch, model, x, y)
    assert set(rows["halves_vs_whole"]) == {"trunk_conv", "trunk_bn", "bilstm1", "bilstm2",
                                            "dense", "dense_bn", "out", "all"}
    assert rows["whole_again_vs_whole"]["all"] == 0.0
    assert rows["halves_vs_whole"]["all"] < 1e-5
    assert rows["whole_vs_float64"]["all"] < GRAD_BAR
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        train, reference = probe.train_mode(torch, model, x, y, seed=0)
        layers = probe.synced_batchnorm(torch, model, x, seed=0)
    finally:
        dist.destroy_process_group()
    assert train["library_again_vs_library"]["all"] == 0.0
    for key in ("synced_vs_library", "library_vs_float64", "synced_vs_float64"):
        assert 0.0 < train[key]["all"] < GRAD_BAR, (key, train[key])
    assert sorted(reference) == sorted(n for n, p in model.named_parameters() if p.requires_grad)
    assert layers["layers"] == sum(isinstance(m, BatchNorm) for m in model.modules())
    for reading in layers["synced_vs_library"].values():
        assert reading["rel_norm"] < 1e-5, layers
