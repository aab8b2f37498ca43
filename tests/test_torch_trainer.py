"""The port's trainer (orcai_tpu_torch/train/trainer.py) against the JAX
package on the CPU at the reference tests' sizes (tests/test_train.py:30-66):
gradients of one step against jax.grad of the reference's loss, leaf by leaf
(bar: 2e-5 of the tree's largest gradient), Adam against optax on a shared
gradient sequence (1e-7), the epoch permutations, fit's callback rules on
scripted metric sequences, the resident and streaming runners, resume, and
`train` end to end."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from orcai_tpu.io.dataset import ArrayDataset as JaxArrayDataset
from orcai_tpu.io.dataset import epoch_permutation as jax_epoch_permutation
from orcai_tpu.io.model_store import load_orcai_model as jax_load_orcai_model
from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.models import l2_regularization as jax_l2_regularization
from orcai_tpu.ops.losses import weighted_masked_bce_from_logits as jax_weighted_bce
from orcai_tpu.parallel.mesh import make_mesh
from orcai_tpu.train import trainer as jax_trainer
from orcai_tpu_torch.io.dataset import ArrayDataset, epoch_permutation, load_dataset
from orcai_tpu_torch.io.jsonio import read_json
from orcai_tpu_torch.io.model_store import convert_flax_variables, to_flax_variables
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.train.trainer import (
    DeviceData,
    Trainer,
    device_runners,
    fit,
    get_learning_rate,
    make_optimizer,
    resolve_compute_dtype,
    set_learning_rate,
    streaming_runners,
    train,
)
from orcai_tpu_torch.utils.messenger import Messenger
from orcai_tpu_torch.utils.seeds import MASK_VALUE

ARCHS = ["ResNetLSTM", "ResNet1DConv", "ResNetTCN"]
INPUT_SHAPE = (32, 21, 1)
OUT_STEPS = 2  # 32 / 2**4

PARAM = {
    "name": "train-test",
    "architecture": "ResNetLSTM",
    "model": {
        "epochs": 3,
        "batch_size": 8,
        "filters": [2, 3, 4, 5],
        "kernel_size": 3,
        "dropout_rate": 0.1,
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


def setup_module():
    torch.set_num_threads(1)


def _param(arch="ResNetLSTM", dropout=0.1, **top):
    return {**PARAM, "architecture": arch, "model": {**PARAM["model"], "dropout_rate": dropout},
            **top}


def _synthetic_arrays(n=32, seed=0, masked=False):
    """Learnable toy data (tests/test_train.py:54): label 1 iff a band of
    the window carries more energy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, *INPUT_SHAPE)).astype(np.float32)
    strong = rng.integers(0, 2, size=(n, OUT_STEPS, 2)).astype(np.float32)
    for i in range(n):
        for t in range(OUT_STEPS):
            if strong[i, t, 0] > 0.5:
                x[i, t * 16 : (t + 1) * 16, :5] += 2.0
            if strong[i, t, 1] > 0.5:
                x[i, t * 16 : (t + 1) * 16, 10:15] += 2.0
    if masked:
        strong[rng.uniform(size=strong.shape) < 0.2] = MASK_VALUE
    return x, strong


def _write_tvt(path, n=32, splits=("train", "val"), masked=False):
    x, y = _synthetic_arrays(n, masked=masked)

    class ListLoader:
        def __len__(self):
            return len(x)

        def __iter__(self):
            return iter(zip(x, y))

    for split in splits:
        ArrayDataset.save_from_loader(ListLoader(), path / f"{split}_dataset")
    (path / "dataset_shapes.json").write_text(
        json.dumps({"spectrogram": list(INPUT_SHAPE), "labels": [OUT_STEPS, 2]}))
    return x, y


def _near_init_variables(param, seed=0):
    """flax's own initial kernels, the other leaves a little off their
    initial values (see tests/test_torch_architectures.py for why the
    training-mode comparisons stay near an initialisation)."""
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


def _port_trainer(param, variables, call_weights=None, lr=1e-3):
    model = build_model(param, INPUT_SHAPE)
    trainer = Trainer(model, lr, call_weights=call_weights, device="cpu")
    state = trainer.state_from_variables(convert_flax_variables(variables), seed=0)
    return trainer, state


# ---------------------------------------------------------------- one step


def _reference_step(param, variables, x, y, w, dtype):
    """(loss, new batch_stats, gradients) of the reference's training loss
    (weighted masked BCE from logits + l2, batch statistics), in `dtype`."""
    jmodel = jax_build_model(param, dtype=dtype)
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)

    def loss_fn(p):
        logits, new_vars = jmodel.apply(
            {"params": p, "batch_stats": cast(variables["batch_stats"])}, jnp.asarray(x, dtype),
            train=True, return_logits=True, mutable=["batch_stats"])
        loss = jax_weighted_bce(logits, jnp.asarray(y, dtype),
                                None if w is None else jnp.asarray(w, dtype))
        return loss + jax_l2_regularization(p), new_vars["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(cast(variables["params"]))
    return float(loss), stats, grads


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "call_weights"])
def test_gradients_of_one_step_match_jax_grad(arch, weighted):
    """Dropout 0. Every leaf of the port's gradient, taken back through the
    layout mapping, against jax.grad of the reference's loss. Adam's first
    step would hide a wrong gradient (it moves every weight by about lr), so
    the gradients themselves are held, with a bar relative to the largest
    gradient of the tree:

    - against the reference run in float64: 2e-5 (measured <= 9e-6);
    - against the reference in float32: 2e-5, or twice the distance of that
      float32 run from its own float64 run where that is larger. The
      float32 reference is not always that good: on ResNet1DConv its
      block0_sep1 gradients are 7e-3 of the largest gradient away from its
      float64 run while the port is 2.4e-6 away (ROADMAP C).
    """
    param = _param(arch, dropout=0.0)
    _, variables = _near_init_variables(param)
    x, y = _synthetic_arrays(16, seed=1, masked=True)
    w = np.asarray([0.5, 3.0], np.float32) if weighted else None
    loss32, stats32, grads32 = _reference_step(param, variables, x, y, w, jnp.float32)
    with jax.enable_x64(True):
        loss64, stats64, grads64 = _reference_step(param, variables, x, y, w, jnp.float64)
        grads64, stats64 = _flat(grads64), _flat(stats64)
    grads32, stats32 = _flat(grads32), _flat(stats32)

    trainer, state = _port_trainer(param, variables, call_weights=w)
    model = trainer.model
    logits = model(torch.from_numpy(x), train=True, return_logits=True)
    loss = trainer._loss(logits, torch.from_numpy(y))
    loss.backward()
    loss_value = loss.item()
    assert loss_value == pytest.approx(loss64, rel=1e-5)
    assert loss_value == pytest.approx(loss32, rel=1e-5)

    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    got = _flat(to_flax_variables(grads)["params"])
    assert sorted(got) == sorted(grads64)
    largest = max(np.abs(g).max() for g in grads64.values())
    reference_own = max(np.abs(grads32[k] - grads64[k]).max() for k in grads64)
    for key, g in grads64.items():
        np.testing.assert_allclose(got[key], g, atol=2e-5 * largest, rtol=0, err_msg=key)
        np.testing.assert_allclose(got[key], grads32[key], rtol=0, err_msg=key,
                                   atol=max(2e-5 * largest, 2 * reference_own))
    # a frozen bias has no gradient in the port and an exact zero in JAX
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None
    assert not grads32["['trunk']['entry_conv']['bias']"].any()
    # the new running statistics are flax's batch_stats
    new_stats = _flat(to_flax_variables(model.state_dict())["batch_stats"])
    assert sorted(new_stats) == sorted(stats64)
    for key, want in stats64.items():
        np.testing.assert_allclose(new_stats[key], want, atol=1e-6, rtol=0, err_msg=key)
        np.testing.assert_allclose(new_stats[key], stats32[key], atol=2e-6, rtol=0, err_msg=key)


def test_train_and_eval_step_metrics_match_the_jax_trainer():
    """[loss, correct, total] of one train step and one eval step, from the
    same weights and batch, dropout 0."""
    param = _param(dropout=0.0)
    jmodel, variables = _near_init_variables(param)
    x, y = _synthetic_arrays(8, seed=2, masked=True)
    jt = jax_trainer.Trainer(jmodel, jax_trainer.make_optimizer(1e-3), mesh=make_mesh(n_data=1))
    jstate = jt.state_from_variables(variables)
    want_eval = np.asarray(jt.eval_step(jstate[0], jstate[1], jnp.asarray(x), jnp.asarray(y)))
    jstate, want_train = jt.train_step(jstate, jnp.asarray(x), jnp.asarray(y))
    want_after = np.asarray(jt.eval_step(jstate[0], jstate[1], jnp.asarray(x), jnp.asarray(y)))

    trainer, state = _port_trainer(param, variables)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got_eval, probs = trainer.eval_step_probs(xt, yt)
    assert probs.shape == (8, OUT_STEPS, 2) and probs.dtype == torch.float32
    np.testing.assert_allclose(got_eval.numpy(), want_eval, rtol=1e-5)
    got_train = trainer.train_step(state, xt, yt)
    assert isinstance(got_train, torch.Tensor) and got_train.shape == (3,)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), rtol=1e-5)
    # after one Adam step of 1e-3 on every weight
    np.testing.assert_allclose(trainer.eval_step(xt, yt).numpy(), want_after, rtol=2e-4)


def test_adam_matches_optax_on_a_shared_gradient_sequence():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (11,), "c": (2, 3, 4)}
    start = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: (10.0 ** rng.uniform(-4, 1) * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(25)]
    lrs = [1e-2] * 10 + [5e-3] * 15  # a plateau cut in the middle

    opt = jax_trainer.make_optimizer(lrs[0])
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = opt.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    adam = torch.optim.Adam(params.values(), lr=lrs[0], betas=(0.9, 0.999), eps=1e-8)
    for g, lr in zip(steps, lrs):
        jstate = jax_trainer.set_learning_rate(jstate, lr)
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for group in adam.param_groups:
            group["lr"] = lr
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        adam.step()
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=1e-7, rtol=0)


def test_make_optimizer_is_optax_adam_without_the_frozen_biases():
    model = build_model(_param(), INPUT_SHAPE)
    opt = make_optimizer(model, 3e-4)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == \
        (3e-4, (0.9, 0.999), 1e-8, 0.0)
    held = {id(p) for p in group["params"]}
    for name, p in model.named_parameters():
        assert (id(p) in held) == p.requires_grad, name


def test_lr_set_get():
    trainer = Trainer(build_model(_param(), INPUT_SHAPE), 1e-2, device="cpu")
    state = trainer.init_state(seed=0)
    assert get_learning_rate(state) == pytest.approx(1e-2)
    set_learning_rate(state, 5e-3)
    assert get_learning_rate(state) == pytest.approx(5e-3)
    assert all(g["lr"] == 5e-3 for g in state.optimizer.param_groups)


def test_train_step_runs_and_learns():
    trainer = Trainer(build_model(_param(), INPUT_SHAPE), 1e-2, device="cpu")
    state = trainer.init_state(seed=0)
    x, y = _synthetic_arrays(n=64)

    def batches():
        for b in range(8):
            yield x[b * 8 : (b + 1) * 8], y[b * 8 : (b + 1) * 8]

    state, m0 = trainer.run_train_epoch(state, batches())
    for _ in range(6):
        state, m = trainer.run_train_epoch(state, batches())
    assert m["loss"] < m0["loss"]
    assert m["MBA"] > 0.6


def test_second_lstm_bias_stays_zero_through_training():
    trainer = Trainer(build_model(_param(), INPUT_SHAPE), 1e-2, device="cpu")
    state = trainer.init_state(seed=0)
    x, y = _synthetic_arrays(n=16)
    before = trainer.model.bilstm1.fwd.bias_ih.detach().clone()
    for _ in range(3):
        trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(y))
    for layer in (trainer.model.bilstm1, trainer.model.bilstm2):
        for direction in (layer.fwd, layer.bwd):
            assert not direction.bias_hh.any()
    assert not torch.equal(trainer.model.bilstm1.fwd.bias_ih, before)
    to_flax_variables(trainer.model.state_dict())  # exports: the check passes


def test_bfloat16_step_reaches_the_float32_masters():
    assert resolve_compute_dtype({"compute_dtype": "bfloat16"}) is torch.bfloat16
    assert resolve_compute_dtype({}) is torch.float32
    model = build_model(_param(), INPUT_SHAPE, dtype=torch.bfloat16)
    trainer = Trainer(model, 1e-2, device="cpu")
    state = trainer.init_state(seed=0)
    x, y = _synthetic_arrays(n=8)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert torch.isfinite(metrics).all() and metrics.dtype == torch.float32
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        if p.requires_grad:
            assert p.grad is not None and p.grad.dtype == torch.float32, name
            assert not torch.equal(p, before[name]), name
    for name, buf in model.named_buffers():
        assert buf.dtype == torch.float32, name


# ------------------------------------------------------- data and runners


@pytest.mark.parametrize("n,batch,seed,epoch,drop", [
    (100, 8, [7, 42], 3, True), (100, 8, [7, 42], 4, True), (37, 8, [9, 5], 0, False),
    (5, 8, [9, 5], 0, False), (64, 64, 11, 2, True), (70, 64, [9, 0], 0, False),
])
def test_epoch_permutation_is_the_reference_s(n, batch, seed, epoch, drop):
    want = jax_epoch_permutation(n, batch, seed, epoch, drop_remainder=drop)
    got = epoch_permutation(n, batch, seed, epoch, drop_remainder=drop)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_array_dataset_batches_are_index_equal(tmp_path):
    x, y = _write_tvt(tmp_path, n=37, splits=("train",))
    ours = ArrayDataset.load(tmp_path / "train_dataset")
    theirs = JaxArrayDataset.load(tmp_path / "train_dataset")  # the port's files
    assert len(ours) == len(theirs) == 37
    assert ours.n_batches(8) == theirs.n_batches(8) == 4
    assert ours.n_batches(8, drop_remainder=False) == 5
    for epoch in (0, 1):
        pairs = zip(ours.batches(8, seed=[7, 42], epoch=epoch),
                    theirs.batches(8, seed=[7, 42], epoch=epoch))
        n = 0
        for (xa, ya), (xb, yb) in pairs:
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
            n += 1
        assert n == 4
    ds, epoch_batches = load_dataset(tmp_path / "train_dataset", 8, seed=[7, 42])
    first = next(iter(epoch_batches(0)))
    np.testing.assert_array_equal(first[0], next(iter(ours.batches(8, seed=[7, 42])))[0])


def test_array_dataset_shards_gzip_and_refusals(tmp_path):
    x, y = _synthetic_arrays(10)

    class L:
        def __len__(self):
            return 10

        def __iter__(self):
            return iter(zip(x, y))

    ArrayDataset.save_from_loader(L(), tmp_path / "sharded", shard_size=4)
    ds = ArrayDataset.load(tmp_path / "sharded")
    np.testing.assert_array_equal(ds.x[np.array([9, 0, 5])], x[[9, 0, 5]])
    np.testing.assert_array_equal(np.asarray(ds.y), y)
    ArrayDataset.save_from_loader(L(), tmp_path / "gz", compression="GZIP")
    np.testing.assert_array_equal(ArrayDataset.load(tmp_path / "gz").x, x)
    with pytest.raises(FileExistsError):
        ArrayDataset.save_from_loader(L(), tmp_path / "gz")
    with pytest.raises(FileNotFoundError, match="meta.json"):
        ArrayDataset.load(tmp_path / "nothing")


def _two_epochs(runners, state):
    run_train, run_val = runners
    history = []
    for e in range(2):
        state, m = run_train(state, e)
        history.append({**m, **run_val(state, e)})
    return history


@pytest.mark.parametrize("quantize", [False, True], ids=["float32", "uint8"])
def test_resident_equals_streaming(quantize):
    """The same seeded batches through both runners from the same weights,
    dropout 0 (tests/test_device_runners.py). Exact on the CPU in float32;
    the uint8 variant against a streaming run over the dequantized data."""
    param = _param(dropout=0.0)
    x, y = _synthetic_arrays(16, seed=0)
    xv, yv = _synthetic_arrays(8, seed=1)
    x, xv = x / x.max(), xv / xv.max()  # [0, 1], as stored spectrograms are
    train_ds, val_ds = ArrayDataset(x, y), ArrayDataset(xv, yv)
    seed_t, seed_v = [1, 9], [2, 9]

    def make():
        trainer = Trainer(build_model(param, INPUT_SHAPE), 1e-3, device="cpu")
        return trainer, trainer.init_state(seed=5)

    if quantize:
        deq = lambda a: (np.round(a * 255.0).astype(np.uint8).astype(np.float32)
                         * np.float32(1.0 / 255.0))
        s_train, s_val = ArrayDataset(deq(x), y), ArrayDataset(deq(xv), yv)
    else:
        s_train, s_val = train_ds, val_ds
    trainer1, state1 = make()
    streamed = _two_epochs(streaming_runners(
        trainer1,
        lambda e: s_train.batches(4, seed=seed_t, epoch=e),
        lambda e: s_val.batches(4, seed=seed_v, epoch=e)), state1)
    trainer2, state2 = make()
    resident = _two_epochs(device_runners(trainer2, train_ds, val_ds, 4, seed_t, seed_v,
                                          quantize=quantize), state2)
    assert resident == streamed
    assert all(np.isfinite(v) for m in resident for v in m.values())


def test_device_data_is_shared_and_quantized_once():
    x, y = _synthetic_arrays(8)
    x = x / x.max()
    data = DeviceData(ArrayDataset(x, y), quantize=True, device="cpu")
    assert data.x.dtype == torch.uint8 and data.y.dtype == torch.float32
    assert data.n == 8 and data.n_batches(3) == 2
    trainer = Trainer(build_model(_param(), INPUT_SHAPE), 1e-3, device="cpu")
    state = trainer.init_state(seed=0)
    run_train, run_val = device_runners(trainer, data, data, 4, [1, 2], [3, 4])
    state, m = run_train(state, 0)
    assert np.isfinite(m["loss"]) and 0.0 <= run_val(state, 0)["val_MBA"] <= 1.0


def test_resident_runner_matches_the_jax_device_runner():
    """One epoch of both packages' resident runners from the same weights
    over the same dataset and seeds: the batches are the same, so the
    metrics agree to the two steps' float differences."""
    param = _param(dropout=0.0)
    jmodel, variables = _near_init_variables(param)
    x, y = _synthetic_arrays(16, seed=3)
    jt = jax_trainer.Trainer(jmodel, jax_trainer.make_optimizer(1e-3), mesh=make_mesh(n_data=1))
    jstate = jt.state_from_variables(variables)
    jrun_train, jrun_val = jax_trainer.device_runners(
        jt, JaxArrayDataset(x, y), JaxArrayDataset(x, y), 8, [1, 9], [2, 9])
    jstate, want = jrun_train(jstate, 0)
    want.update(jrun_val(jstate, 0))
    trainer, state = _port_trainer(param, variables)
    run_train, run_val = device_runners(trainer, ArrayDataset(x, y), ArrayDataset(x, y),
                                        8, [1, 9], [2, 9])
    state, got = run_train(state, 0)
    got.update(run_val(state, 0))
    assert got["MBA"] == want["MBA"] and got["val_MBA"] == want["val_MBA"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-3)


# ------------------------------------------------------------------- fit


def _scripted(vals, drift=0.0):
    def fake_train(state, epoch):
        if drift:
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(drift)
        return state, {"loss": 1.0, "MBA": 0.5}

    def fake_val(state, epoch):
        return {"val_loss": 1.0, "val_MBA": vals[epoch] if epoch < len(vals) else vals[-1]}

    return fake_train, fake_val


def _jax_scripted(vals):
    def fake_train(state, epoch):
        return state, {"loss": 1.0, "MBA": 0.5}

    def fake_val(state, epoch):
        return {"val_loss": 1.0, "val_MBA": vals[epoch] if epoch < len(vals) else vals[-1]}

    return fake_train, fake_val


@pytest.fixture(scope="module")
def jax_fit_setup():
    jmodel = jax_build_model(_param())
    jt = jax_trainer.Trainer(jmodel, jax_trainer.make_optimizer(1e-3), mesh=make_mesh(n_data=1))
    return jt, (lambda: jt.init_state(INPUT_SHAPE, seed=0))


def _port_fit_setup():
    trainer = Trainer(build_model(_param(), INPUT_SHAPE), 1e-3, device="cpu")
    return trainer, trainer.init_state(seed=0)


SCRIPTS = {
    "plateau_then_stop": ([0.5, 0.6, 0.6, 0.59, 0.58, 0.57, 0.56, 0.55, 0.5, 0.5, 0.5, 0.5],
                          dict(early_stopping_patience=6, reduce_lr_patience=2)),
    "constant": ([0.5] * 20, dict(early_stopping_patience=4, reduce_lr_patience=2)),
    "always_better": ([0.1 * i for i in range(8)],
                      dict(early_stopping_patience=2, reduce_lr_patience=1)),
    "late_recovery": ([0.5, 0.4, 0.4, 0.4, 0.7, 0.6, 0.6, 0.6, 0.6, 0.6],
                      dict(early_stopping_patience=5, reduce_lr_patience=3)),
    "floor": ([0.5] * 12, dict(early_stopping_patience=50, reduce_lr_patience=1,
                               reduce_lr_factor=0.1, reduce_lr_min=1e-5)),
}


@pytest.mark.parametrize("name", SCRIPTS)
def test_fit_schedule_matches_the_jax_fit(name, jax_fit_setup):
    """The same scripted val_MBA sequence through both fits: the same LR
    per epoch, the same stop epoch, the same history."""
    vals, kwargs = SCRIPTS[name]
    jt, jinit = jax_fit_setup
    _, want = jax_trainer.fit(jt, jinit(), *_jax_scripted(vals), epochs=len(vals),
                              initial_lr=1e-3, **kwargs)
    trainer, state = _port_fit_setup()
    state, got = fit(trainer, state, *_scripted(vals), epochs=len(vals), initial_lr=1e-3,
                     **kwargs)
    assert got == want
    assert get_learning_rate(state) == pytest.approx(want["learning_rate"][-1]) or \
        get_learning_rate(state) <= want["learning_rate"][-1]


def test_fit_early_stopping_and_reduce_lr():
    trainer, state = _port_fit_setup()
    x, y = _synthetic_arrays(n=8)
    run_train, run_val = streaming_runners(trainer, lambda e: [(x, y)], lambda e: [(x, y)])
    seen = []
    state, history = fit(trainer, state, run_train, run_val, epochs=20,
                         early_stopping_patience=4, reduce_lr_patience=2, initial_lr=1e-3,
                         on_epoch_end=lambda s, h, e, lr, c: seen.append((e, lr, dict(c))))
    n_epochs = len(history["loss"])
    assert n_epochs < 20  # early-stopped
    assert "val_MBA" in history and "learning_rate" in history
    assert [e for e, _, _ in seen] == list(range(n_epochs))
    lrs = history["learning_rate"]
    assert all(b <= a for a, b in zip(lrs, lrs[1:]))  # never raised


def test_fit_counters_exact_resume():
    """Checkpointed EarlyStopping/ReduceLR counters make a resumed run
    reduce LR at exactly the same epoch as an uninterrupted one."""
    vals = [0.5, 0.6, 0.6, 0.59, 0.58, 0.57, 0.56, 0.55]

    def run(epochs=len(vals), captured=None, **initial):
        trainer, state = _port_fit_setup()
        return fit(trainer, state, *_scripted(vals), epochs=epochs,
                   early_stopping_patience=10, reduce_lr_patience=3, initial_lr=1e-3,
                   on_epoch_end=captured, **initial)

    _, full_history = run()
    snapshots = []
    run(epochs=3, captured=lambda s, h, e, lr, c: snapshots.append(
        (e, lr, dict(c), {k: list(v) for k, v in h.items()})))
    e, lr, counters, hist = snapshots[-1]
    assert counters == {"stale_early": 1, "stale_lr": 1}  # best was epoch 2
    _, resumed_history = run(initial_epoch=e + 1, initial_history=hist,
                             initial_counters=counters)
    assert resumed_history == full_history
    assert full_history["learning_rate"][-1] < 1e-3


def test_fit_promotion_semantics():
    """Fresh counters give a carried history its full patience budget, and
    seeded best weights come back when the new epochs never improve; without
    counters the staleness is approximated from the history
    (tests/test_train.py:180)."""
    trainer, state = _port_fit_setup()
    carried_state = {k: v.clone() for k, v in state.model.state_dict().items()}
    carried = {"val_MBA": [0.9, 0.5, 0.5, 0.5, 0.5], "MBA": [0.5] * 5, "loss": [1.0] * 5,
               "val_loss": [1.0] * 5, "learning_rate": [1e-3] * 5}
    kwargs = dict(epochs=11, early_stopping_patience=3, reduce_lr_patience=10,
                  initial_lr=1e-3, initial_epoch=5)
    state, history = fit(trainer, state, *_scripted([0.4] * 11, drift=1.0),
                         initial_history=carried, initial_best_state=carried_state,
                         initial_counters={"stale_early": 0, "stale_lr": 0}, **kwargs)
    assert len(history["val_MBA"]) - 5 == 3  # the full patience budget ran
    assert carried["val_MBA"] == [0.9, 0.5, 0.5, 0.5, 0.5]  # the caller's lists are untouched
    for k, v in state.model.state_dict().items():  # the carried best, not the drifted end
        assert torch.equal(v, carried_state[k]), k

    trainer, state = _port_fit_setup()
    _, approx = fit(trainer, state, *_scripted([0.4] * 11, drift=1.0),
                    initial_history={k: list(v) for k, v in carried.items()}, **kwargs)
    assert len(approx["val_MBA"]) - 5 == 1


def test_fit_restores_the_best_epochs_weights():
    trainer, state = _port_fit_setup()
    snapshots = {}

    def on_improve(s, h):
        snapshots[len(h["val_MBA"])] = {k: v.clone() for k, v in s.model.state_dict().items()}

    state, history = fit(trainer, state, *_scripted([0.5, 0.7, 0.6, 0.6], drift=0.5), epochs=4,
                         on_improve=on_improve)
    assert sorted(snapshots) == [1, 2]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snapshots[2][k]), k


def test_fit_warns_on_a_loss_monitor(capsys):
    trainer, state = _port_fit_setup()
    _, history = fit(trainer, state, *_scripted([0.5, 0.5]), epochs=2, monitor="val_loss",
                     msgr=Messenger(verbosity=1))
    assert "‼️ monitor 'val_loss' looks like a loss but monitoring is max-mode" in \
        capsys.readouterr().out
    assert len(history["val_loss"]) == 2


# ----------------------------------------------------------------- train


def _run_train(tmp_path, param, **kwargs):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    train(tmp_path, out, orcai_parameter=param, device="cpu", **kwargs)
    return out / param["name"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_e2e_and_resume(arch, tmp_path):
    _write_tvt(tmp_path)
    param = _param(arch)
    model_dir = _run_train(tmp_path, param)
    assert sorted(p.name for p in model_dir.iterdir()) == sorted([
        "train-test.msgpack", "train-test.opt.pt", "orcai_parameter.json", "model_shape.json",
        "train_state.json", "training_history.json"])
    assert read_json(model_dir / "orcai_parameter.json") == param
    assert read_json(model_dir / "model_shape.json") == {
        "input_shape": list(INPUT_SHAPE), "num_labels": 2}
    assert read_json(model_dir / "train_state.json") == {"epochs_run": 3}
    history = read_json(model_dir / "training_history.json")
    assert sorted(history) == ["MBA", "learning_rate", "loss", "val_MBA", "val_loss"]
    assert len(history["loss"]) == 3 and np.isfinite(history["loss"]).all()

    # the JAX package loads the directory and predicts with it
    from orcai_tpu_torch.io.model_store import load_orcai_model

    x, _ = _synthetic_arrays(4, seed=9)
    jmodel, jvars, jparam, _ = jax_load_orcai_model(model_dir)
    model, _, _ = load_orcai_model(model_dir, device="cpu")
    with torch.no_grad():
        own = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False)),
                               own, atol=2e-5, rtol=0)
    assert jparam == param

    # resume from saved model
    _run_train(tmp_path, param, load_model=True, max_epochs=1)
    assert len(read_json(model_dir / "training_history.json")["loss"]) == 1
    assert read_json(model_dir / "train_state.json") == {"epochs_run": 1}


def test_train_with_null_seed_and_streaming_budget(tmp_path, monkeypatch):
    """"seed": null trains with unseeded shuffles; a byte budget of 1 takes
    the streaming runner."""
    _write_tvt(tmp_path, n=16)
    monkeypatch.setenv("ORCAI_TPU_DEVICE_DATASET_BYTES", "1")
    param = _param(name="null-seed", seed=None)
    param["model"]["epochs"] = 1
    model_dir = _run_train(tmp_path, param, preemption_checkpointing=False)
    assert (model_dir / "null-seed.msgpack").exists()
    assert not (model_dir / "resume").exists()


def test_streaming_and_resident_train_write_the_same_history(tmp_path, monkeypatch):
    _write_tvt(tmp_path)
    param = _param(dropout=0.5, name="resident")
    resident = read_json(_run_train(tmp_path, param) / "training_history.json")
    monkeypatch.setenv("ORCAI_TPU_DEVICE_DATASET_BYTES", "1")
    streamed = read_json(_run_train(tmp_path, dict(param, name="streamed"))
                         / "training_history.json")
    assert streamed == resident


def test_quantized_resident_train_runs(tmp_path, monkeypatch):
    _write_tvt(tmp_path, n=16)
    monkeypatch.setenv("ORCAI_TPU_QUANTIZE_DATASET", "1")
    param = _param(name="quantized")
    param["model"]["epochs"] = 1
    history = read_json(_run_train(tmp_path, param) / "training_history.json")
    assert np.isfinite(history["loss"]).all()


def test_bfloat16_compute_dtype_trains_and_saves_float32(tmp_path):
    from orcai_tpu_torch.io.model_store import load_variables

    _write_tvt(tmp_path, n=16)
    param = _param(name="bf16")
    param["model"].update(epochs=1, compute_dtype="bfloat16")
    model_dir = _run_train(tmp_path, param, preemption_checkpointing=False)
    history = read_json(model_dir / "training_history.json")
    assert np.isfinite(history["loss"]).all()
    kernel = load_variables(model_dir / "bf16.msgpack")["params"]["dense"]["kernel"]
    assert kernel.dtype == np.float32


def test_command_line_train_and_test(tmp_path, capsys):
    """`python -m orcai_tpu_torch train` and `test` with the reference's
    option names, on the CPU."""
    from orcai_tpu_torch.__main__ import main

    _write_tvt(tmp_path, n=16, splits=("train", "val", "test"))
    param = _param(name="cli")
    param["model"]["epochs"] = 1
    (tmp_path / "param.json").write_text(json.dumps(param))
    out = tmp_path / "out"
    assert main(["train", str(tmp_path), str(out), "-p", str(tmp_path / "param.json"),
                 "-dc", "None", "--device", "cpu", "-v", "0"]) == 0
    assert main(["train", str(tmp_path), str(out), "-p", str(tmp_path / "param.json"),
                 "-lm", "--device", "cpu", "-v", "0"]) == 0
    model_dir = out / "cli"
    assert (model_dir / "cli.msgpack").exists() and (model_dir / "cli.opt.pt").exists()
    capsys.readouterr()
    assert main(["test", str(model_dir), str(tmp_path), "-tu", "-o", str(tmp_path / "results"),
                 "--device", "cpu"]) == 0
    assert f"    Saved test results to {tmp_path / 'results'}\n" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "results").iterdir()) == [
        "test_data_confusion_table.csv", "test_data_metrics.json",
        "test_data_misclassification_table_pred_true.csv",
        "test_data_misclassification_table_true_pred.csv"]
    with pytest.raises(SystemExit):
        main(["train", str(tmp_path), str(out), "-dc", "ZIP"])


def test_load_model_resume_keeps_reduced_lr(tmp_path):
    """--load_model must continue at the optimizer's restored learning rate;
    ReduceLROnPlateau may never RAISE the effective LR."""
    _write_tvt(tmp_path, n=16)
    param = _param(name="lr-resume")
    param["model"]["epochs"] = 1
    model_dir = _run_train(tmp_path, param, preemption_checkpointing=False)
    opt_path = model_dir / "lr-resume.opt.pt"
    opt_state = torch.load(opt_path)
    for group in opt_state["param_groups"]:
        group["lr"] = 1e-5  # as an earlier ReduceLROnPlateau left it
    torch.save(opt_state, opt_path)
    _run_train(tmp_path, param, load_model=True, preemption_checkpointing=False)
    history = read_json(model_dir / "training_history.json")
    assert history["learning_rate"][-1] == pytest.approx(1e-5)


def test_load_model_without_optimizer_state_starts_adam_fresh(tmp_path, capsys):
    _write_tvt(tmp_path, n=16)
    param = _param(name="fresh-adam")
    param["model"]["epochs"] = 1
    model_dir = _run_train(tmp_path, param, preemption_checkpointing=False)
    (model_dir / "fresh-adam.opt.pt").unlink()
    capsys.readouterr()
    _run_train(tmp_path, param, load_model=True, preemption_checkpointing=False, verbosity=3)
    assert "Adam starts fresh" in capsys.readouterr().out
    history = read_json(model_dir / "training_history.json")
    assert history["learning_rate"] == [param["model"]["learning_rate"]]


def test_load_model_resumes_adam_from_the_jax_package_s_opt_msgpack(tmp_path, capsys):
    """The JAX package trains one epoch and saves; the port loads that
    directory with load_model and holds optax's Adam moments, count and
    learning rate. One step on a shared batch (the reference's gradient fed
    to both optimizers) lands on the reference's next weights within 1e-7
    plus one float32 ulp of the weight (ROADMAP.md C: the Adam bar), while a
    fresh Adam lands far from them."""
    import flax.serialization

    from orcai_tpu.utils import Messenger as JaxMessenger
    from orcai_tpu_torch.io.model_store import load_optax_adam_state, load_orcai_model

    _write_tvt(tmp_path, n=16)
    param = _param(name="from-jax", dropout=0.0)
    param["model"]["epochs"] = 1
    (tmp_path / "out").mkdir()
    jax_trainer.train(tmp_path, tmp_path / "out", orcai_parameter=param,
                      msgr=JaxMessenger(verbosity=0), preemption_checkpointing=False)
    model_dir = tmp_path / "out" / "from-jax"
    assert (model_dir / "from-jax.opt.msgpack").exists()
    assert not (model_dir / "from-jax.opt.pt").exists()

    # the reference's next step from its saved state, on a shared batch
    _, variables, _, _ = jax_load_orcai_model(model_dir)
    opt = jax_trainer.make_optimizer(param["model"]["learning_rate"])
    jstate = flax.serialization.from_bytes(opt.init(variables["params"]),
                                           (model_dir / "from-jax.opt.msgpack").read_bytes())
    x, y = _synthetic_arrays(8, seed=4)
    _, _, grads = _reference_step(param, variables, x, y, None, jnp.float32)
    updates, _ = opt.update(grads, jstate, variables["params"])
    want = _flat(optax.apply_updates(variables["params"], updates))

    def port_step(restore: bool) -> dict:
        model, _, _ = load_orcai_model(model_dir, device="cpu")
        state = Trainer(model, param["model"]["learning_rate"], device="cpu") \
            .state_from_variables(seed=0)
        if restore:
            lr = load_optax_adam_state(model_dir / "from-jax.opt.msgpack", model,
                                       state.optimizer)
            assert lr == pytest.approx(float(jstate.hyperparams["learning_rate"]))
        grad = convert_flax_variables({"params": grads})
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grad[name]) if p.requires_grad else None
        state.optimizer.step()
        return _flat(to_flax_variables(model.state_dict())["params"])

    got, fresh = port_step(True), port_step(False)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=1e-7, rtol=2.0**-23, err_msg=key)
    assert max(np.abs(fresh[k] - w).max() for k, w in want.items()) > 1e-4

    # train(load_model=True) restores it and continues at the saved rate
    capsys.readouterr()
    _run_train(tmp_path, param, load_model=True, max_epochs=1, preemption_checkpointing=False)
    assert "    Restoring optax's optimizer state from from-jax.opt.msgpack\n" in \
        capsys.readouterr().out
    history = read_json(model_dir / "training_history.json")
    assert history["learning_rate"] == [pytest.approx(param["model"]["learning_rate"])]
    assert (model_dir / "from-jax.opt.pt").exists()


def test_call_weights_are_checked_and_used(tmp_path):
    _write_tvt(tmp_path, n=16)
    param = _param(name="weighted")
    param["model"].update(epochs=1, call_weights="call_weights.json")
    (tmp_path / "call_weights.json").write_text(json.dumps({"B": 2.0, "A": 1.0}))
    with pytest.raises(ValueError, match="Call weights do not match label calls"):
        _run_train(tmp_path, param, preemption_checkpointing=False)
    (tmp_path / "call_weights.json").write_text(json.dumps({"A": 1.0, "B": 1.0}))
    ones = read_json(_run_train(tmp_path, param, preemption_checkpointing=False)
                     / "training_history.json")
    (tmp_path / "call_weights.json").write_text(json.dumps({"A": 1.0, "B": 5.0}))
    heavy = read_json(_run_train(tmp_path, param, preemption_checkpointing=False)
                      / "training_history.json")
    plain = read_json(_run_train(tmp_path, _param(name="weighted", **{
        "model": {**param["model"], "call_weights": None}}), preemption_checkpointing=False)
        / "training_history.json")
    assert ones["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    assert heavy["loss"] != ones["loss"]


class _Killed(Exception):
    pass


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "streaming"])
def test_resumed_equals_uninterrupted_exactly(resident, tmp_path, monkeypatch):
    """A run killed after epoch 2 and started again continues from its
    checkpoint (weights, Adam, dropout generator, counters) and ends with
    the history and the weights of an uninterrupted run, bit for bit on the
    CPU, dropout on."""
    if not resident:
        monkeypatch.setenv("ORCAI_TPU_DEVICE_DATASET_BYTES", "1")
    _write_tvt(tmp_path)
    param = _param(dropout=0.3, name="whole")
    param["model"].update(epochs=4, ReduceLROnPlateau_patience=1)
    whole_dir = _run_train(tmp_path, param)

    cut = dict(param, name="cut")

    def kill(state, history, epoch, lr, counters):
        if epoch == 1:
            raise _Killed

    with pytest.raises(_Killed):
        _run_train(tmp_path, cut, on_epoch_end=kill)
    cut_dir = tmp_path / "out" / "cut"
    assert [p.name for p in (cut_dir / "resume").iterdir()] == ["epoch_1.pt"]
    assert not (cut_dir / "training_history.json").exists()
    _run_train(tmp_path, cut)
    assert not (cut_dir / "resume").exists()
    assert read_json(cut_dir / "training_history.json") == \
        read_json(whole_dir / "training_history.json")
    assert (cut_dir / "cut.msgpack").read_bytes() == (whole_dir / "whole.msgpack").read_bytes()


def test_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path):
    _write_tvt(tmp_path, n=16)
    param = _param(name="profiled")
    param["model"]["epochs"] = 2
    _run_train(tmp_path, param, profile_dir=str(tmp_path / "trace"),
               preemption_checkpointing=False)
    assert [p.name for p in (tmp_path / "trace").iterdir()] == ["train_epoch_1.json"]


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    from orcai_tpu_torch.train.evaluate import test_model

    _write_tvt(tmp_path, n=8)
    model = build_model(_param(), INPUT_SHAPE)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(model, 1e-3)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceData(ArrayDataset(*_synthetic_arrays(4)))
    with pytest.raises(RuntimeError, match="cuda"):
        train(tmp_path, tmp_path / "out", orcai_parameter=_param())
    with pytest.raises(RuntimeError, match="cuda"):
        test_model(tmp_path, tmp_path)
    assert not (tmp_path / "out").exists()
