"""Tensor parallelism of the port (orcai_tpu_torch/parallel/sharding_rules.py)
against the JAX package's (orcai_tpu/parallel/sharding_rules.py,
tests/test_sharding_tp.py) on the CPU.

The specs of every parameter of the three architectures against
params_shardings on the reference's 8-device CPU mesh, a model axis that
does not divide a leaf included; the block each model rank keeps against
the addressable shard JAX places on the device at that model coordinate;
and one train step over (1 x 2) and (2 x 2) grids of gloo processes
against the port's data-parallel step (dropout on, the masks shared) and
against JAX's step on the same mesh shape (dropout 0: the packages draw
different masks), at the reference test's bars: metrics rtol 1e-5, the
`out` kernel after the step atol 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.models import init_variables as jax_init_variables
from orcai_tpu.parallel import sharding_rules as jax_rules
from orcai_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
from orcai_tpu.train.trainer import Trainer as JaxTrainer, make_optimizer
from orcai_tpu_torch.io.model_store import convert_flax_variables
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.parallel.distributed import launch
from orcai_tpu_torch.parallel.mesh import ProcessMesh, make_mesh
from orcai_tpu_torch.parallel.sharding_rules import (
    _TO_TORCH,
    _spec_for,
    flax_path,
    gather_params,
    params_shardings,
    shard_params,
)
from orcai_tpu_torch.train.trainer import Trainer

PARAM = {  # tests/test_sharding_tp.py's
    "name": "tp-test",
    "architecture": "ResNetLSTM",
    "model": {"filters": [4, 6], "kernel_size": 3, "dropout_rate": 0.1, "lstm_units": 16},
    "calls": ["A", "B"],
}
INPUT_SHAPE = (16, 9, 1)
OUT = 4  # output steps: 16 / 2**2
ARCHS = ["ResNetLSTM", "ResNet1DConv", "ResNetTCN"]
GRIDS = [(1, 2), (2, 2)]
METRICS_RTOL = 1e-5  # tests/test_sharding_tp.py's bars
OUT_ATOL = 1e-5


def setup_module():
    torch.set_num_threads(1)


def _param(arch, dropout=0.1, labels=("A", "B")):
    return {**PARAM, "architecture": arch, "calls": list(labels),
            "model": {**PARAM["model"], "dropout_rate": dropout}}


def _jax_spec(shardings, path):
    node = shardings
    for key in path:
        node = node[key]
    return tuple(node.spec)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_data, n_model, labels", [
    (4, 2, ("A", "B")),
    (4, 2, ("A", "B", "C", "D", "E", "F", "G")),  # a 7-label head stays whole
    (2, 4, ("A", "B")),  # filters 6 and the 36-channel head do not divide by 4
])
def test_specs_match_the_jax_package_for_every_parameter(arch, n_data, n_model, labels):
    param = _param(arch, labels=labels)
    variables = jax_init_variables(jax_build_model(param), INPUT_SHAPE, seed=0)
    want = jax_rules.params_shardings(variables["params"], jax_make_mesh(n_data, n_model))
    model = build_model(param, INPUT_SHAPE)
    got = params_shardings(model, ProcessMesh(n_data, n_model))
    flax_leaves = {tuple(k.key for k in path)
                   for path, _ in jax.tree_util.tree_leaves_with_path(variables["params"])}
    assert {flax_path(k, p.ndim) for k, p in model.named_parameters()} == flax_leaves
    for name, p in model.named_parameters():
        assert got[name] == _jax_spec(want, flax_path(name, p.ndim)), name
    assert any("model" in s for s in got.values())
    undivided = [name for name, p in model.named_parameters()
                 if got[name] == () and "model" in _spec_for(flax_path(name, p.ndim), p.ndim)]
    assert bool(undivided) == (n_model == 4 or len(labels) == 7), undivided


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_keeps_the_shard_jax_places_at_its_model_coordinate(arch):
    param = _param(arch)
    variables = jax_init_variables(jax_build_model(param), INPUT_SHAPE, seed=0)
    mesh = jax_make_mesh(n_data=2, n_model=2)
    sharded = jax_rules.shard_params(variables["params"], mesh)
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    specs = params_shardings(build_model(param, INPUT_SHAPE), ProcessMesh(2, 2))
    n_sharded = 0
    for model_index in range(2):
        device = mesh.devices[0, model_index]
        model = build_model(param, INPUT_SHAPE)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        shard_params(model, ProcessMesh(2, 2, rank=model_index))
        for name, p in model.named_parameters():
            leaf = sharded
            for key in flax_path(name, p.ndim):
                leaf = leaf[key]
            (data,) = [s.data for s in leaf.addressable_shards if s.device == device]
            want = np.transpose(np.asarray(data), _TO_TORCH[p.ndim])
            np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=name)
            n_sharded += "model" in specs[name]
    assert n_sharded > 0


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(8, *INPUT_SHAPE)).astype(np.float32)
    y = rng.integers(0, 2, size=(8, OUT, 2)).astype(np.float32)
    return x, y


def _jax_state(arch, dropout):
    """The reference test's start: init_state(INPUT_SHAPE, seed=3)."""
    model = jax_build_model(_param(arch, dropout))
    params, stats, _, _ = JaxTrainer(model, make_optimizer(1e-3)).init_state(INPUT_SHAPE, seed=3)
    return model, params, stats


def _port_step(arch, dropout, state, x, y, mesh=None, device="cpu"):
    """One Trainer step from `state` on this process's block of (x, y):
    [loss, correct, total] of the global batch and the whole weights after
    the step. `mesh`: a ProcessMesh (none: one process)."""
    model = build_model(_param(arch, dropout), INPUT_SHAPE)
    trainer = Trainer(model, 1e-3, device=device, mesh=mesh)
    st = trainer.state_from_variables({k: torch.from_numpy(v) for k, v in state.items()})
    rows = trainer.block(np.arange(len(x))[None])[0]
    metrics = trainer.train_step(st, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    if trainer.distributed:
        dist.all_reduce(metrics, group=trainer.data_group)
    after = gather_params(model)
    return {"metrics": metrics.numpy(), "after": {k: v.numpy() for k, v in after.items()}}


def _grid_worker(runs, x, y, n_model, out, device="cpu"):
    """Every run's TP step on the group's (world / n_model, n_model) grid,
    then, with several data ranks, its DP step over the same data ranks
    (the grid's data groups, without the model axis)."""
    mesh = make_mesh(n_model=n_model)
    results = {"tp": [_port_step(a, d, s, x, y, mesh, device) for a, d, s in runs]}
    if mesh.shape["data"] > 1:
        dp = ProcessMesh(mesh.shape["data"], 1, mesh.data_index)
        dp.data_group = mesh.data_group
        results["dp"] = [_port_step(a, d, s, x, y, dp, device) if d else None
                         for a, d, s in runs]
    if dist.get_rank() == 0:
        torch.save(results, out)


@pytest.fixture
def no_onednn():
    # torch 2.13's oneDNN convolution backward can corrupt the heap at small
    # widths on the CPU (ROADMAP C); launch() passes the switch to workers
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _out_kernel(arch, after):
    """The head's output kernel in flax's layout, (in, labels)."""
    key = "out_conv1d.weight" if arch == "ResNet1DConv" else "out.weight"
    w = np.asarray(after[key])
    return np.transpose(w, _TO_TORCH[w.ndim]) if w.ndim == 3 else w.T


def test_a_tp_step_on_both_grids_takes_the_dp_step_and_the_jax_tp_step(tmp_path, no_onednn):
    """One step of every architecture over a (1 x 2) and a (2 x 2) grid of
    gloo processes: at dropout 0.1 (the masks shared) the metrics and the
    `out` kernel against the port's step on the same data ranks without
    the model axis (one process, or two data-parallel processes); at
    dropout 0 against JAX's step on a (1, 2) and a (2, 2) mesh."""
    x, y = _batch(0)
    runs, jax_runs = [], {}
    for arch in ARCHS:
        for dropout in (0.1, 0.0):
            model, params, stats = _jax_state(arch, dropout)
            state = convert_flax_variables({"params": jax.tree.map(np.asarray, params),
                                            "batch_stats": jax.tree.map(np.asarray, stats)})
            runs.append((arch, dropout, state))
            if dropout == 0.0:
                jax_runs[arch] = (model, params, stats)
    got, dp = {}, {1: [_port_step(a, d, s, x, y) if d else None for a, d, s in runs]}
    for n_data, n_model in GRIDS:
        out = tmp_path / f"tp_{n_data}x{n_model}.pt"
        launch(_grid_worker, ["cpu"] * (n_data * n_model), tmp_path,
               args=(runs, x, y, n_model, out))
        got[n_data] = torch.load(out, weights_only=False)
        dp.setdefault(n_data, got[n_data].get("dp"))
    for n_data, n_model in GRIDS:
        for i, (arch, dropout, _) in enumerate(runs):
            tp, ref = got[n_data]["tp"][i], dp[n_data][i]
            where = f"{arch}, dropout {dropout}, {n_data} x {n_model}"
            if dropout:
                np.testing.assert_allclose(tp["metrics"][0], ref["metrics"][0],
                                           rtol=METRICS_RTOL, err_msg=where)
                np.testing.assert_array_equal(tp["metrics"][1:], ref["metrics"][1:],
                                              err_msg=where)
                np.testing.assert_allclose(_out_kernel(arch, tp["after"]),
                                           _out_kernel(arch, ref["after"]), atol=OUT_ATOL,
                                           err_msg=where)
                continue
            model, params, stats = jax_runs[arch]
            mesh = jax_make_mesh(n_data=n_data, n_model=n_model)
            jt = JaxTrainer(model, make_optimizer(1e-3), mesh=mesh)
            p0 = jax_rules.shard_params(params, mesh)
            step = jax.jit(jt._train_step)
            xb = jax.device_put(jnp.asarray(x), batch_sharding(mesh))
            yb = jax.device_put(jnp.asarray(y), batch_sharding(mesh))
            (p1, _, _, _), m = step((p0, stats, jt.optimizer.init(p0), jax.random.key(4)),
                                    xb, yb)
            np.testing.assert_allclose(tp["metrics"][0], np.asarray(m)[0], rtol=METRICS_RTOL,
                                       err_msg=where)
            want = p1["out_conv1d" if arch == "ResNet1DConv" else "out"]["kernel"]
            np.testing.assert_allclose(_out_kernel(arch, tp["after"]), np.asarray(want),
                                       atol=OUT_ATOL, err_msg=where)
