"""All three architectures of the port against flax on the CPU, float32:
forward and the trunk/head split (atol 2e-5, tests/test_model_parity.py:59),
the l2 term, the weight layouts in both directions, and model directories
that cross between the two packages."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orcai_tpu.io.model_store import load_orcai_model as jax_load_orcai_model
from orcai_tpu.io.model_store import save_orcai_model as jax_save_orcai_model
from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.models import l2_regularization as jax_l2_regularization
from orcai_tpu.resources import MODELS_DATA_DIR
from orcai_tpu_torch.io.model_store import (
    convert_flax_variables,
    load_orcai_model,
    load_variables,
    save_orcai_model,
    to_flax_variables,
)
from orcai_tpu_torch.models import build_model, init_variables, l2_regularization

ARCHS = ["ResNetLSTM", "ResNet1DConv", "ResNetTCN"]
INPUT_SHAPE = (32, 21, 1)  # tests/test_train.py:50


def _param(arch, dropout=0.1, name=None):
    return {
        "name": name or f"arch-{arch}",
        "architecture": arch,
        "model": {"filters": [2, 3, 4, 5], "kernel_size": 3, "dropout_rate": dropout,
                  "lstm_units": 4, "batch_size": 8, "learning_rate": 1e-3},
        "calls": ["A", "B"],
        "seed": 3,
    }


def setup_module():
    torch.set_num_threads(1)


def _random_variables(arch, seed=0, shape=INPUT_SHAPE):
    """The flax variable tree of `arch`, every leaf drawn with numpy."""
    jmodel = jax_build_model(_param(arch))
    template = jmodel.init(jax.random.key(0), jnp.zeros((1, *shape)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if "var" in jax.tree_util.keystr(path):  # variances stay positive
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jmodel, jax.tree_util.tree_map_with_path(draw, template)


def _near_init_variables(arch, seed=0, shape=INPUT_SHAPE):
    """flax's own initial kernels, with biases, BatchNorm parameters and
    statistics moved a little off their initial values. The training-mode
    comparisons use these: with every leaf drawn at 0.3 sigma, channels come
    out with a mean far above their spread, where flax's float32
    mean(x^2) - mean(x)^2 loses digits (measured on ResNetTCN: flax 4.7e-4
    from its own float64 run, the port 5e-5)."""
    jmodel = jax_build_model(_param(arch))
    template = jmodel.init(jax.random.key(seed + 1), jnp.zeros((1, *shape)))
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


def _torch_model(arch, variables, shape=INPUT_SHAPE):
    model = build_model(_param(arch), shape)
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _l2(model):
    return l2_regularization(model).detach()


def _assert_trees_equal(a, b, path=""):
    assert type(a) is type(b) or not isinstance(a, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("return_logits", [False, True])
def test_forward_matches_flax(arch, return_logits):
    jmodel, variables = _random_variables(arch)
    x = np.random.default_rng(1).standard_normal((3, *INPUT_SHAPE)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False,
                                   return_logits=return_logits))
    with torch.no_grad():
        got = _torch_model(arch, variables)(torch.from_numpy(x), return_logits=return_logits)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_forward_matches_flax_without_dropout(arch):
    """train=True at dropout 0: batch statistics in every BatchNorm, the
    logits and the new running statistics against flax's batch_stats."""
    jmodel = jax_build_model(_param(arch, dropout=0.0))
    _, variables = _near_init_variables(arch)
    x = np.random.default_rng(2).standard_normal((16, *INPUT_SHAPE)).astype(np.float32)
    want, updates = jmodel.apply(variables, jnp.asarray(x), train=True, return_logits=True,
                                 mutable=["batch_stats"])
    model = build_model(_param(arch, dropout=0.0), INPUT_SHAPE)
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True, return_logits=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    new_stats = to_flax_variables(model.state_dict())["batch_stats"]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(updates["batch_stats"])[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(new_stats)[0])
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, leaf in flat_want.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(leaf), atol=1e-6, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_trunk_head_split_matches_flax_and_composes(arch):
    jmodel, variables = _random_variables(arch)
    x = np.random.default_rng(3).standard_normal((2, *INPUT_SHAPE)).astype(np.float32)
    j_trunk = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False, trunk_only=True))
    j_head = np.asarray(jmodel.apply(variables, jnp.asarray(j_trunk), train=False,
                                     head_input=True))
    model = _torch_model(arch, variables)
    with torch.no_grad():
        full = model(torch.from_numpy(x))
        trunk = model(torch.from_numpy(x), trunk_only=True)
        composed = model(trunk, head_input=True)
        from_flax_trunk = model(torch.from_numpy(j_trunk.copy()), head_input=True)
    assert trunk.shape == j_trunk.shape == (2, 2, 2, 36)  # NHWC, as flax
    np.testing.assert_allclose(trunk.numpy(), j_trunk, atol=2e-5, rtol=0)
    np.testing.assert_allclose(from_flax_trunk.numpy(), j_head, atol=2e-5, rtol=0)
    assert torch.equal(composed, full)


def test_trunk_frequency_axis_is_not_square():
    """A trunk output whose time and frequency sizes differ: the head's
    frequency-major reshape and ResNet1DConv's frequency mean would go
    wrong on the other axis."""
    shape = (64, 40, 1)  # trunk output (4, 3, 36)
    for arch in ARCHS:
        jmodel, variables = _random_variables(arch, shape=shape)
        x = np.random.default_rng(4).standard_normal((2, *shape)).astype(np.float32)
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = _torch_model(arch, variables, shape)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 4, 2)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_l2_regularization_matches_reference(arch):
    _, variables = _random_variables(arch)
    want = float(jax_l2_regularization(variables["params"]))
    got = float(_l2(_torch_model(arch, variables)))
    assert got == pytest.approx(want, rel=1e-6)
    if arch == "ResNet1DConv":
        assert got == 0.0
    else:
        assert got > 0.0


def test_l2_counts_input_kernels_and_the_layer_named_dense_only():
    model = _torch_model("ResNetLSTM", _random_variables("ResNetLSTM")[1])
    base = float(_l2(model))
    with torch.no_grad():
        for p in (model.bilstm1.fwd.weight_hh, model.out.weight, model.dense_bn.weight,
                  model.bilstm2.bwd.bias_ih, model.trunk.entry_conv.weight):
            p.add_(1.0)
    assert float(_l2(model)) == pytest.approx(base, rel=1e-7)
    with torch.no_grad():
        model.dense.weight.add_(1.0)
    assert float(_l2(model)) > base
    tcn = _torch_model("ResNetTCN", _random_variables("ResNetTCN")[1])
    base = float(_l2(tcn))
    with torch.no_grad():
        tcn.proj.weight.add_(1.0)
    assert float(_l2(tcn)) == pytest.approx(base, rel=1e-7)


def test_build_model_takes_three_names_and_raises_for_another():
    from orcai_tpu_torch.models import ORCAI_ARCHITECTURES

    assert sorted(ORCAI_ARCHITECTURES) == sorted(ARCHS)
    for arch in ARCHS:
        assert type(build_model(_param(arch), INPUT_SHAPE)).__name__ == arch
    with pytest.raises(ValueError, match="Unknown model architecture: ResNetGRU"):
        build_model(_param("ResNetGRU"), INPUT_SHAPE)


@pytest.mark.parametrize("arch", ARCHS)
def test_to_flax_variables_inverts_convert(arch):
    _, variables = _random_variables(arch)
    variables = jax.tree.map(np.asarray, variables)
    back = to_flax_variables(convert_flax_variables(variables))
    _assert_trees_equal(back, variables)


def test_to_flax_variables_inverts_convert_on_orcai_v1():
    variables = load_variables(MODELS_DATA_DIR / "orcai-v1" / "orcai-v1.msgpack")
    state = convert_flax_variables(variables)
    _assert_trees_equal(to_flax_variables(state), variables)
    # and from tensors, as a trained model hands them over
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    _assert_trees_equal(to_flax_variables(tensors), variables)


def test_one_dimensional_conv_kernels_are_transposed_both_ways():
    _, variables = _random_variables("ResNetTCN")
    k = np.asarray(variables["params"]["tcn2_conv"]["kernel"])  # (k, in, out)
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    w = state["tcn2_conv.weight"]  # (out, in, k)
    assert k.shape == (3, 4, 4) and w.shape == (4, 4, 3)
    np.testing.assert_array_equal(w, k.transpose(2, 1, 0))
    _, variables = _random_variables("ResNet1DConv")
    k = np.asarray(variables["params"]["out_conv1d"]["kernel"])
    w = convert_flax_variables(jax.tree.map(np.asarray, variables))["out_conv1d.weight"]
    assert k.shape == (36, 36, 2) and w.shape == (2, 36, 36)
    np.testing.assert_array_equal(w, k.transpose(2, 1, 0))


def test_export_refuses_a_nonzero_second_lstm_bias():
    state = _torch_model("ResNetLSTM", _random_variables("ResNetLSTM")[1]).state_dict()
    state["bilstm1.fwd.bias_hh"] = state["bilstm1.fwd.bias_hh"] + 0.5
    with pytest.raises(ValueError, match="bias_hh is not zero"):
        to_flax_variables(state)
    with pytest.raises(ValueError, match="unknown state-dict key"):
        to_flax_variables({"trunk.entry_bn.num_batches_tracked": np.zeros(1)})


@pytest.mark.parametrize("arch", ARCHS)
def test_model_dir_written_by_the_port_loads_in_the_jax_package_and_back(arch, tmp_path):
    param = _param(arch)
    model = init_variables(build_model(param, INPUT_SHAPE), seed=7)
    with torch.no_grad():  # statistics away from their initial 0 / 1
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
            elif name.endswith("running_mean"):
                buf.normal_(generator=torch.Generator().manual_seed(2))
    model_dir = tmp_path / param["name"]
    save_orcai_model(model_dir, param, model.state_dict(), input_shape=INPUT_SHAPE,
                     train_state={"epochs_run": 0})
    assert sorted(p.name for p in model_dir.iterdir()) == sorted(
        [f"{param['name']}.msgpack", "model_shape.json", "orcai_parameter.json",
         "train_state.json"])
    assert json.loads((model_dir / "model_shape.json").read_text()) == {
        "input_shape": list(INPUT_SHAPE), "num_labels": 2}

    x = np.random.default_rng(5).standard_normal((2, *INPUT_SHAPE)).astype(np.float32)
    with torch.no_grad():
        own = model(torch.from_numpy(x)).numpy()
    jmodel, jvars, jparam, jshape = jax_load_orcai_model(model_dir)
    assert jparam == param and jshape["input_shape"] == list(INPUT_SHAPE)
    np.testing.assert_allclose(np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False)),
                               own, atol=2e-5, rtol=0)
    # the JAX package writes it again, the port reads that
    back_dir = tmp_path / "back" / param["name"]
    jax_save_orcai_model(back_dir, jparam, jvars, input_shape=INPUT_SHAPE)
    loaded, _, _ = load_orcai_model(back_dir, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    # and the port reads its own directory
    again, _, _ = load_orcai_model(model_dir, device="cpu")
    with torch.no_grad():
        assert np.array_equal(again(torch.from_numpy(x)).numpy(), own)


def test_saved_msgpack_is_byte_equal_to_flax_serialization(tmp_path):
    import flax.serialization

    param = _param("ResNetTCN")
    model = init_variables(build_model(param, INPUT_SHAPE), seed=1)
    save_orcai_model(tmp_path / "m", param, model.state_dict(), input_shape=INPUT_SHAPE)
    variables = to_flax_variables(model.state_dict())
    assert (tmp_path / "m" / f"{param['name']}.msgpack").read_bytes() == \
        flax.serialization.to_bytes(variables)


def test_optimizer_state_goes_to_opt_pt(tmp_path):
    from orcai_tpu_torch.train.trainer import make_optimizer

    param = _param("ResNetLSTM")
    model = init_variables(build_model(param, INPUT_SHAPE), seed=1)
    opt = make_optimizer(model, 1e-3)
    save_orcai_model(tmp_path / "m", param, model.state_dict(), input_shape=INPUT_SHAPE,
                     opt_state=opt.state_dict())
    loaded = torch.load(tmp_path / "m" / f"{param['name']}.opt.pt")
    assert loaded["param_groups"][0]["lr"] == 1e-3
    assert not (tmp_path / "m" / f"{param['name']}.opt.msgpack").exists()


@pytest.mark.parametrize("arch", ARCHS)
def test_predict_runs_with_a_checkpoint_of_each_architecture(arch, tmp_path):
    """`predict` on the golden wav with a narrow model of each architecture
    at the bundled input shape, written by the port's own save."""
    from pathlib import Path

    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.pipeline.predict import predict

    bundled = read_json(MODELS_DATA_DIR / "orcai-v1" / "orcai_parameter.json")
    param = dict(bundled, name=f"narrow-{arch}", architecture=arch,
                 model=dict(bundled["model"], filters=[2, 3, 4, 5], lstm_units=4))
    model = init_variables(build_model(param, (736, 171, 1)), seed=2)
    model_dir = tmp_path / param["name"]
    save_orcai_model(model_dir, param, model.state_dict(), input_shape=(736, 171, 1))
    wav = Path(__file__).parent / "fixtures" / "golden.wav"
    out = predict(wav, model_dir=model_dir, output_path=tmp_path / "pred.txt",
                  predict_batch_size=16, device="cpu")
    lines = out.read_text().splitlines()
    assert lines[0].split("\t") == ["start", "stop", "label"]
