"""Training mode of the port's layers (orcai_tpu_torch/models/layers.py)
against the flax layers on the CPU: BatchNorm with batch statistics (output
and new running statistics, atol 1e-6), the generator-driven dropout, the
frozen biases, the one-bias LSTM, SAME padding of the 1-D convs (2e-5), and
the initialisers of models/crnn.py::init_variables."""

import math

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from orcai_tpu_torch.models import build_model, init_variables
from orcai_tpu_torch.models.layers import (
    BatchNorm,
    BiLSTM,
    Conv1d,
    Dropout,
    FrozenBiasConv,
    LSTM,
    SeparableConv,
)

PARAM = {
    "name": "layers",
    "architecture": "ResNetLSTM",
    "model": {"filters": [2, 3, 4, 5], "kernel_size": 3, "dropout_rate": 0.25,
              "lstm_units": 4},
    "calls": ["A", "B"],
}


def setup_module():
    torch.set_num_threads(1)


# (64, 46, 8) is dense_bn's shape at batch 64: 2944 values a channel, whose
# largest outputs reach +-4, where 1e-6 is four float32 ulps. There the port
# is up to 1.2e-6 from flax, and flax itself about 1e-6 from a float64
# reference (the next test), so that case is pinned at 2e-6 (ROADMAP C).
@pytest.mark.parametrize("shape,atol", [((4, 6, 5, 3), 1e-6), ((3, 7, 5), 1e-6),
                                        ((64, 46, 8), 2e-6)],
                         ids=["image", "sequence", "batch64_sequence"])
@pytest.mark.parametrize("steps", [1, 3])
def test_batchnorm_training_matches_flax(shape, atol, steps):
    """Channel-last input through flax, channel-first through the port."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    layer = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.0, c).astype(np.float32),
                   "bias": (0.3 * rng.standard_normal(c)).astype(np.float32)},
        "batch_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)},
    }
    bn = BatchNorm(c)
    bn.load_state_dict({
        "weight": torch.from_numpy(variables["params"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bias"]),
        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(variables["batch_stats"]["var"]),
    })
    to_first = (0, len(shape) - 1, *range(1, len(shape) - 1))
    to_last = (0, *range(2, len(shape)), 1)
    for _ in range(steps):
        x = (1.5 * rng.standard_normal(shape) + 0.7).astype(np.float32)
        want, updates = layer.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], **updates}
        got = bn(torch.from_numpy(x).permute(*to_first), train=True).permute(*to_last)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]), atol=1e-6, rtol=0)


def test_batchnorm_batch64_is_as_close_to_float64_as_flax_is():
    """Why the batch-64 case above cannot hold 1e-6: against a float64
    normalization of the same batch, flax and the port are each within
    1.5e-6 and neither is closer than 2e-7."""
    rng = np.random.default_rng(0)
    scale = rng.uniform(0.5, 1.0, 8).astype(np.float32)
    bias = (0.3 * rng.standard_normal(8)).astype(np.float32)
    x = (1.5 * rng.standard_normal((64, 46, 8)) + 0.7).astype(np.float32)
    layer = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}}
    flax_y, _ = layer.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(8)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.zeros(8), "running_var": torch.ones(8)})
    port_y = bn(torch.from_numpy(x).transpose(1, 2), train=True).transpose(1, 2)
    x64 = x.astype(np.float64)
    exact = (x64 - x64.mean((0, 1))) / np.sqrt(x64.var((0, 1)) + 1e-3) * scale + bias
    flax_err = np.abs(np.asarray(flax_y) - exact).max()
    port_err = np.abs(port_y.detach().numpy() - exact).max()
    assert 2e-7 < flax_err < 1.5e-6
    assert 2e-7 < port_err < 1.5e-6


def test_batchnorm_running_variance_is_the_biased_one():
    """F.batch_norm would store n / (n - 1) times the batch variance with a
    weight of its own momentum; the port stores flax's 0.99 / 0.01 mix of
    the biased one."""
    x = torch.tensor([[1.0], [3.0]]).reshape(2, 1, 1)  # n = 2, biased var 1, unbiased 2
    bn = BatchNorm(1)
    bn(x, train=True)
    assert bn.running_var.item() == pytest.approx(0.99 * 1.0 + 0.01 * 1.0, abs=1e-7)
    assert bn.running_mean.item() == pytest.approx(0.01 * 2.0, abs=1e-7)


def test_batchnorm_eval_leaves_statistics_alone():
    bn = BatchNorm(3)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    bn(torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0)))
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k])


def test_batchnorm_gradients_match_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 4, 3)).astype(np.float32)
    w = rng.standard_normal((5, 4, 3)).astype(np.float32)
    layer = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = layer.init(jax.random.key(0), jnp.asarray(x))

    def loss(params, xin):
        y, _ = layer.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           xin, mutable=["batch_stats"])
        return jnp.sum(y * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    bn = BatchNorm(3)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt.transpose(1, 2), train=True).transpose(1, 2)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=2e-5, rtol=0)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(g_params["scale"]),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(g_params["bias"]),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    drop = Dropout(rate)
    drop.generator = torch.Generator().manual_seed(3)
    x = torch.ones(200, 500)
    y = drop(x, train=True)
    kept = y != 0
    assert kept.float().mean().item() == pytest.approx(1 - rate, abs=0.01)
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    assert y.mean().item() == pytest.approx(1.0, abs=0.02)


def test_dropout_same_mask_from_same_generator_state():
    drop = Dropout(0.5)
    drop.generator = torch.Generator().manual_seed(11)
    x = torch.ones(64, 32)
    state = drop.generator.get_state()
    first, second = drop(x, train=True), drop(x, train=True)
    assert not torch.equal(first, second)
    drop.generator.set_state(state)
    assert torch.equal(drop(x, train=True), first)
    assert torch.equal(drop(x, train=True), second)


def test_dropout_identity_outside_training_and_at_rate_zero():
    x = torch.arange(12.0).reshape(3, 4)
    assert Dropout(0.5)(x) is x
    assert Dropout(0.0)(x, train=True) is x


def test_dropout_needs_its_generator():
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.5)(torch.ones(2, 2), train=True)
    with pytest.raises(ValueError):
        Dropout(1.0)


def test_dropout_does_not_touch_the_global_generator():
    drop = Dropout(0.5)
    drop.generator = torch.Generator().manual_seed(0)
    before = torch.random.get_rng_state()
    drop(torch.ones(8, 8), train=True)
    assert torch.equal(torch.random.get_rng_state(), before)


def test_model_sets_one_generator_on_every_dropout():
    model = build_model(dict(PARAM, architecture="ResNet1DConv"), (32, 21, 1))
    g = torch.Generator().manual_seed(0)
    model.set_dropout_generator(g)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    assert len(drops) == 2  # the trunk's block dropout and the head's
    assert all(d.generator is g for d in drops)


@pytest.mark.parametrize("arch", ["ResNetLSTM", "ResNet1DConv", "ResNetTCN"])
def test_frozen_biases_and_trainable_ones(arch):
    """Biases in front of a BatchNorm in the trunk are read, never trained;
    the shortcut convs', the LSTMs', the dense layers' and the 1-D convs'
    stay trainable."""
    model = build_model(dict(PARAM, architecture=arch), (32, 21, 1))
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    want = {"trunk.entry_conv.bias", "trunk.head_sep.pointwise.bias"}
    for b in range(4):
        want |= {f"trunk.block{b}_sep1.pointwise.bias", f"trunk.block{b}_sep2.pointwise.bias"}
    assert frozen == want
    names = {n for n, _ in model.named_parameters()}
    for b in range(4):
        assert f"trunk.block{b}_shortcut.bias" in names - frozen
    head = {"ResNetLSTM": ["bilstm1.fwd.bias_ih", "bilstm2.bwd.bias_ih", "dense.bias", "out.bias"],
            "ResNet1DConv": ["out_conv1d.bias"],
            "ResNetTCN": ["proj.bias", "tcn0_conv.bias", "tcn4_conv.bias", "dense.bias"]}[arch]
    for n in head:
        assert n in names - frozen


def test_frozen_bias_gets_no_gradient_but_is_read():
    conv = FrozenBiasConv(1, 2, 3)
    sep = SeparableConv(2, 3, 3)
    with torch.no_grad():
        conv.weight.normal_(generator=torch.Generator().manual_seed(0))
        conv.bias.copy_(torch.tensor([5.0, -5.0]))
        sep.depthwise.weight.fill_(0.1)
        sep.pointwise.weight.fill_(0.1)
    x = torch.zeros(1, 1, 4, 4)
    y = conv(x)
    assert torch.allclose(y[0, :, 1, 1], torch.tensor([5.0, -5.0]))
    sep(y).sum().backward()
    assert conv.bias.grad is None and sep.pointwise.bias.grad is None
    assert conv.weight.grad is not None and sep.pointwise.weight.grad is not None


def test_lstm_second_bias_is_a_zero_buffer():
    layer = LSTM(5, 3)
    assert "bias_hh" not in dict(layer.named_parameters())
    assert "bias_hh" in dict(layer.named_buffers())
    assert "bias_hh" in layer.state_dict()
    assert not layer.bias_hh.any()


def test_bilstm_gradients_match_flax():
    """Training-mode call (the flag reaches torch.lstm) and its backward."""
    from orcai_tpu.models.layers import BiLSTM as JaxBiLSTM

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6, 5)).astype(np.float32)
    w = rng.standard_normal((3, 6, 8)).astype(np.float32)
    jlayer = JaxBiLSTM(4)
    params = jax.tree.map(
        lambda a: (0.4 * rng.standard_normal(a.shape)).astype(np.float32),
        jlayer.init(jax.random.key(0), jnp.asarray(x)),
    )
    grads = jax.grad(lambda p: jnp.sum(jlayer.apply(p, jnp.asarray(x)) * w))(params)
    layer = BiLSTM(5, 4)
    state = {}
    for scope, name in (("forward", "fwd"), ("backward", "bwd")):
        p = params["params"][scope]
        state[f"{name}.weight_ih"] = torch.from_numpy(np.ascontiguousarray(p["kernel"].T))
        state[f"{name}.weight_hh"] = torch.from_numpy(np.ascontiguousarray(p["recurrent_kernel"].T))
        state[f"{name}.bias_ih"] = torch.from_numpy(np.asarray(p["bias"]))
        state[f"{name}.bias_hh"] = torch.zeros(16)
    layer.load_state_dict(state)
    (layer(torch.from_numpy(x), train=True) * torch.from_numpy(w)).sum().backward()
    for scope, name in (("forward", layer.fwd), ("backward", layer.bwd)):
        g = grads["params"][scope]
        np.testing.assert_allclose(name.weight_ih.grad.numpy(), np.asarray(g["kernel"]).T,
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(name.weight_hh.grad.numpy(),
                                   np.asarray(g["recurrent_kernel"]).T, atol=2e-5, rtol=0)
        np.testing.assert_allclose(name.bias_ih.grad.numpy(), np.asarray(g["bias"]),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("kernel,dilation", [(36, 1), (4, 1), (3, 1), (3, 4), (3, 16)])
def test_conv1d_same_padding_matches_flax(kernel, dilation):
    """Even kernels pad (k - 1) // 2 low and k // 2 high; dilated ones their
    dilation on both sides."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 46, 6)).astype(np.float32)
    layer = nn.Conv(5, (kernel,), kernel_dilation=(dilation,), padding="SAME")
    params = jax.tree.map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        layer.init(jax.random.key(0), jnp.asarray(x)),
    )
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    conv = Conv1d(6, 5, kernel, dilation)
    conv.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(
            np.asarray(params["params"]["kernel"]).transpose(2, 1, 0))),
        "bias": torch.from_numpy(np.asarray(params["params"]["bias"])),
    })
    with torch.no_grad():
        got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 46, 5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


# ------------------------------------------------------------ initialisers

WIDE = {
    "name": "wide", "architecture": "ResNetLSTM",
    "model": {"filters": [30, 40, 50, 60], "kernel_size": 3, "dropout_rate": 0.5,
              "lstm_units": 128},
    "calls": list("ABCDEFG"),
}


@pytest.fixture(scope="module")
def fresh():
    return init_variables(build_model(WIDE, (736, 171, 1)), seed=3)


def test_init_is_a_function_of_the_seed():
    a = init_variables(build_model(PARAM, (32, 21, 1)), seed=5).state_dict()
    b = init_variables(build_model(PARAM, (32, 21, 1)), seed=5).state_dict()
    c = init_variables(build_model(PARAM, (32, 21, 1)), seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("name,fan_in", [
    ("bilstm1.fwd.weight_ih", None),  # glorot, below
    ("dense.weight", 256),
    ("trunk.block3_sep2.pointwise.weight", 60),
    ("trunk.block3_shortcut.weight", 50),
    ("trunk.head_sep.pointwise.weight", 60),
])
def test_init_standard_deviations(fresh, name, fan_in):
    w = fresh.state_dict()[name]
    if fan_in is None:
        four_u, d = w.shape
        limit = math.sqrt(6.0 / (d + four_u))
        assert w.abs().max().item() <= limit
        assert w.std().item() == pytest.approx(limit / math.sqrt(3.0), rel=0.02)
    else:
        # lecun normal: variance 1 / fan_in, truncated at two sigma of the
        # untruncated draw (2 / 0.8796 of the result's)
        sigma = math.sqrt(1.0 / fan_in)
        assert w.std().item() == pytest.approx(sigma, rel=0.05)
        assert w.abs().max().item() <= 2.0 * sigma / 0.87962566103423978 + 1e-6
    assert abs(w.mean().item()) < 0.1 * w.std().item() + 1e-3


def test_init_depthwise_fan_in_is_the_kernel_cells(fresh):
    w = torch.cat([fresh.state_dict()[f"trunk.block{b}_sep{s}.depthwise.weight"].reshape(-1)
                   for b in range(4) for s in (1, 2)])
    assert w.std().item() == pytest.approx(math.sqrt(1.0 / 9.0), rel=0.05)


def test_init_recurrent_kernel_is_orthogonal(fresh):
    for layer in (fresh.bilstm1.fwd, fresh.bilstm2.bwd):
        w = layer.weight_hh.detach().double()  # (4U, U): flax's (U, 4U) transposed
        np.testing.assert_allclose((w.T @ w).numpy(), np.eye(w.shape[1]), atol=1e-5)


def test_init_forget_gate_ones_and_zero_biases(fresh):
    state = fresh.state_dict()
    for name in ("bilstm1.fwd", "bilstm1.bwd", "bilstm2.fwd", "bilstm2.bwd"):
        b = state[f"{name}.bias_ih"]
        assert torch.equal(b[128:256], torch.ones(128))
        assert not b[:128].any() and not b[256:].any()
        assert not state[f"{name}.bias_hh"].any()
    for name, v in state.items():
        if name.endswith(".bias") and "bn" not in name:
            assert not v.any(), name
        if name.endswith("running_var") or (name.endswith("bn.weight") or "_bn" in name and name.endswith(".weight")):
            assert torch.equal(v, torch.ones_like(v)), name
        if name.endswith("running_mean"):
            assert not v.any(), name


def test_init_draws_nothing_from_the_global_generator():
    model = build_model(PARAM, (32, 21, 1))
    before = torch.random.get_rng_state()
    init_variables(model, seed=1)
    assert torch.equal(torch.random.get_rng_state(), before)
