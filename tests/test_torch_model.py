"""Port ResNetLSTM forward (orcai_tpu_torch/models) vs flax apply, float32
on the CPU, atol 2e-5 (tests/test_model_parity.py:59)."""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from orcai_tpu.io.model_store import load_orcai_model as jax_load_orcai_model
from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.resources import MODELS_DATA_DIR
from orcai_tpu_torch.io.model_store import convert_flax_variables, load_orcai_model
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.models.crnn import max_pool_same

NARROW = {
    "name": "narrow",
    "architecture": "ResNetLSTM",
    "model": {"filters": [8, 8], "kernel_size": 3, "dropout_rate": 0.5,
              "lstm_units": 16},
    "calls": ["A", "B", "C"],
}


def setup_module():
    torch.set_num_threads(1)


def _torch_model(param, variables, input_shape):
    model = build_model(param, input_shape)
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def test_narrow_random_model_matches_flax():
    """filters (8, 8), lstm 16; every weight drawn with numpy."""
    shape = (64, 21, 1)
    jmodel = jax_build_model(NARROW)
    template = jmodel.init(jax.random.key(0), jnp.zeros((1, *shape)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "var" in name:  # BatchNorm variances must stay positive
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, template)
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = _torch_model(NARROW, variables, shape)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_orcai_v1_weights_match_flax():
    jmodel, jvars, _, _ = jax_load_orcai_model(MODELS_DATA_DIR / "orcai-v1")
    model, _, shape = load_orcai_model(device="cpu")
    x = np.random.default_rng(1).random((2, *shape["input_shape"]), np.float32)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 46, 7)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("hw", [(736, 171), (46, 11), (7, 6), (8, 9)])
def test_max_pool_same_matches_flax(hw):
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 2), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unported_architecture_rejected():
    """All three of the reference's architectures build; any other name is
    refused with the reference's message."""
    for arch in ("ResNetLSTM", "ResNet1DConv", "ResNetTCN"):
        assert type(build_model(dict(NARROW, architecture=arch))).__name__ == arch
    with pytest.raises(ValueError, match="Unknown model architecture: ResNetGRU"):
        build_model(dict(NARROW, architecture="ResNetGRU"))


@pytest.mark.parametrize("btd", [(3, 11, 5), (1, 46, 9)])
def test_lstm_layer_matches_flax(btd):
    """The Keras-semantics BiLSTM alone (both scan directions, concat)."""
    from orcai_tpu.models.layers import BiLSTM as JaxBiLSTM
    from orcai_tpu_torch.models.layers import BiLSTM

    rng = np.random.default_rng(3)
    x = rng.standard_normal(btd).astype(np.float32)
    jlayer = JaxBiLSTM(7)
    params = jax.tree.map(
        lambda a: (0.4 * rng.standard_normal(a.shape)).astype(np.float32),
        jlayer.init(jax.random.key(0), jnp.asarray(x)),
    )
    want = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    layer = BiLSTM(btd[2], 7)
    state = {}
    for scope, name in (("forward", "fwd"), ("backward", "bwd")):
        p = params["params"][scope]
        state[f"{name}.weight_ih"] = torch.from_numpy(p["kernel"].T.copy())
        state[f"{name}.weight_hh"] = torch.from_numpy(p["recurrent_kernel"].T.copy())
        state[f"{name}.bias_ih"] = torch.from_numpy(p["bias"])
        state[f"{name}.bias_hh"] = torch.zeros(28)
    layer.load_state_dict(state)
    with torch.inference_mode():
        got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == (*btd[:2], 14)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
