"""The six functions of orcai_tpu_torch/ops/losses.py against
orcai_tpu/ops/losses.py on the same numpy inputs, rtol 1e-5
(tests/test_losses.py), with masked positions, call weights, saturated
probabilities and fully masked inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orcai_tpu.ops import losses as jax_losses
from orcai_tpu_torch.ops import losses
from orcai_tpu_torch.utils.seeds import MASK_VALUE

RTOL = 1e-5


def _case(seed, shape=(6, 46, 7), mask_share=0.2, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal(shape)).astype(np.float32)
    y = rng.integers(0, 2, shape).astype(np.float32)
    y[rng.uniform(size=shape) < mask_share] = MASK_VALUE
    return logits, y


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _sigmoid(z):
    return (1.0 / (1.0 + np.exp(-z.astype(np.float64)))).astype(np.float32)


CASES = {
    "plain": _case(0),
    "unmasked": _case(1, mask_share=0.0),
    "mostly_masked": _case(2, mask_share=0.95),
    "large_logits": _case(3, scale=40.0),
    "two_labels": _case(4, shape=(8, 2, 2)),
}


@pytest.mark.parametrize("name", CASES)
def test_masked_bce_from_logits(name):
    logits, y = CASES[name]
    want = float(jax_losses.masked_bce_from_logits(jnp.asarray(logits), jnp.asarray(y)))
    got = float(losses.masked_bce_from_logits(_t(logits), _t(y)))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("name", CASES)
def test_masked_bce_from_probs(name):
    logits, y = CASES[name]
    probs = _sigmoid(logits)  # saturates to exactly 0 / 1 on the large logits
    want = float(jax_losses.masked_bce_from_probs(jnp.asarray(probs), jnp.asarray(y)))
    got = float(losses.masked_bce_from_probs(_t(probs), _t(y)))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_masked_binary_accuracy_and_counts(name, threshold):
    logits, y = CASES[name]
    probs = _sigmoid(logits)
    jc, jt = jax_losses.masked_binary_accuracy_counts(jnp.asarray(probs), jnp.asarray(y), threshold)
    c, t = losses.masked_binary_accuracy_counts(_t(probs), _t(y), threshold)
    assert (int(c), int(t)) == (int(jc), int(jt))
    want = float(jax_losses.masked_binary_accuracy(jnp.asarray(probs), jnp.asarray(y), threshold))
    got = float(losses.masked_binary_accuracy(_t(probs), _t(y), threshold))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_masked_bce_from_logits(name, weighted):
    logits, y = CASES[name]
    w = (np.random.default_rng(9).uniform(0.5, 4.0, logits.shape[-1]).astype(np.float32)
         if weighted else None)
    want = float(jax_losses.weighted_masked_bce_from_logits(
        jnp.asarray(logits), jnp.asarray(y), None if w is None else jnp.asarray(w)))
    got = float(losses.weighted_masked_bce_from_logits(
        _t(logits), _t(y), None if w is None else _t(w)))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("num_thresholds", [200, 50])
def test_masked_auc_roc(name, num_thresholds):
    logits, y = CASES[name]
    probs = _sigmoid(logits)
    want = float(jax_losses.masked_auc_roc(jnp.asarray(probs), jnp.asarray(y), num_thresholds))
    got = float(losses.masked_auc_roc(_t(probs), _t(y), num_thresholds))
    assert got == pytest.approx(want, rel=RTOL, abs=1e-7)


def test_everything_masked_gives_the_reference_values():
    logits, y = _case(5, shape=(2, 4, 3))
    y[:] = MASK_VALUE
    probs = _sigmoid(logits)
    pairs = [
        (losses.masked_bce_from_logits(_t(logits), _t(y)),
         jax_losses.masked_bce_from_logits(jnp.asarray(logits), jnp.asarray(y))),
        (losses.masked_bce_from_probs(_t(probs), _t(y)),
         jax_losses.masked_bce_from_probs(jnp.asarray(probs), jnp.asarray(y))),
        (losses.masked_binary_accuracy(_t(probs), _t(y)),
         jax_losses.masked_binary_accuracy(jnp.asarray(probs), jnp.asarray(y))),
        (losses.weighted_masked_bce_from_logits(_t(logits), _t(y), torch.ones(3)),
         jax_losses.weighted_masked_bce_from_logits(jnp.asarray(logits), jnp.asarray(y),
                                                    jnp.ones(3))),
        (losses.masked_auc_roc(_t(probs), _t(y)),
         jax_losses.masked_auc_roc(jnp.asarray(probs), jnp.asarray(y))),
    ]
    for got, want in pairs:
        assert float(got) == float(want) == 0.0


def test_auc_of_a_perfect_and_a_useless_scorer():
    y = torch.tensor([[0.0, 1.0, 0.0, 1.0, MASK_VALUE]])
    assert float(losses.masked_auc_roc(torch.tensor([[0.1, 0.9, 0.2, 0.8, 0.0]]), y)) \
        == pytest.approx(1.0, abs=1e-6)
    assert float(losses.masked_auc_roc(torch.full((1, 5), 0.5), y)) == pytest.approx(0.5, abs=1e-6)


def test_losses_return_device_scalars_with_gradients():
    logits, y = CASES["plain"]
    z = _t(logits).requires_grad_(True)
    loss = losses.weighted_masked_bce_from_logits(z, _t(y), torch.full((7,), 2.0))
    assert loss.shape == () and loss.dtype == torch.float32
    loss.backward()
    assert z.grad is not None
    assert not z.grad[_t(y) == MASK_VALUE].any()  # masked positions carry no gradient
