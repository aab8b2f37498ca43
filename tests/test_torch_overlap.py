"""Port WindowPredictor (orcai_tpu_torch/ops/overlap.py) vs the JAX one on
the same spectrogram and weights: overlap counts exact, aggregated
probabilities within 2e-5 (tests/test_dense_trunk.py:136)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orcai_tpu.models import build_model as jax_build_model
from orcai_tpu.ops.overlap import WindowPredictor as JaxWindowPredictor
from orcai_tpu_torch.io.model_store import convert_flax_variables
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.ops.overlap import WindowPredictor

PARAM = {
    "name": "tiny",
    "architecture": "ResNetLSTM",
    "model": {"filters": [4, 6, 8, 10], "kernel_size": 3, "dropout_rate": 0.5,
              "lstm_units": 8},
    "calls": ["A", "B", "C"],
}
SNIPPET, NBINS, NFILT = 64, 21, 4


def setup_module():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(PARAM)
    template = jmodel.init(jax.random.key(0), jnp.zeros((1, SNIPPET, NBINS, 1)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        if "var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, template)
    model = build_model(PARAM, (SNIPPET, NBINS, 1))
    state = convert_flax_variables(jax.tree.map(np.asarray, variables))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return jmodel, variables, model.eval()


@pytest.mark.parametrize(
    "t,batch,cap",
    [
        (319, 4, 2048),  # n_win 8 = wpc and a tail past the last window
        (400, 3, 2048),  # padding windows of the last batch -> trash row
        (13 * 32 + 32, 4, 8),  # 13 windows: one full 8-window chunk + remainder
    ],
)
def test_aggregate_matches_jax(models, t, batch, cap):
    jmodel, variables, model = models
    spec = np.random.default_rng(t).random((t, NBINS), np.float32)
    ours = WindowPredictor(model, snippet_len=SNIPPET, n_filters=NFILT,
                           batch_size=batch, max_windows_per_chunk=cap)
    ref = JaxWindowPredictor(jmodel, variables, snippet_len=SNIPPET,
                             n_filters=NFILT, batch_size=batch,
                             max_windows_per_chunk=cap, dense_trunk=False)
    assert ours.plan(t) == ref.plan(t)
    agg, count = ours.aggregate(spec)
    ref_agg, ref_count = ref.aggregate(spec)
    assert agg.shape == ref_agg.shape == (t // 16, 3)
    np.testing.assert_array_equal(count, ref_count)
    np.testing.assert_allclose(agg, ref_agg, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(
        ours.binary_predictions(agg, count),
        ref.binary_predictions(ref_agg, ref_count),
    )
    # a device-resident, bucket-padded spectrogram gives the same result
    padded = torch.zeros((t + 100, NBINS))
    padded[:t] = torch.from_numpy(spec)
    agg2, count2 = ours.aggregate(padded, n_frames=t)
    np.testing.assert_array_equal(count2, count)
    np.testing.assert_array_equal(agg2, agg)


def test_plan_matches_jax_everywhere(models):
    jmodel, variables, model = models
    for batch, cap in ((1, 2048), (16, 2048), (128, 2048), (5, 64)):
        ours = WindowPredictor(model, snippet_len=SNIPPET, n_filters=NFILT,
                               batch_size=batch, max_windows_per_chunk=cap)
        ref = JaxWindowPredictor(jmodel, variables, snippet_len=SNIPPET,
                                 n_filters=NFILT, batch_size=batch,
                                 max_windows_per_chunk=cap, dense_trunk=False)
        assert ours.max_windows_per_chunk == ref.max_windows_per_chunk
        for t in range(SNIPPET, 20_000, 97):
            assert ours.plan(t) == ref.plan(t), (batch, cap, t)


def test_geometry_checks(models):
    _, _, model = models
    with pytest.raises(ValueError, match="divisible"):
        WindowPredictor(model, snippet_len=60, n_filters=NFILT)
    ours = WindowPredictor(model, snippet_len=SNIPPET, n_filters=NFILT)
    with pytest.raises(ValueError, match="too short"):
        ours.aggregate(np.zeros((SNIPPET - 1, NBINS), np.float32))


def _both(models, batch, cap):
    jmodel, variables, model = models
    ours = WindowPredictor(model, snippet_len=SNIPPET, n_filters=NFILT,
                           batch_size=batch, max_windows_per_chunk=cap)
    ref = JaxWindowPredictor(jmodel, variables, snippet_len=SNIPPET,
                             n_filters=NFILT, batch_size=batch,
                             max_windows_per_chunk=cap, dense_trunk=False)
    return ours, ref


@pytest.mark.parametrize("batch,cap", [(1, 2048), (16, 2048), (128, 2048), (5, 64)])
def test_plan_signature_and_spec_bytes_match_jax(models, batch, cap):
    """plan_signature and planned_spec_bytes, host arithmetic that the
    warm-up and the wave budget rest on, equal the JAX methods for source
    buffers below, at and above the plan's power-of-two span."""
    ours, ref = _both(models, batch, cap)
    for t in range(SNIPPET, 40_000, 211):
        for src_len in (t, 2048, 4096, 8192, 65536):
            if src_len < t:
                continue
            assert ours.plan_signature(t, src_len) == ref.plan_signature(t, src_len)
            assert (ours.planned_spec_bytes(t, NBINS, src_len)
                    == ref.planned_spec_bytes(t, NBINS, src_len))


def test_n_labels_matches_jax(models):
    ours, ref = _both(models, 4, 2048)
    assert ours.n_labels(NBINS) == ref.n_labels(NBINS) == 3


def test_chunk_frame_offset_is_separate_from_window_index(models):
    """A chunk handed in as its own tile (frame offset 0, the real window
    index) scatters into the same rows as the chunk cut from the whole
    spectrogram: what the streaming path relies on."""
    _, _, model = models
    ours = WindowPredictor(model, snippet_len=SNIPPET, n_filters=NFILT,
                           batch_size=4, max_windows_per_chunk=8)
    t = 21 * 32 + 32  # 21 windows: chunks of 8, 8 and a remainder
    spec = torch.from_numpy(np.random.default_rng(1).random((t, NBINS), np.float32))
    agg0, count0, n_out = ours.aggregate_device(spec, n_frames=t)
    n_win, _, required, _ = ours.plan(t)
    padded = torch.zeros((required, NBINS))
    padded[:t] = spec
    agg1, count1 = ours._zero_grid(agg0.shape[0] - 1, 3)
    wpc = 8
    with torch.inference_mode():
        for w0 in range(0, n_win, wpc):
            tile = padded[w0 * ours.shift : (w0 + wpc + 1) * ours.shift].clone()
            ours._run_chunk(agg1, count1, tile, wpc, 0, w0, min(wpc, n_win - w0))
    np.testing.assert_array_equal(count1[:n_out].numpy(), count0[:n_out].numpy())
    np.testing.assert_array_equal(agg1[:n_out].numpy(), agg0[:n_out].numpy())
