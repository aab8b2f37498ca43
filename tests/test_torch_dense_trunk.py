"""Dense-trunk inference of the port (orcai_tpu_torch/ops/overlap.py,
dense_trunk=True / ORCAI_TPU_DENSE_TRUNK=1) on the CPU with the bundled
orcai-v1 weights: the trunk/head split composes to the full forward, the
slab-stitched aggregate equals the JAX package's dense trunk (atol 2e-5,
tests/test_dense_trunk.py:113-136) and a monolithic dense trunk over the
whole padded spectrogram, and the golden wav's annotations stay in band."""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from orcai_tpu_torch.io.model_store import load_orcai_model
from orcai_tpu_torch.ops.overlap import WindowPredictor, _next_pow2

FIXTURES = Path(__file__).parent / "fixtures"


def setup_module():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def loaded():
    return load_orcai_model(device="cpu")


def _predictor(loaded, dense, batch_size=4, cap=2048):
    model, param, shape = loaded
    return WindowPredictor(
        model, snippet_len=shape["input_shape"][0],
        n_filters=len(param["model"]["filters"]), batch_size=batch_size,
        max_windows_per_chunk=cap, dense_trunk=dense,
    )


def _spec(predictor, n_win, n_bins, seed=11, extra=0):
    t = (n_win - 1) * predictor.shift + predictor.snippet_len + extra
    return np.random.default_rng(seed).random((t, n_bins), np.float32)


def test_trunk_head_split_composes_exactly(loaded):
    model, _, shape = loaded
    x = torch.from_numpy(np.random.default_rng(3).random((2, *shape["input_shape"]), np.float32))
    with torch.no_grad():
        full = model(x)
        trunk = model(x, trunk_only=True)
        composed = model(trunk, head_input=True)
    assert trunk.shape == (2, 46, 11, 36)
    assert torch.equal(composed, full)


def test_halo_and_slab_size_are_the_reference_s(loaded):
    import jax.numpy as jnp

    from orcai_tpu.io.model_store import load_orcai_model as jax_load
    from orcai_tpu.ops.overlap import WindowPredictor as JaxWindowPredictor
    from orcai_tpu.resources import MODELS_DATA_DIR

    jmodel, jvars, jparam, jshape = jax_load(MODELS_DATA_DIR / "orcai-v1", dtype=jnp.float32)
    ref = JaxWindowPredictor(jmodel, jvars, batch_size=128, dense_trunk=True)
    port = _predictor(loaded, True, batch_size=128)
    assert port.halo == ref.halo == 64
    for wpc in (4, 8, 128, 640, 2048, 48):
        assert port._dense_slab_windows(wpc) == ref._dense_slab_windows(wpc)


@pytest.mark.parametrize(
    "n_win,cap",
    [
        (8, 2048),  # single chunk, 2 slabs of 4
        (12, 8),    # two chunks (8 + ladder remainder 4): chunk-seam case
    ],
)
def test_dense_matches_the_jax_dense_trunk(loaded, n_win, cap):
    import jax.numpy as jnp

    from orcai_tpu.io.model_store import load_orcai_model as jax_load
    from orcai_tpu.ops.overlap import WindowPredictor as JaxWindowPredictor
    from orcai_tpu.resources import MODELS_DATA_DIR

    predictor = _predictor(loaded, True, cap=cap)
    assert predictor.dense_trunk
    spec = _spec(predictor, n_win, loaded[2]["input_shape"][1])
    agg, count = predictor.aggregate(spec)

    jmodel, jvars, jparam, jshape = jax_load(MODELS_DATA_DIR / "orcai-v1", dtype=jnp.float32)
    ref = JaxWindowPredictor(
        jmodel, jvars, snippet_len=jshape["input_shape"][0],
        n_filters=len(jparam["model"]["filters"]), batch_size=4,
        max_windows_per_chunk=cap, dense_trunk=True,
    )
    want_agg, want_count = ref.aggregate(spec)
    np.testing.assert_array_equal(count, want_count)
    np.testing.assert_allclose(agg, want_agg, atol=2e-5, rtol=0)


def _monolithic_dense_reference(model, predictor, spec):
    """Overlap-add with ONE dense trunk over the whole padded spectrogram:
    it shares no slab or halo algebra with the code under test."""
    t, n_bins = spec.shape
    n_win, _, required, _ = predictor.plan(t)
    target = max(_next_pow2(required), t)
    h = predictor.halo
    padded = np.zeros((h + target + h, n_bins), np.float32)
    padded[h : h + t] = spec
    with torch.no_grad():
        steps = model(torch.from_numpy(padded)[None, :, :, None], trunk_only=True)[0]
        steps = steps[h // predictor.down :]
        so, ol = predictor.shift_out, predictor.out_len
        n_out = t // predictor.down
        acc = np.zeros((n_out, model.num_labels), np.float32)
        count = np.zeros(n_out, np.float32)
        for w in range(n_win):
            pred = model(steps[w * so : w * so + ol][None], head_input=True)[0].numpy()
            n_rows = min(n_out, w * so + ol) - w * so
            acc[w * so : w * so + ol] += pred[:n_rows]
            count[w * so : w * so + ol] += 1.0
    valid = count > 0
    acc[valid] /= count[valid, None]
    return acc, count


@pytest.mark.parametrize("n_win,cap,extra", [(8, 2048, 0), (12, 8, 200)])
def test_dense_matches_a_monolithic_trunk(loaded, n_win, cap, extra):
    predictor = _predictor(loaded, True, cap=cap)
    spec = _spec(predictor, n_win, loaded[2]["input_shape"][1], seed=5, extra=extra)
    agg, count = predictor.aggregate(spec)
    want_agg, want_count = _monolithic_dense_reference(loaded[0], predictor, spec)
    np.testing.assert_array_equal(count, want_count)
    np.testing.assert_allclose(agg, want_agg, atol=2e-5, rtol=0)


def test_dense_differs_from_windowed_only_by_the_window_edges(loaded):
    """Same counts; the probabilities differ where a window's zero padding
    stood for real neighbouring frames, by little on this input."""
    spec = _spec(_predictor(loaded, False), 8, loaded[2]["input_shape"][1], seed=7)
    dense_agg, dense_count = _predictor(loaded, True).aggregate(spec)
    win_agg, win_count = _predictor(loaded, False).aggregate(spec)
    np.testing.assert_array_equal(dense_count, win_count)
    diff = np.abs(dense_agg - win_agg)
    assert diff.max() > 0.0 and diff.mean() < 0.05


def test_dense_takes_a_device_tensor_with_valid_frames(loaded):
    predictor = _predictor(loaded, True)
    spec = _spec(predictor, 8, loaded[2]["input_shape"][1], seed=9)
    padded = torch.zeros((8192, spec.shape[1]))
    padded[: len(spec)] = torch.from_numpy(spec)
    a, ca = predictor.aggregate(spec)
    b, cb = predictor.aggregate(padded, n_frames=len(spec))
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(a, b)


def test_dense_trunk_is_off_by_default_and_follows_the_environment(loaded, monkeypatch):
    monkeypatch.delenv("ORCAI_TPU_DENSE_TRUNK", raising=False)
    assert not _predictor(loaded, None).dense_trunk
    monkeypatch.setenv("ORCAI_TPU_DENSE_TRUNK", "1")
    assert _predictor(loaded, None).dense_trunk
    assert not _predictor(loaded, False).dense_trunk
    monkeypatch.setenv("ORCAI_TPU_DENSE_TRUNK", "0")
    assert not _predictor(loaded, None).dense_trunk


def test_streaming_path_stays_windowed(loaded, monkeypatch):
    """A dense predictor handed to the streaming path still runs windows:
    the streamed aggregate equals the windowed in-memory one."""
    from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device
    from orcai_tpu_torch.ops.streaming import StreamingPredictor

    _, param, _ = loaded
    sp = param["spectrogram"]
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(3 * 368 * 256 + 512)).astype(np.float32)
    dense = _predictor(loaded, True)
    called = []
    monkeypatch.setattr(dense, "_run_chunk_dense",
                        lambda *a, **k: called.append(1) or pytest.fail("dense on streaming"))
    streamed, s_count = StreamingPredictor(
        dense, sp, stats_tile_frames=4096, windows_per_chunk=4).aggregate(audio)
    spec, n_frames, _, _ = make_spectrogram_from_params_device(audio, sp, device="cpu")
    windowed, w_count = _predictor(loaded, False).aggregate(spec, n_frames=n_frames)
    assert not called
    np.testing.assert_array_equal(s_count, w_count)
    np.testing.assert_allclose(streamed, windowed, atol=1e-5, rtol=0)


def test_dense_golden_annotations_in_band(tmp_path, monkeypatch):
    """`predict` with ORCAI_TPU_DENSE_TRUNK=1 on the golden wav: every
    detection matches the golden TSV at annotation level (0.5 s at each
    boundary) and no call is invented. One golden row is lost, in the JAX
    package's dense trunk too (the two agree to 7e-7 on this recording): the
    one-step WHISTLE at 54.784 s, whose windowed probability 0.2565 sits just
    over the 0.25 threshold and whose dense-trunk probability is 0.0941.
    (tests/test_dense_trunk.py does not see it: under pytest's 8-device mesh
    the reference's predictor switches its dense trunk off.)"""
    from orcai_tpu_torch.pipeline.predict import predict

    monkeypatch.setenv("ORCAI_TPU_DENSE_TRUNK", "1")
    out = predict(FIXTURES / "golden.wav", output_path=tmp_path / "pred_dense.txt",
                  predict_batch_size=16, device="cpu")

    def rows(path):
        with open(path, newline="") as f:
            return [(float(r["start"]), float(r["stop"]), r["label"])
                    for r in csv.DictReader(f, delimiter="\t")]

    got, exp = rows(out), rows(FIXTURES / "golden_expected.txt")

    def matched(row, table, tol=0.5):
        return any(label == row[2] and abs(a - row[0]) <= tol and abs(b - row[1]) <= tol
                   for a, b, label in table)

    lost = [r for r in exp if not matched(r, got)]
    assert lost == [(54.784, 54.784, "WHISTLE*")], f"dense mode lost detections: {lost}"
    assert not [r[2] for r in got if not matched(r, exp)], "dense mode invented detections"
