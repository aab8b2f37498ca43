"""The port's TrainCheckpointer (orcai_tpu_torch/train/checkpoint.py): the
full training state goes through torch.save and comes back exactly, one
whole checkpoint is on disk at any moment, and a restored run goes on as
the saved one would have (tests/test_checkpoint.py is the reference's)."""

import numpy as np
import pytest
import torch

from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.train.checkpoint import TrainCheckpointer
from orcai_tpu_torch.train.trainer import Trainer, get_learning_rate, set_learning_rate

PARAM = {
    "name": "ckpt", "architecture": "ResNetLSTM", "calls": ["A", "B"],
    "model": {"filters": [2, 3], "kernel_size": 3, "dropout_rate": 0.3, "lstm_units": 4},
}
INPUT_SHAPE = (16, 9, 1)


def setup_module():
    torch.set_num_threads(1)


def _trainer(seed=0, arch="ResNetLSTM"):
    trainer = Trainer(build_model(dict(PARAM, architecture=arch), INPUT_SHAPE), 1e-2,
                      device="cpu")
    return trainer, trainer.init_state(seed=seed)


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(size=(n, *INPUT_SHAPE)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (n, 4, 2)).astype(np.float32)))


def _steps(trainer, state, n, seed=0):
    return [trainer.train_step(state, *_batch(seed + i)).clone() for i in range(n)]


def test_nothing_to_restore_in_a_fresh_directory(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "resume")
    assert (tmp_path / "resume").is_dir()
    assert ckpt.latest_epoch() is None
    _, state = _trainer()
    assert ckpt.restore(state) is None


@pytest.mark.parametrize("arch", ["ResNetLSTM", "ResNet1DConv", "ResNetTCN"])
def test_save_restore_round_trip(arch, tmp_path):
    trainer, state = _trainer(arch=arch)
    _steps(trainer, state, 2)
    set_learning_rate(state, 2.5e-3)
    history = {"loss": [1.0, np.float32(0.5)], "val_MBA": [0.5, 0.75],
               "learning_rate": [1e-2, 2.5e-3]}
    counters = {"stale_early": 1, "stale_lr": 0}
    ckpt = TrainCheckpointer(tmp_path / "resume")
    ckpt.save(1, state, history, 2.5e-3, counters=counters)
    saved_model = {k: v.clone() for k, v in state.model.state_dict().items()}
    saved_opt = state.optimizer.state_dict()
    saved_rng = state.generator.get_state().clone()
    assert ckpt.latest_epoch() == 1

    other_trainer, other = _trainer(seed=9, arch=arch)
    restored = TrainCheckpointer(tmp_path / "resume").restore(other)
    assert restored is not None
    got_state, got_history, lr, epoch, got_counters = restored
    assert got_state is other
    assert (lr, epoch, got_counters) == (2.5e-3, 1, counters)
    assert got_history == {"loss": [1.0, 0.5], "val_MBA": [0.5, 0.75],
                           "learning_rate": [1e-2, 2.5e-3]}
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, saved_model[k]), k
    assert get_learning_rate(other) == 2.5e-3
    got_opt = other.optimizer.state_dict()
    assert got_opt["param_groups"] == saved_opt["param_groups"]
    for i, slot in saved_opt["state"].items():
        for name, value in slot.items():
            assert torch.equal(torch.as_tensor(got_opt["state"][i][name]),
                               torch.as_tensor(value)), (i, name)
    assert torch.equal(other.generator.get_state(), saved_rng)


def test_restored_run_continues_as_the_saved_one(tmp_path):
    """Steps after a restore equal the steps the saved run takes next:
    weights, Adam moments and step count, and the dropout masks."""
    trainer, state = _trainer()
    _steps(trainer, state, 3)
    TrainCheckpointer(tmp_path / "resume").save(0, state, {"loss": [1.0]}, 1e-2)
    want = _steps(trainer, state, 3, seed=10)

    other_trainer, other = _trainer(seed=5)
    TrainCheckpointer(tmp_path / "resume").restore(other)
    got = _steps(other_trainer, other, 3, seed=10)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k


def test_only_the_latest_epoch_is_kept_and_no_temporary_file_stays(tmp_path):
    trainer, state = _trainer()
    ckpt = TrainCheckpointer(tmp_path / "resume")
    for epoch in range(3):
        ckpt.save(epoch, state, {"loss": [1.0] * (epoch + 1)}, 1e-2)
        assert sorted(p.name for p in (tmp_path / "resume").iterdir()) == [f"epoch_{epoch}.pt"]
    assert ckpt.latest_epoch() == 2
    keep_two = TrainCheckpointer(tmp_path / "two", max_to_keep=2)
    for epoch in range(4):
        keep_two.save(epoch, state, {}, 1e-2)
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == ["epoch_2.pt", "epoch_3.pt"]
    assert keep_two.latest_epoch() == 3


def test_latest_epoch_orders_by_number_and_ignores_partial_files(tmp_path):
    trainer, state = _trainer()
    ckpt = TrainCheckpointer(tmp_path / "resume", max_to_keep=20)
    for epoch in (9, 10):
        ckpt.save(epoch, state, {}, 1e-2)
    (tmp_path / "resume" / "epoch_11.pt.tmp").write_bytes(b"cut short")
    assert ckpt.latest_epoch() == 10
    assert ckpt.restore(state)[3] == 10


def test_counters_may_be_absent(tmp_path):
    trainer, state = _trainer()
    ckpt = TrainCheckpointer(tmp_path / "resume")
    ckpt.save(0, state, {"loss": [1.0]}, 1e-2)
    assert ckpt.restore(state)[4] is None


def test_cleanup_removes_the_directory(tmp_path):
    trainer, state = _trainer()
    ckpt = TrainCheckpointer(tmp_path / "resume")
    ckpt.save(0, state, {}, 1e-2)
    ckpt.close()
    ckpt.cleanup()
    assert not (tmp_path / "resume").exists()
    ckpt.cleanup()  # twice is fine
