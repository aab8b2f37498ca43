"""Preemption-safe training checkpoints (torch.save).

Counterpart of orcai_tpu/train/checkpoint.py. Every epoch end persists the
FULL training state: parameters and BatchNorm statistics, the optimizer's
state, the dropout generator's state, epoch, learning rate, metric history
and the callback counters. `train` resumes from the latest epoch when a
resume directory is present. A checkpoint is written under a temporary
name and renamed, and the epochs before it are removed only after that, so
an interruption at any moment leaves one whole checkpoint.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path

import torch

_NAME = re.compile(r"epoch_(\d+)\.pt$")


class TrainCheckpointer:
    """Rolling checkpoints of the full training state."""

    def __init__(self, directory: Path | str, max_to_keep: int = 1):
        self.directory = Path(directory).resolve()
        self.max_to_keep = max(1, int(max_to_keep))
        self.directory.mkdir(parents=True, exist_ok=True)

    def _epochs(self) -> list[int]:
        found = (_NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{int(epoch)}.pt"

    def save(
        self,
        epoch: int,
        state,
        history: dict,
        lr: float,
        counters: dict | None = None,
    ) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
            # counters: exact EarlyStopping/ReduceLROnPlateau staleness at
            # epoch end, so a resumed run reduces LR / stops at the same
            # epoch an uninterrupted run would
            "meta": {
                "epoch": int(epoch),
                "lr": float(lr),
                "history": {k: [float(v) for v in vs] for k, vs in history.items()},
                "counters": dict(counters) if counters is not None else None,
            },
        }
        tmp = self.directory / f"epoch_{int(epoch)}.pt.tmp"
        torch.save(payload, tmp)
        tmp.replace(self._path(epoch))
        for old in self._epochs()[: -self.max_to_keep]:
            self._path(old).unlink()

    def latest_epoch(self) -> int | None:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore(self, state) -> tuple[object, dict, float, int, dict | None] | None:
        """Load the latest checkpoint into `state` (its model, optimizer and
        generator, in place) and return (state, history, lr, epoch,
        counters), or None when there is no checkpoint."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(epoch), map_location=device)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.generator.set_state(payload["generator"].cpu())
        meta = payload["meta"]
        return state, meta["history"], meta["lr"], meta["epoch"], meta.get("counters")

    def close(self) -> None:
        """Nothing is held open between saves."""

    def cleanup(self) -> None:
        """Remove the resume directory (called after a completed run)."""
        self.close()
        shutil.rmtree(self.directory, ignore_errors=True)
