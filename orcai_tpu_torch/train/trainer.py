"""Training: one autograd train step + keras-semantics callback loop.

Counterpart of orcai_tpu/train/trainer.py:
- a train step in the model's compute dtype: weighted masked BCE from
  logits + l2 regularization, torch.optim.Adam (optax adam's formula: b1
  0.9, b2 0.999, eps 1e-8; the l2 term is in the loss, so weight_decay 0),
  the learning rate written into the optimizer's param_groups;
- the callback semantics the reference relies on, on the host:
  EarlyStopping(monitor val_MBA, mode max, restore best),
  ModelCheckpoint(save_best_only), ReduceLROnPlateau(factor/patience/min_lr);
- training_history.json / orcai_parameter.json / model_shape.json outputs
  with the same schema, the weights in flax's msgpack layout.

An epoch is a Python loop over batches, either uploaded one by one
(streaming_runners) or index_select-ed out of a dataset resident on the
device (device_runners); its metrics accumulate in a device tensor that is
fetched once an epoch, so no step waits for the host.

The training state is a TrainState: the model (parameters and BatchNorm
statistics), its optimizer and the dropout generator. Steps change it in
place; a Trainer and the states it makes share one model.

Data-parallel training (`Trainer(..., distributed=True)`, which `train`
takes in a process group of several processes) is the one-device step
partitioned, as the reference's GSPMD step is: every process draws the
same global batches and runs a contiguous block of each under
DistributedDataParallel, with global BatchNorm statistics and dropout
masks (models/layers.py), the masked loss divided by the count of every
process's labels, and the epoch's metric sums all-reduced before they are
fetched. `train` in one process with several local devices starts one
process per device itself (parallel/distributed.py::launch). A Trainer
given `eval_devices` splits its forward-only evaluation batches over them
instead (parallel/mesh.py::Replicas). A Trainer given a (data, model)
`mesh` (tensor parallelism) shards the model's parameters over the model
axis when it makes the state (parallel/sharding_rules.py) and splits the
batch over the data axis as above, with DDP, the BatchNorm statistics, the
loss's count and the metrics over the data ranks only.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from orcai_tpu_torch.io.dataset import ArrayDataset, epoch_permutation
from orcai_tpu_torch.io.jsonio import read_json, write_json
from orcai_tpu_torch.io.model_store import (
    convert_flax_variables,
    load_optax_adam_state,
    load_orcai_model,
    load_variables,
    save_orcai_model,
)
from orcai_tpu_torch.models import build_model, init_variables, l2_regularization
from orcai_tpu_torch.ops.losses import (
    masked_binary_accuracy_counts,
    weighted_masked_bce_sums,
)
from orcai_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_object,
    launch,
    process_count,
    process_index,
)
from orcai_tpu_torch.models.layers import shard_of
from orcai_tpu_torch.parallel.mesh import Replicas, block_bounds, local_devices, mesh_for_batch
from orcai_tpu_torch.parallel.sharding_rules import shard_params
from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
from orcai_tpu_torch.utils.device import exact_f32_math, resolve_device
from orcai_tpu_torch.utils.messenger import Messenger
from orcai_tpu_torch.utils.seeds import SEED_ID_LOAD_TRAIN_DATA, SEED_ID_LOAD_VAL_DATA


def _host_tensor(arr, dtype=None) -> torch.Tensor:
    """A tensor sharing the array's memory where it can (a read-only
    memmap included: it is only ever copied to the device)."""
    arr = np.ascontiguousarray(arr, dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def _count_params(model: torch.nn.Module) -> int:
    """Every parameter's elements, frozen biases too, as the reference
    counts the flax parameter tree."""
    return sum(p.numel() for p in model.parameters())


def resolve_compute_dtype(model_parameter: dict) -> torch.dtype:
    """model.compute_dtype config key -> torch dtype (default float32)."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        model_parameter.get("compute_dtype", "float32")
    ]


def make_optimizer(model: torch.nn.Module, learning_rate: float) -> torch.optim.Adam:
    """Adam over the trainable parameters (frozen biases are left out)."""
    return torch.optim.Adam(
        [p for p in model.parameters() if p.requires_grad],
        lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
    )


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # the dropout masks' source, on the model's device


def set_learning_rate(state: TrainState, lr: float) -> None:
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def model_state_to_host(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A copy of the model's parameters and statistics in host memory."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


class Trainer:
    """Owns the model on its device and the train/eval steps.

    `distributed`: this process trains one block of every batch in the
    default process group (see the module docstring); the model is wrapped
    in DistributedDataParallel at the first train step, after any weights
    were loaded. `eval_devices`: more than one device to split the
    evaluation batches over (the model's device first). `mesh`: a
    ProcessMesh (parallel/mesh.py::make_mesh with n_model) to train on,
    the batch split over its data axis and the parameters sharded over its
    model axis (parallel/sharding_rules.py) when the state is made; every
    process of the group runs the same calls.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        learning_rate: float,
        call_weights: np.ndarray | None = None,
        device: str | torch.device = "cuda",
        distributed: bool = False,
        eval_devices=None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.learning_rate = float(learning_rate)
        self.call_weights = (
            torch.as_tensor(np.asarray(call_weights, np.float32), device=self.device)
            if call_weights is not None
            else None
        )
        self.mesh = mesh
        if mesh is not None:
            self.data_group = mesh.data_group
            self.rank, self.world = mesh.data_index, mesh.shape["data"]
            distributed = self.world > 1
        else:
            self.data_group = None
            self.rank = dist.get_rank() if distributed else 0
            self.world = dist.get_world_size() if distributed else 1
        self.distributed = distributed
        self._ddp = None
        if distributed:
            self.model.set_data_parallel(self.rank, self.world, self.data_group)
        self.replicas = (
            Replicas(self.model, eval_devices)
            if eval_devices is not None and len(eval_devices) > 1 else None
        )

    # -- state -------------------------------------------------------------

    def _fresh_state(self, seed: int) -> TrainState:
        if self.mesh is not None and self.mesh.shape["model"] > 1:
            shard_params(self.model, self.mesh)
        generator = torch.Generator(device=self.device).manual_seed(int(seed) + 1)
        self.model.set_dropout_generator(generator)
        return TrainState(
            self.model, make_optimizer(self.model, self.learning_rate), generator
        )

    def _whole_model(self) -> None:
        if any(shard_of(m) is not None for m in self.model.modules()):
            raise RuntimeError("the model's parameters are sharded already: a new state "
                               "needs a new Trainer")

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh weights from `seed`, a fresh Adam, dropout from seed + 1."""
        self._whole_model()
        init_variables(self.model, seed=seed)
        return self._fresh_state(seed)

    def state_from_variables(self, state_dict: dict | None = None, seed: int = 0) -> TrainState:
        """A fresh Adam and generator around given weights (a state dict of
        tensors or numpy arrays; None keeps the model's own)."""
        self._whole_model()
        if state_dict is not None:
            self.model.load_state_dict(
                {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
                 for k, v in state_dict.items()}
            )
        return self._fresh_state(seed)

    # -- steps -------------------------------------------------------------

    def _loss(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The step's loss: weighted masked BCE plus the l2 term.
        Distributed, the count is every process's, and the block's sum is
        scaled by the world size so that DDP's average of the gradients is
        the global mean's; the l2 term, the same on every process, is left
        as it is by the average."""
        total, count = weighted_masked_bce_sums(logits, y, self.call_weights)
        if self.distributed:
            count = count.detach().float().clone()
            dist.all_reduce(count, group=self.data_group)
        return total * self.world / count.clamp(min=1) + l2_regularization(self.model)

    @torch.no_grad()
    def _metrics(self, loss: torch.Tensor, logits: torch.Tensor, y: torch.Tensor):
        """[loss, correct, total] of this block and the probabilities; the
        world's losses sum to the global batch's (see _epoch_metrics)."""
        probs = torch.sigmoid(logits)
        correct, total = masked_binary_accuracy_counts(probs, y)
        loss = loss.detach().float() / self.world
        return torch.stack([loss, correct.float(), total.float()]), probs

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.distributed:
            return self.model(x, train=True, return_logits=True)
        if self._ddp is None:
            from torch.nn.parallel import DistributedDataParallel

            # BatchNorm's running statistics are global already: nothing
            # to broadcast before a forward
            index = self.device.index
            if self.device.type == "cuda" and index is None:
                index = torch.cuda.current_device()
            self._ddp = DistributedDataParallel(
                self.model,
                device_ids=[index] if self.device.type == "cuda" else None,
                broadcast_buffers=False,
                process_group=self.data_group,
            )
        return self._ddp(x, train=True, return_logits=True)

    def train_step(self, state: TrainState, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a device batch; returns [loss, correct,
        total] as a device tensor (nothing is fetched)."""
        state.optimizer.zero_grad(set_to_none=True)
        logits = self._train_forward(x)
        loss = self._loss(logits, y)
        loss.backward()
        state.optimizer.step()
        return self._metrics(loss, logits, y)[0]

    @torch.no_grad()
    def eval_step_probs(self, x: torch.Tensor, y: torch.Tensor):
        """([loss, correct, total], float32 probabilities) from one forward;
        the loss includes the l2 term, as in training."""
        if self.replicas is not None:
            logits = self.replicas(x, train=False, return_logits=True)
        else:
            logits = self.model(x, train=False, return_logits=True)
        return self._metrics(self._loss(logits, y), logits, y)

    def eval_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.eval_step_probs(x, y)[0]

    # -- epoch loops ----------------------------------------------------------

    def _to_device(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        return (_host_tensor(x, np.float32).to(self.device),
                _host_tensor(y, np.float32).to(self.device))

    def block(self, rows):
        """This process's contiguous block of every batch's index row (the
        rows themselves when training alone)."""
        if self.world == 1:
            return rows
        rows = np.asarray(rows)
        lo, hi = block_bounds(rows.shape[-1], self.world, self.rank)
        return rows[..., lo:hi]

    def _epoch_metrics(self, step, batches, prefix: str) -> dict:
        """Sum step(x, y) over device batches in a float64 device tensor;
        one fetch at the end (after one all-reduce over the processes when
        distributed). loss is the mean over batches, MBA the ratio of the
        summed counts."""
        acc = torch.zeros(3, dtype=torch.float64, device=self.device)
        n = 0
        for x, y in batches:
            acc += step(x, y).double()
            n += 1
        if self.distributed:
            dist.all_reduce(acc, group=self.data_group)
        loss_sum, correct, total = acc.tolist()
        return {
            f"{prefix}loss": float(loss_sum / max(n, 1)),
            f"{prefix}MBA": float(correct / max(total, 1.0)),
        }

    def run_train_epoch(self, state: TrainState, batches) -> tuple[TrainState, dict]:
        """`batches` yields host (x, y) arrays."""
        metrics = self._epoch_metrics(
            lambda x, y: self.train_step(state, x, y),
            (self._to_device(x, y) for x, y in batches), "",
        )
        return state, metrics

    def run_eval_epoch(self, state: TrainState, batches, prefix: str = "val_") -> dict:
        """The model evaluated is the trainer's, which is the state's."""
        return self._epoch_metrics(
            self.eval_step, (self._to_device(x, y) for x, y in batches), prefix,
        )


def streaming_runners(trainer: Trainer, train_batches, val_batches):
    """Adapt epoch->batch-iterator callables to fit()'s runner interface."""
    return (
        lambda state, epoch: trainer.run_train_epoch(state, train_batches(epoch)),
        lambda state, epoch: trainer.run_eval_epoch(state, val_batches(epoch)),
    )


class DeviceData:
    """An (X, Y) dataset resident in device memory, shareable across
    trainers; `quantize` stores the [0, 1] spectrograms as uint8."""

    def __init__(self, ds: ArrayDataset, quantize: bool = False,
                 device: str | torch.device = "cuda"):
        device = resolve_device(device)
        x = np.asarray(ds.x)
        if quantize:
            x = np.round(x * 255.0).astype(np.uint8)
        self.x = _host_tensor(x).to(device)
        self.y = _host_tensor(ds.y, np.float32).to(device)
        self.n = len(ds)

    def n_batches(self, batch_size: int) -> int:
        return self.n // batch_size

    def batches(self, perm: np.ndarray):
        """Device (x, y) batches for the index rows of one epoch."""
        rows = torch.from_numpy(np.ascontiguousarray(perm, np.int64)).to(self.x.device)
        for idx in rows:
            x = self.x.index_select(0, idx)
            if x.dtype == torch.uint8:
                x = x.float() * (1.0 / 255.0)
            yield x, self.y.index_select(0, idx)


def device_runners(
    trainer: Trainer,
    train_ds,
    val_ds,
    batch_size: int,
    train_seed,
    val_seed,
    quantize: bool = False,
):
    """Runners over datasets resident on the trainer's device: uploaded
    once, then every batch is an index_select on the device.

    Batch for batch identical to the streaming path (the same seeded epoch
    permutations, each process taking its block of them); optional uint8
    quantization of the [0, 1] spectrograms quarters the upload and the
    footprint. Accepts ArrayDataset (uploads now) or pre-uploaded
    DeviceData.
    """
    if not isinstance(train_ds, DeviceData):
        train_ds = DeviceData(train_ds, quantize, trainer.device)
    if not isinstance(val_ds, DeviceData):
        val_ds = DeviceData(val_ds, quantize, trainer.device)

    def run_train(state, epoch):
        perm = trainer.block(epoch_permutation(train_ds.n, batch_size, train_seed, epoch))
        return state, trainer._epoch_metrics(
            lambda x, y: trainer.train_step(state, x, y), train_ds.batches(perm), "")

    def run_val(state, epoch):
        perm = trainer.block(epoch_permutation(val_ds.n, batch_size, val_seed, epoch))
        return trainer._epoch_metrics(trainer.eval_step, val_ds.batches(perm), "val_")

    return run_train, run_val


@contextlib.contextmanager
def _profiled(profile_dir: str | None, name: str):
    """A torch.profiler trace of the block, written to profile_dir."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(profile_dir) / f"{name}.json"))


def fit(
    trainer: Trainer,
    state: TrainState,
    run_train_epoch,
    run_val_epoch,
    epochs: int,
    monitor: str = "val_MBA",
    early_stopping_patience: int = 10,
    reduce_lr_patience: int = 3,
    reduce_lr_factor: float = 0.5,
    reduce_lr_min: float = 1e-7,
    on_improve=None,
    on_epoch_end=None,
    initial_lr: float | None = None,
    initial_epoch: int = 0,
    initial_history: dict | None = None,
    initial_best_state: dict | None = None,
    initial_counters: dict | None = None,
    profile_dir: str | None = None,
    msgr: Messenger | None = None,
) -> tuple[TrainState, dict]:
    """Epoch loop with EarlyStopping / ReduceLROnPlateau / best-restore.

    run_train_epoch(state, epoch) -> (state, metrics) / run_val_epoch(state,
    epoch) -> metrics: epoch runners (see streaming_runners/device_runners).
    on_improve: callback(state, history) fired when the monitored metric
    improves (the ModelCheckpoint hook). on_epoch_end: callback(state,
    history, epoch, lr, counters) fired after every epoch (the checkpoint
    hook); counters carries the exact EarlyStopping / ReduceLROnPlateau
    staleness. initial_epoch / initial_history resume a run mid-schedule;
    the counters are restored exactly from initial_counters when given and
    only approximated from the history otherwise. initial_best_state (a
    model state dict) seeds the best-restore with earlier best weights.
    profile_dir writes a torch.profiler trace of the first epoch run.
    The best-so-far weights are kept in host memory and loaded back at the
    end. Returns (state, history dict).
    """
    if msgr is None:
        msgr = Messenger(verbosity=0)
    if "loss" in monitor.lower():
        # keras EarlyStopping / ModelCheckpoint run in mode="max" in the
        # reference project, so a loss-like monitor inverts there too:
        # warn instead of silently optimizing the wrong way
        msgr.warning(
            f"monitor {monitor!r} looks like a loss but monitoring is "
            "max-mode (as in the reference); early stopping, LR plateau "
            "and best-restore will treat RISING values as improvement"
        )

    # copy the metric lists, not just the dict: fit appends per epoch and
    # must never change the caller's carried history
    history: dict[str, list] = (
        {k: list(v) for k, v in initial_history.items()} if initial_history else {}
    )
    past = history.get(monitor, [])
    best_metric = max(past) if past else -np.inf
    best_state = initial_best_state
    if initial_counters is not None:
        stale_early = int(initial_counters["stale_early"])
        stale_lr = int(initial_counters["stale_lr"])
    else:
        stale_early = (len(past) - 1 - int(np.argmax(past))) if past else 0
        stale_lr = stale_early % max(reduce_lr_patience, 1) if past else 0
    lr = initial_lr if initial_lr is not None else get_learning_rate(state)
    set_learning_rate(state, lr)

    for epoch in range(initial_epoch, epochs):
        t0 = time.time()
        with _profiled(profile_dir if epoch == initial_epoch else None,
                       f"train_epoch_{epoch + 1}"):
            state, train_metrics = run_train_epoch(state, epoch)
            val_metrics = run_val_epoch(state, epoch)
        epoch_metrics = {**train_metrics, **val_metrics, "learning_rate": lr}
        for k, v in epoch_metrics.items():
            history.setdefault(k, []).append(v)

        current = epoch_metrics[monitor]
        improved = current > best_metric
        msgr.info(
            f"epoch {epoch + 1}/{epochs} [{time.time() - t0:.1f}s] "
            + " ".join(f"{k}={v:.4f}" for k, v in epoch_metrics.items())
            + (" *" if improved else "")
        )

        if improved:
            best_metric = current
            stale_early = 0
            stale_lr = 0
            best_state = model_state_to_host(state.model)
            if on_improve is not None:
                on_improve(state, history)
        else:
            stale_early += 1
            stale_lr += 1
            if stale_lr >= reduce_lr_patience:
                new_lr = max(lr * reduce_lr_factor, reduce_lr_min)
                if new_lr < lr:  # the rate is never raised
                    lr = new_lr
                    set_learning_rate(state, lr)
                    msgr.info(f"ReduceLROnPlateau: learning rate -> {lr:.2e}")
                stale_lr = 0
        if on_epoch_end is not None:
            on_epoch_end(
                state, history, epoch, lr,
                {"stale_early": stale_early, "stale_lr": stale_lr},
            )
        if stale_early >= early_stopping_patience:
            msgr.info(f"EarlyStopping at epoch {epoch + 1}")
            break

    # restore best weights (EarlyStopping(restore_best_weights=True))
    if best_state is not None:
        state.model.load_state_dict(best_state)
    return state, history


def state_dict_from_flax(flax_variables: dict) -> dict[str, torch.Tensor]:
    """A flax {"params", "batch_stats"} tree as a model state dict of host
    tensors."""
    return {k: torch.from_numpy(v)
            for k, v in convert_flax_variables(flax_variables).items()}


def train(
    data_dir: Path | str,
    output_dir: Path | str,
    orcai_parameter: dict | Path | str = DEFAULT_ORCAI_PARAMETER,
    data_compression: str | None = None,
    load_model: bool = False,
    verbosity: int = 2,
    msgr: Messenger | None = None,
    max_epochs: int | None = None,
    model_dtype: torch.dtype | None = None,
    preemption_checkpointing: bool = True,
    profile_dir: str | None = None,
    on_epoch_end=None,
    device: str | torch.device = "cuda",
) -> None:
    """Train an orcAI model from materialized TVT datasets.

    Reads {train,val}_dataset + dataset_shapes.json (+ call_weights.json
    when configured) from data_dir, writes <output_dir>/<name>/ with the
    weights, the history and the parameter and shape JSONs. `load_model`
    continues from the saved model and its optimizer state: this package's
    <name>.opt.pt, or optax's <name>.opt.msgpack in a directory the JAX
    package trained.

    With preemption_checkpointing (default), every epoch end writes the
    full training state under <model_dir>/resume and an interrupted run
    continues from the latest epoch on its own. on_epoch_end(state,
    history, epoch, lr, counters) is called after that checkpoint is
    written. profile_dir (or env ORCAI_TPU_PROFILE_DIR) records a
    torch.profiler trace of the first epoch. The datasets stay on the
    device when their spectrograms fit ORCAI_TPU_DEVICE_DATASET_BYTES
    (default 6e9), as uint8 under ORCAI_TPU_QUANTIZE_DATASET=1; larger
    ones are uploaded batch by batch. float32 math is IEEE (no TF32).

    Several devices: "cuda" with more than one visible card, or a list of
    devices, trains data-parallel over the largest number of them that
    divides the batch size (as the reference's mesh_for_batch), one process
    each, started here (on_epoch_end must then be picklable). In a process
    group of several processes (initialize_distributed, or a launcher's
    RANK / WORLD_SIZE / LOCAL_RANK) each process trains its block of every
    batch on cuda:<local rank> for "cuda"; the batch size must divide by
    the group's size. Process 0 writes every file, the others wait for it.
    The console report goes through `msgr` (one of `verbosity` titled
    "Training model" if None); in a group, process 0 reports alone.
    """
    if msgr is None:
        msgr = Messenger(verbosity=verbosity if process_index() == 0 else 0,
                         title="Training model")
    output_dir = Path(output_dir)
    data_dir = Path(data_dir)
    if isinstance(orcai_parameter, (Path, str)):
        orcai_parameter = read_json(orcai_parameter)
    distributed = process_count() > 1
    if distributed:
        dev = local_devices(device)[0]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # NCCL's collectives run on the current device
        if orcai_parameter["model"]["batch_size"] % process_count():
            raise ValueError(
                f"batch size {orcai_parameter['model']['batch_size']} does not "
                f"divide over {process_count()} processes"
            )
    else:
        devices = mesh_for_batch(orcai_parameter["model"]["batch_size"],
                                 local_devices(device))
        if len(devices) > 1:
            msgr.info(f"Data-parallel training over {len(devices)} devices, one "
                      "process each")
            output_dir.mkdir(parents=True, exist_ok=True)
            launch(train, devices, output_dir, args=(data_dir, output_dir), kwargs=dict(
                orcai_parameter=orcai_parameter, data_compression=data_compression,
                load_model=load_model, msgr=msgr, max_epochs=max_epochs,
                model_dtype=model_dtype, preemption_checkpointing=preemption_checkpointing,
                profile_dir=profile_dir, on_epoch_end=on_epoch_end,
            ))
            return
        dev = devices[0]
    writer = process_index() == 0
    if not writer:
        msgr = Messenger(verbosity=0)
    msgr.print_platform_info(set_indent=1)
    msgr.print_device_info(set_indent=1)
    msgr.debug(f"Training on {dev}" + (f" (process {process_index()} of "
                                       f"{process_count()})" if distributed else ""))

    msgr.part("Loading parameter")
    model_name = orcai_parameter["name"]
    mp = orcai_parameter["model"]
    label_calls = orcai_parameter["calls"]

    if model_dtype is None:
        # optional schema extension: model.compute_dtype; parameters stay
        # float32, and parameter files without the key train in float32
        model_dtype = resolve_compute_dtype(mp)
        msgr.info(f"Compute dtype: {str(model_dtype).replace('torch.', '')}")

    msgr.part(f"Loading training and validation datasets from {data_dir}")
    if (data_dir / "dataset_shapes.json").exists():
        dataset_shape = read_json(data_dir / "dataset_shapes.json")
    else:
        msgr.info("Using default OrcAI dataset shapes")
        dataset_shape = {"spectrogram": [736, 171, 1], "labels": [46, 7]}
    input_shape = tuple(dataset_shape["spectrogram"])

    train_ds = ArrayDataset.load(data_dir / "train_dataset")
    val_ds = ArrayDataset.load(data_dir / "val_dataset")
    # a null/absent project seed means unseeded shuffles (the shipped
    # default parameter has "seed": null); seed 0 is a real seed
    seed = orcai_parameter["seed"]
    train_seed = [SEED_ID_LOAD_TRAIN_DATA, seed] if seed is not None else None
    val_seed = [SEED_ID_LOAD_VAL_DATA, seed] if seed is not None else None
    if seed is None and distributed:
        # every process must draw the same batches: process 0's draw
        shuffle = broadcast_object(int(np.random.SeedSequence().entropy % (2**63)))
        train_seed = [SEED_ID_LOAD_TRAIN_DATA, shuffle]
        val_seed = [SEED_ID_LOAD_VAL_DATA, shuffle]

    if mp.get("call_weights") is not None:
        call_weights_dict = read_json(data_dir / "call_weights.json")
        if list(call_weights_dict.keys()) != label_calls:
            raise ValueError(
                "Call weights do not match label calls. Please check the "
                "call weights file. Order of calls must be the same as in "
                "the orcAI parameter file."
            )
        call_weights = np.asarray(list(call_weights_dict.values()), np.float32)
        msgr.info(f"Call weights: {call_weights_dict}")
    else:
        call_weights = None

    msgr.info(f"Batch size {mp['batch_size']}")
    model_dir = output_dir / model_name
    seed_int = int(seed) % (2**31) if seed is not None else 0
    resumed_lr = None
    if load_model:
        msgr.part("Loading model")
        model, _, _ = load_orcai_model(model_dir, dtype=model_dtype, device=dev)
        trainer = Trainer(model, mp["learning_rate"], call_weights, device=dev,
                          distributed=distributed)
        state = trainer.state_from_variables(seed=seed_int)
        opt_path = model_dir / f"{model_name}.opt.pt"
        optax_path = model_dir / f"{model_name}.opt.msgpack"
        if opt_path.exists():
            msgr.info("Restoring optimizer state")
            state.optimizer.load_state_dict(torch.load(opt_path, map_location=dev))
        elif optax_path.exists():
            msgr.info(f"Restoring optax's optimizer state from {optax_path.name}")
            load_optax_adam_state(optax_path, model, state.optimizer)
        else:
            msgr.debug(f"No optimizer state {opt_path.name} or {optax_path.name}: "
                       "Adam starts fresh")
        if opt_path.exists() or optax_path.exists():
            # continue at the restored LR: ReduceLROnPlateau must never
            # raise the effective rate back to the config value
            resumed_lr = get_learning_rate(state)
    else:
        msgr.part("Building model")
        model = build_model(orcai_parameter, input_shape, dtype=model_dtype)
        trainer = Trainer(model, mp["learning_rate"], call_weights, device=dev,
                          distributed=distributed)
        state = trainer.init_state(seed=seed_int)

    # preemption-safe resume
    initial_epoch = 0
    initial_history: dict | None = None
    initial_best_state: dict | None = None
    initial_counters: dict | None = None
    initial_lr = resumed_lr if resumed_lr is not None else mp["learning_rate"]
    ckpt = None
    if preemption_checkpointing:
        from orcai_tpu_torch.train.checkpoint import TrainCheckpointer

        ckpt = TrainCheckpointer(model_dir / "resume")
        restored = ckpt.restore(state)
        if restored is not None:
            state, initial_history, initial_lr, last_epoch, initial_counters = restored
            initial_epoch = last_epoch + 1
            msgr.info(f"Resuming interrupted training from epoch {initial_epoch + 1}")
            best_path = model_dir / f"{model_name}.msgpack"
            if best_path.exists():
                # best-so-far weights saved by the checkpoint callback
                initial_best_state = state_dict_from_flax(load_variables(best_path))

    if profile_dir is None:
        profile_dir = os.environ.get("ORCAI_TPU_PROFILE_DIR")

    msgr.info("Model size:", indent=1)
    msgr.info(f"Trainable parameter: {_count_params(state.model)}", indent=-1)
    msgr.print_memory_usage()

    msgr.part(f"Fitting model: {model_name}")
    msgr.info(f"Monitoring {mp['monitor']}")

    def save_checkpoint(current_state, history):
        if writer:
            save_orcai_model(
                model_dir, orcai_parameter, current_state.model.state_dict(),
                input_shape=input_shape,
            )
        barrier()

    def epoch_end(s, h, e, lr, c):
        if ckpt is not None:
            if writer:
                ckpt.save(e, s, h, lr, counters=c)
            barrier()
        if on_epoch_end is not None:
            on_epoch_end(s, h, e, lr, c)

    epochs = max_epochs if max_epochs is not None else mp["epochs"]
    batch_size = mp["batch_size"]

    # datasets resident on the device when they fit its budget
    limit = int(os.environ.get("ORCAI_TPU_DEVICE_DATASET_BYTES", 6_000_000_000))
    data_bytes = train_ds.x.nbytes + val_ds.x.nbytes
    if data_bytes <= limit:
        msgr.info(f"Datasets HBM-resident ({data_bytes / 1e9:.2f} GB): batches gathered "
                  "on the device")
        run_train, run_val = device_runners(
            trainer, train_ds, val_ds, batch_size, train_seed, val_seed,
            quantize=os.environ.get("ORCAI_TPU_QUANTIZE_DATASET") == "1",
        )
    else:
        msgr.info("Datasets exceed HBM budget: streaming batches")
        run_train, run_val = streaming_runners(
            trainer,
            lambda e: train_ds.batches(batch_size, seed=train_seed, epoch=e,
                                       rows=trainer.block),
            lambda e: val_ds.batches(batch_size, seed=val_seed, epoch=e, rows=trainer.block),
        )

    with exact_f32_math():
        state, history = fit(
            trainer,
            state,
            run_train,
            run_val,
            epochs=epochs,
            monitor=mp["monitor"],
            early_stopping_patience=mp["EarlyStopping_patience"],
            reduce_lr_patience=mp["ReduceLROnPlateau_patience"],
            reduce_lr_factor=mp["ReduceLROnPlateau_factor"],
            reduce_lr_min=mp["ReduceLROnPlateau_min_learning_rate"],
            on_improve=save_checkpoint,
            on_epoch_end=epoch_end,
            initial_lr=initial_lr,
            initial_epoch=initial_epoch,
            initial_history=initial_history,
            initial_best_state=initial_best_state,
            initial_counters=initial_counters,
            profile_dir=profile_dir,
            msgr=msgr,
        )
    if writer:
        if ckpt is not None:
            ckpt.cleanup()
        msgr.part("Saving Model")
        save_orcai_model(
            model_dir,
            orcai_parameter,
            state.model.state_dict(),
            input_shape=input_shape,
            opt_state=state.optimizer.state_dict(),
            train_state={"epochs_run": len(history.get("loss", []))},
        )
        write_json(history, model_dir / "training_history.json")
        msgr.success(f"Training model finished. Model saved to {model_name}.msgpack")
    barrier()
