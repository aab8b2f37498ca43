"""The devices a process computes on, and the data-parallel split over them.

Counterpart of orcai_tpu/parallel/mesh.py. A JAX mesh is a grid of devices
whose "data" axis splits a batch (P("data")); here a mesh is the list of
the devices along that axis. A list may name one device twice, which
splits the work exactly as two devices would, on one (the CPU tests and a
one-card machine drive the split that way).

Forward-only work (predict, serve, warmup, test) splits each batch over the
mesh in one process with `Replicas`: a copy of the model on each device, a
contiguous block of the batch each, the outputs gathered on the first
device. Training splits it over processes instead (train/trainer.py).

A mesh with a "model" axis (tensor parallelism, parallel/sharding_rules.py)
is a ProcessMesh: a (data, model) grid of the default group's processes,
each on its own device, with a data and a model subgroup.
"""

from __future__ import annotations

import copy

import torch

from orcai_tpu_torch.parallel.distributed import (
    local_process_count,
    local_rank,
    process_count,
    process_index,
)
from orcai_tpu_torch.utils.device import resolve_device


def local_devices(device="cuda") -> list[torch.device]:
    """The devices this process computes on.

    "cuda" means every visible CUDA device, or in a group of several
    processes this process's contiguous share of them (a process of each
    host owns different recordings, so its mesh must stay on its own
    devices); "cuda:<i>" and "cpu" are themselves; a list is taken as it is.
    """
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    n = torch.cuda.device_count()
    if process_count() > 1:
        per = max(n // max(local_process_count(), 1), 1)
        first = (local_rank() * per) % n
        return [torch.device("cuda", i) for i in range(first, first + per)]
    return [torch.device("cuda", i) for i in range(n)]


class ProcessMesh:
    """A (data, model) grid of processes: rank = data * n_model + model, as
    the JAX mesh lays its device list out (n_data, n_model). `data_group`
    holds the processes of this one's model coordinate (they split the
    batch), `model_group` those of its data coordinate (they hold the
    blocks of the sharded parameters); both are None on a mesh made
    without a process group (its shape alone, for params_shardings)."""

    def __init__(self, n_data: int, n_model: int, rank: int = 0):
        self.shape = {"data": n_data, "model": n_model}
        self.data_index, self.model_index = divmod(rank, n_model)
        self.data_group = self.model_group = None


def make_mesh(n_data: int | None = None, devices=None, n_model: int = 1):
    """The first n_data of `devices` (default: every local device) for a
    data-parallel mesh. With n_model > 1, the ProcessMesh over the default
    process group (n_data defaults to its size over n_model): every process
    of the group calls this, in the same order as its other groups."""
    if n_model == 1:
        devices = local_devices() if devices is None else local_devices(list(devices))
        return devices[: n_data if n_data is not None else len(devices)]
    if devices is not None:
        raise ValueError("a (data, model) mesh is the process group's: each process "
                         "computes on its own device")
    world = process_count()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} does not cover {world} processes")
    mesh = ProcessMesh(n_data, n_model, process_index())
    import torch.distributed as dist

    for d in range(n_data):  # every process makes every group, in one order
        group = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == mesh.data_index:
            mesh.model_group = group
    for m in range(n_model):
        group = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == mesh.model_index:
            mesh.data_group = group
    return mesh


def shard_batch_size(batch_size: int, mesh: list) -> int:
    """Round batch size up to a multiple of the mesh size."""
    n = len(mesh)
    return -(-batch_size // n) * n


def mesh_for_batch(batch_size: int, devices=None) -> list[torch.device]:
    """The largest data-parallel mesh whose size divides the batch size."""
    devices = make_mesh(devices=devices)
    n = len(devices)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return devices[:n]


def block_bounds(n: int, parts: int, index: int) -> tuple[int, int]:
    """[lo, hi) of block `index` when n rows are cut into `parts`
    contiguous blocks, as P("data") lays a batch out (the first n % parts
    blocks one row longer where n does not divide)."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


class Replicas:
    """A model on each device of a mesh, for forward-only batches.

    `model` stays the replica on its own device, which is the first of the
    mesh (the model is moved there otherwise); the others are copies made
    once, so the weights must not change afterwards. A call splits the
    leading axis into contiguous blocks, runs each block on its device
    (the launches go out one device after another and run side by side)
    and returns the outputs concatenated on the first device.
    """

    def __init__(self, model: torch.nn.Module, devices):
        self.devices = local_devices(list(devices))
        first = self.devices[0]
        if next(model.parameters()).device != first:
            model = model.to(first)
        self.models = [model] + [
            copy.deepcopy(model).to(d) for d in self.devices[1:]
        ]

    def __len__(self) -> int:
        return len(self.devices)

    def __call__(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        n = len(self.devices)
        outs = []
        for i, (model, dev) in enumerate(zip(self.models, self.devices)):
            lo, hi = block_bounds(x.shape[0], n, i)
            if hi > lo:
                outs.append(model(x[lo:hi].to(dev, non_blocking=True), **kwargs))
        first = self.devices[0]
        return torch.cat([o.to(first, non_blocking=True) for o in outs])
