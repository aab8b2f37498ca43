"""Multi-process runs: the process group, the ranks, and each process's
share of independent work.

Counterpart of orcai_tpu/parallel/distributed.py. JAX drives every local
chip from one process and joins the hosts with jax.distributed; here a
multi-process run is a torch.distributed process group, one process per
device where the processes work together (data-parallel training), or one
process per host where they split independent work (the recording tables
of the batch commands, hpsearch's trials). Without a group every function
here reads one process of rank 0, so the single-process entry points run
unchanged.

A group comes from `initialize_distributed` (a launcher's RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT, or the arguments), or from `launch`, which
starts one worker per device in this process's place with a FileStore
rendezvous (train uses it for the local devices).
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path

import torch
import torch.distributed as dist


def default_backend() -> str:
    """gloo for CPU tensors, and NCCL for CUDA tensors where CUDA exists."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the default process group of a multi-process run.

    Arguments left None are read from a launcher's environment (WORLD_SIZE,
    or ORCAI_TPU_NUM_PROCESSES as in the JAX package; RANK;
    MASTER_ADDR:MASTER_PORT). A no-op for one process without a coordinator,
    and when the group already exists. `coordinator_address` is host:port
    of rank 0's TCP store.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None:
        num_processes = launched_world_size()
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes <= 1 and coordinator_address is None:
        return
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None:
        raise ValueError(
            f"{num_processes} processes need a coordinator address (host:port)"
        )
    dist.init_process_group(
        default_backend(),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def launched_world_size() -> int:
    """The world size a launcher gave this process (WORLD_SIZE, or
    ORCAI_TPU_NUM_PROCESSES as in the JAX package), 1 without one."""
    return int(os.environ.get("WORLD_SIZE", os.environ.get("ORCAI_TPU_NUM_PROCESSES", "1")))


def join_launched_group() -> None:
    """Join the launcher's group where one started this process among
    several; nothing otherwise (a lone MASTER_ADDR does not start a group
    of one)."""
    if launched_world_size() > 1:
        initialize_distributed()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's rank on its host: LOCAL_RANK where a launcher (or
    `launch`) set it, else the rank modulo the visible CUDA devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() % max(torch.cuda.device_count(), 1)


def local_process_count() -> int:
    """The processes of this run on this host (LOCAL_WORLD_SIZE, else all)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """Rank src's `obj` on every rank (the object itself without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def process_partition(
    n: int, process_id: int | None = None, count: int | None = None
) -> list[int]:
    """Round-robin share of n independent work items owned by this process.

    Deterministic in (process_id, count): every process computes the
    same assignment from the same inputs without communicating. With no
    group, range(n).
    """
    if process_id is None:
        process_id = process_index()
    if count is None:
        count = process_count()
    return [i for i in range(n) if i % count == process_id]


def shard_table_for_process(table, msgr=None):
    """This process's rows of a per-recording work table (a Table or a list
    of rows), split round-robin by position.

    The batch commands (create-spectrograms, create-label-arrays, predict on
    a table) write one independent output per recording, so the same
    command started in every process of a group splits the table with no
    rendezvous beyond the shared file system. One process gets the table
    itself back.
    """
    count = process_count()
    if count <= 1 or len(table) == 0:
        return table
    rows = process_partition(len(table))
    if msgr is not None:
        msgr.info(
            f"Multi-host run: process {process_index()}/{count} owns "
            f"{len(rows)} of {len(table)} recordings"
        )
    if isinstance(table, list):
        return [table[i] for i in rows]
    return table.take(rows)


def make_hybrid_mesh(ici_data: int | None = None, dcn_data: int | None = None):
    """A (dcn, data) grid of the group's ranks: hosts along "dcn", the
    processes of one host along "data", so a reduction over "data" stays
    on the host and only the one over "dcn" crosses the network.

    Defaults: dcn = ranks / processes per host, data = the rest. Returns a
    torch DeviceMesh; mesh.get_group("data") is the in-host group. The mesh
    keeps the group alive: drop it before dist.destroy_process_group(), or
    the group's threads are torn down only at interpreter exit.
    """
    from torch.distributed.device_mesh import init_device_mesh

    world = process_count()
    if dcn_data is None:
        dcn_data = max(1, world // max(local_process_count(), 1))
    if ici_data is None:
        ici_data = world // dcn_data
    if dcn_data * ici_data != world:
        raise ValueError(f"mesh {dcn_data} x {ici_data} does not cover {world} ranks")
    return init_device_mesh("cuda" if torch.cuda.is_available() else "cpu",
                            (dcn_data, ici_data), mesh_dim_names=("dcn", "data"))


# -- one worker per device ------------------------------------------------------


def launch_backend(devices: list[torch.device]) -> str:
    """NCCL (beside gloo) for distinct CUDA devices; gloo otherwise, since
    NCCL refuses two ranks on one device and takes no CPU tensors."""
    distinct_cuda = all(d.type == "cuda" for d in devices) and len(
        {d.index for d in devices}
    ) == len(devices)
    return "cpu:gloo,cuda:nccl" if distinct_cuda else "gloo"


def _backend_flags() -> dict:
    """The math switches a worker takes over from the process that starts
    it (a spawned interpreter starts with the defaults)."""
    return {
        "mkldnn": torch.backends.mkldnn.enabled,
        "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "threads": torch.get_num_threads(),
    }


def _set_backend_flags(flags: dict) -> None:
    torch.backends.mkldnn.enabled = flags["mkldnn"]
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.set_num_threads(flags["threads"])


def _worker(i, fn, devices, store_path, backend, flags, args, kwargs):
    _set_backend_flags(flags)
    os.environ["LOCAL_RANK"] = str(i)
    os.environ["LOCAL_WORLD_SIZE"] = str(len(devices))
    device = devices[i]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, len(devices)),
        rank=i, world_size=len(devices),
    )
    try:
        fn(*args, device=device, **kwargs)
    finally:
        dist.destroy_process_group()


def launch(fn, devices, rendezvous_dir: Path | str, args: tuple = (),
           kwargs: dict | None = None) -> None:
    """Run fn(*args, device=devices[i], **kwargs) in one spawned worker per
    entry of `devices`, the workers joined in a process group (rank i on
    devices[i]) through a FileStore under rendezvous_dir. Returns when every
    worker has; a worker's exception is raised here. A device may be named
    twice (then the group is gloo's)."""
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    rendezvous_dir = Path(rendezvous_dir)
    rendezvous_dir.mkdir(parents=True, exist_ok=True)
    store_path = rendezvous_dir / f".rendezvous-{uuid.uuid4().hex}"
    try:
        mp.start_processes(
            _worker,
            args=(fn, devices, str(store_path), launch_backend(devices),
                  _backend_flags(), tuple(args), dict(kwargs or {})),
            nprocs=len(devices), join=True, start_method="spawn",
        )
    finally:
        store_path.unlink(missing_ok=True)
