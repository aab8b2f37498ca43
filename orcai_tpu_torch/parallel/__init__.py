"""Multi-device and multi-process runs (counterpart of orcai_tpu/parallel),
tensor parallelism included (sharding_rules.py over a (data, model)
ProcessMesh)."""

from orcai_tpu_torch.parallel.distributed import (
    initialize_distributed,
    launch,
    make_hybrid_mesh,
    process_count,
    process_index,
    process_partition,
    shard_table_for_process,
)
from orcai_tpu_torch.parallel.mesh import (
    ProcessMesh,
    Replicas,
    local_devices,
    make_mesh,
    mesh_for_batch,
    shard_batch_size,
)
from orcai_tpu_torch.parallel.sharding_rules import (
    gather_params,
    params_shardings,
    shard_params,
)

__all__ = [
    "initialize_distributed",
    "launch",
    "make_hybrid_mesh",
    "process_count",
    "process_index",
    "process_partition",
    "shard_table_for_process",
    "ProcessMesh",
    "Replicas",
    "local_devices",
    "make_mesh",
    "mesh_for_batch",
    "shard_batch_size",
    "gather_params",
    "params_shardings",
    "shard_params",
]
