"""Multi-device and multi-process runs (counterpart of orcai_tpu/parallel).

Tensor parallelism (orcai_tpu/parallel/sharding_rules.py) is not ported.
"""

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
    Replicas,
    local_devices,
    make_mesh,
    mesh_for_batch,
    shard_batch_size,
)

__all__ = [
    "initialize_distributed",
    "launch",
    "make_hybrid_mesh",
    "process_count",
    "process_index",
    "process_partition",
    "shard_table_for_process",
    "Replicas",
    "local_devices",
    "make_mesh",
    "mesh_for_batch",
    "shard_batch_size",
]
