"""Parallelism over torch.distributed: the process group, the device mesh,
the dp step's collectives, the view-sharded panorama, and lead tensor
parallelism (the 3-axis train step and the lead-parallel panorama)."""

from electrocardio_panorama_tpu_torch.parallel.mesh import make_mesh
from electrocardio_panorama_tpu_torch.parallel.multihost import (
    ensure_initialized,
    local_batch_slice,
    process_count,
    process_index,
)
from electrocardio_panorama_tpu_torch.parallel.sharding import (
    LEAD_PREFIXES,
    BatchStatSync,
    all_reduce_mean_,
    build_3d_train_step,
    build_lead_parallel_panorama,
    build_sharded_panorama,
    gather_lead_params,
    lead_param_specs,
    opt_state_specs,
    shard_lead_params,
    synced_train_decode_fn,
)

__all__ = [
    "make_mesh",
    "ensure_initialized",
    "local_batch_slice",
    "process_count",
    "process_index",
    "LEAD_PREFIXES",
    "BatchStatSync",
    "all_reduce_mean_",
    "build_3d_train_step",
    "build_lead_parallel_panorama",
    "build_sharded_panorama",
    "gather_lead_params",
    "lead_param_specs",
    "opt_state_specs",
    "shard_lead_params",
    "synced_train_decode_fn",
]
