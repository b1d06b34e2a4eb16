"""Data parallelism over torch.distributed: the process group, the device
mesh, the dp step's collectives and the view-sharded panorama."""

from electrocardio_panorama_tpu_torch.parallel.mesh import make_mesh
from electrocardio_panorama_tpu_torch.parallel.multihost import (
    ensure_initialized,
    local_batch_slice,
    process_count,
    process_index,
)
from electrocardio_panorama_tpu_torch.parallel.sharding import (
    BatchStatSync,
    all_reduce_mean_,
    build_sharded_panorama,
    synced_train_decode_fn,
)

__all__ = [
    "make_mesh",
    "ensure_initialized",
    "local_batch_slice",
    "process_count",
    "process_index",
    "BatchStatSync",
    "all_reduce_mean_",
    "build_sharded_panorama",
    "synced_train_decode_fn",
]
