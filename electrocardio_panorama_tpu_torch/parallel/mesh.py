"""Device mesh over torch.distributed (the JAX package's parallel/mesh.py).

Named axes, as in the JAX package:

    data : the batch; gradients and loss components are averaged over it
    lead : encoder tensor parallelism; each rank holds and encodes a block of
           the leads (parallel/sharding.py, `build_3d_train_step`)
    view : the panorama's viewpoint sweep; each rank decodes a slice of it
           (in the 3-axis train step, a second batch axis)

The JAX package spreads one process over all its local devices. Here one
process drives one device, so a mesh covers exactly the world's ranks: its
size must equal the world size.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from electrocardio_panorama_tpu_torch.parallel.multihost import backend_for


def make_mesh(shape, axes=("data",), device="cuda") -> DeviceMesh:
    """A DeviceMesh of `shape` with the first len(shape) names of `axes`.

    Raises unless the mesh's size equals the world size. A mesh of one in a
    process that no launcher started gets a process group of one, on an
    in-process store."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)[: len(shape)]
    if len(axes) != len(shape):
        raise ValueError(f"mesh_shape {list(shape)} needs {len(shape)} axis names, got {list(axes)}")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"mesh_shape {list(shape)} needs {n} ranks, but the world size is 1: start one "
                             f"process per device, e.g. torchrun --nproc-per-node {n}")
        dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh_shape {list(shape)} needs {n} ranks, but the world size is {world}")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)
