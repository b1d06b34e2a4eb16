"""Process-group start from the launcher's environment (the JAX package's
parallel/multihost.py, on torch.distributed).

One process drives one device, PyTorch's idiom: `torchrun --nproc-per-node N
-m electrocardio_panorama_tpu_torch.main ...` sets RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT and LOCAL_RANK for every process, and
`ensure_initialized` joins them into the default group. The backend is NCCL
for a CUDA device and gloo for the CPU; neither stands in for the other.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_initialized(device="cuda") -> bool:
    """Start the default process group from the launcher's environment.
    Returns True when a group is running (already, or now); without the
    launcher's variables it does nothing and returns False."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in LAUNCHER_ENV):
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(device), init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch: int) -> slice:
    """The [start, stop) slice of the global batch this process loads.

    Raises when the global batch does not divide evenly: dropping the
    remainder would give the ranks different batches."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    start = process_index() * per
    return slice(start, start + per)
