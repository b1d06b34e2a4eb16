"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the card. A CUDA request on a machine without one raises:
    the entry points never carry on silently on the CPU; the CPU runs only
    when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
