"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the 700 W power limit). A card set below 700 W runs slower; the
benchmark prints the card's power limit beside every share of these."""

from __future__ import annotations

FLOPS = {"float32": 67e12, "bfloat16": 989e12}
BYTES_PER_S = 3.35e12


def peak_flops(dtype: str) -> float:
    """The peak rate of `dtype`'s arithmetic: float32 outside the tensor
    cores, bfloat16 on them."""
    return FLOPS[dtype]


def bound_s(flops: float, n_bytes: float, dtype: str) -> float:
    """Least time for this work on the card: operations over the dtype's
    peak, or bytes (each input read once, each output written once) over the
    HBM rate, whichever is longer."""
    return max(flops / peak_flops(dtype), n_bytes / BYTES_PER_S)
