"""Parameter transfer from the JAX package.

The JAX package keeps its parameters in flat dicts keyed by the reference's
torch-style names, and so does the port, so every key maps by name: only the
array type changes. Callers hand the arrays over as numpy (the port never
imports jax); `np.asarray` on a jax array gives that.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(v, *, dtype=torch.float32, device="cpu") -> torch.Tensor:
    arr = np.array(v)  # a copy: torch.from_numpy shares memory
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(arr.astype(np.int64)).to(device)  # torch BN counters are Long
    return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)


def params_from_jax(params: dict, bn_state: dict, *, dtype=torch.float32, device="cpu"):
    """(params, bn_state) flat dicts of arrays -> the port's flat tensor dicts."""
    return ({k: to_tensor(v, dtype=dtype, device=device) for k, v in params.items()},
            {k: to_tensor(v, dtype=dtype, device=device) for k, v in bn_state.items()})
