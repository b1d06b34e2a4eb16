"""Linear x2 upsampling with PyTorch half-pixel (align_corners=False) parity.

The reference decoder upsamples with `nn.Upsample(scale_factor=2,
mode='linear', align_corners=False)` (codes/network/model_nefnet.py:102,104):
even outputs are 0.25*x[k-1] + 0.75*x[k], odd outputs 0.75*x[k] +
0.25*x[k+1], with the neighbours clamped at the edges.
"""

from __future__ import annotations

import torch


def upsample_linear_x2(x: torch.Tensor) -> torch.Tensor:
    """[..., L] -> [..., 2L]."""
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)   # x[k-1], edge-clamped
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)  # x[k+1], edge-clamped
    even = 0.25 * left + 0.75 * x
    odd = 0.75 * x + 0.25 * right
    return torch.stack([even, odd], dim=-1).reshape(*x.shape[:-1], 2 * x.shape[-1])
