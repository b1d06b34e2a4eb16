"""The mixed-precision training policy (the JAX package's training/precision.py).

Master params, optimizer state and BN running statistics stay float32. The
forward and backward run in TPU.compute_dtype: the train step casts the
floating params and inputs (rois stay float32: ROI index math is float32),
and autograd carries the cast's gradient back to the float32 masters. Model
outputs and BN-state updates are cast back to float32 before the loss and
the carry. bfloat16 shares float32's exponent range, so no loss scaling.
"""

from __future__ import annotations

import torch


def cast_floats(tree: dict, dtype) -> dict:
    """Cast every floating tensor of a flat dict to `dtype` (ints untouched)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def cast_floats_f32(tree: dict) -> dict:
    return cast_floats(tree, torch.float32)
