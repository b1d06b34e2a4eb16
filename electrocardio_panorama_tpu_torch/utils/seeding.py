"""Determinism (reference utils/seed_torch.py:7-17).

Seeds python, numpy and torch's global generators for stray library calls,
and returns an explicit `torch.Generator` for the draws the port makes itself
(model init). Host-side data randomness stays in per-(epoch, index) numpy
Generators (data/pipeline.py), exactly as in the JAX package.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 123) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
