"""Parameter initializers with the reference's PyTorch-default distributions,
drawn from an explicit `torch.Generator` (the JAX package's models/init.py).

  * Conv1d layers inside the ResNet tower: normal(0, sqrt(2/n)) with the
    reference's n = k*k*out_channels quirk (resnet_1d.py:114-117).
  * Everything at the Model_nefnet level keeps torch defaults:
    U(+-sqrt(1/fan_in)) weights and U(+-1/sqrt(fan_in)) biases, with torch's
    fan_in conventions (Conv1d (in/groups)*k, ConvTranspose1d (out/groups)*k,
    Linear in).
"""

from __future__ import annotations

import math

import torch


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def default_(weight, bias, fan_in: int, generator: torch.Generator) -> None:
    """torch default init of a Conv1d / ConvTranspose1d / Linear."""
    uniform_(weight, math.sqrt(1.0 / fan_in), generator)
    if bias is not None:
        uniform_(bias, 1.0 / math.sqrt(fan_in), generator)


def resnet_(weight, generator: torch.Generator) -> None:
    """Reference ResNet conv init: normal(0, sqrt(2/(k*k*out_channels)))."""
    out_ch, _, k = weight.shape
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / (k * k * out_ch)), generator=generator)
