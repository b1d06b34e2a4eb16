"""Multiply-adds of 1-D convolutions and matmuls, and a train step's
operations from a list of layers: the arithmetic that the configurations'
counts share.

A layer's forward is 2 operations per multiply-add. Its backward takes a data
gradient (when its input carries one) and a weight gradient (when it has
weights that train), each as many operations as the forward. Elementwise
work (biases, relu, BatchNorm, dropout, upsampling, the gates, the loss,
SGD) is left out. `taps="inside"` counts only the taps that land inside the
input, the published count; `taps="all"` counts every tap, zero padding too,
as `torch.utils.flop_counter.FlopCounterMode` does.
"""

from __future__ import annotations

from typing import NamedTuple


class Layer(NamedTuple):
    macs: int          # multiply-adds of one forward, per `per` unit
    per: str           # "beat" (once per beat), "lead" (once per lead of a beat), "decode" (three per beat)
    dgrad: bool        # the input takes a gradient
    wgrad: bool        # the weights take a gradient


def conv_macs(c_out: int, c_in_per_group: int, k: int, l_in: int, *, stride: int = 1, padding: int = 0,
              taps: str = "inside") -> int:
    """Multiply-adds of one conv1d, over the taps inside the input or over
    every tap."""
    l_out = (l_in + 2 * padding - k) // stride + 1
    if taps == "all":
        n = l_out * k
    else:
        n = sum(1 for o in range(l_out) for j in range(k) if 0 <= o * stride - padding + j < l_in)
    return c_out * c_in_per_group * n


def block_layers(c_in: int, c_out: int, groups: int, length: int, per: str, taps: str) -> list[Layer]:
    """The model-level BasicBlock: conv1 and conv2 (k3, padding 1, no bias)
    and the 1x1 residual conv when the channel counts differ."""
    out = [Layer(conv_macs(c_out, c_in // groups, 3, length, padding=1, taps=taps), per, True, True),
           Layer(conv_macs(c_out, c_out // groups, 3, length, padding=1, taps=taps), per, True, True)]
    if c_in != c_out:
        out.append(Layer(conv_macs(c_out, c_in // groups, 1, length, taps=taps), per, True, True))
    return out


def decoder_layers(taps: str) -> list[Layer]:
    """The mlp2 gate (once per beat) and the decoder [256, 128] -> [1, 512],
    three decodes per beat in a train step."""
    convs = [(128, 256, 256), (128, 128, 256), (64, 128, 512), (64, 64, 512), (1, 64, 512)]
    return ([Layer(256 * 12, "beat", False, True)]
            + [Layer(conv_macs(o, i, 3, n, padding=1, taps=taps), "decode", True, True) for o, i, n in convs])


def step_flops(layers: list[Layer], batch: int, lead_num: int, backward: bool = True) -> float:
    """Operations of one train step for `batch` beats: the forward and, with
    `backward`, the data and weight gradients of every layer."""
    reps = {"beat": 1, "lead": lead_num, "decode": 3}
    return float(sum(2 * batch * reps[ly.per] * ly.macs * (1 + backward * (ly.dgrad + ly.wgrad))
                     for ly in layers))


def forward_flops(layers: list[Layer], lead_num: int) -> float:
    """Operations of one beat's forward through `layers` (one decode)."""
    reps = {"beat": 1, "lead": lead_num, "decode": 1}
    return float(sum(2 * reps[ly.per] * ly.macs for ly in layers))
