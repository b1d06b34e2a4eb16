"""Nef-Net2's operation counts, by hand from its shapes, in the way of
nefnet.py.

Nef-Net2 folds its L leads into the batch: every encode layer runs once per
lead on 128 channels through one shared tower, and adds single_conv_z1 after
z1_conv and single_conv_z2 after the ROI reverse. The decode half is
Nef-Net's.
"""

from __future__ import annotations

from portbench.counts.convs import Layer, block_layers, conv_macs, decoder_layers, forward_flops, step_flops

LEADS = 3


def encode_layers(taps: str = "inside") -> list[Layer]:
    """Every matmul of the encode, per lead of a beat."""
    single = Layer(conv_macs(128, 128, 3, 128, padding=1, taps=taps), "lead", True, True)
    return ([Layer(conv_macs(128, 1, 15, 512, stride=2, padding=7, taps=taps), "lead", False, True)]
            + [Layer(conv_macs(128, 128, 7, 128, padding=3, taps=taps), "lead", True, True)] * 6
            + [Layer(128 * 12, "lead", False, True)]              # mlp1
            + block_layers(128, 128, 1, 128, "lead", taps)         # w_conv
            + block_layers(64, 128, 1, 128, "lead", taps)          # z1_conv
            + [single]                                             # single_conv_z1
            + block_layers(64, 128, 1, 128, "lead", taps)          # z2_conv1
            + block_layers(896, 896, 7, 16, "lead", taps)          # z2_conv2.0
            + [Layer(896 * 64 * 2 * 16, "lead", True, True)]       # ConvTranspose1d k2 s2
            + block_layers(448, 896, 7, 32, "lead", taps)          # z2_conv2.2
            + [Layer(128 * 7 * 32 * 128, "lead", True, False)]     # roi_reverse
            + [single])                                            # single_conv_z2


def train_step_flops(batch: int, lead_num: int = LEADS, taps: str = "inside", backward: bool = True) -> float:
    """One train step at `batch` beats of `lead_num` leads."""
    return step_flops(encode_layers(taps) + decoder_layers(taps), batch, lead_num, backward)


def encode_flops_per_beat(lead_num: int = LEADS, taps: str = "inside") -> float:
    return forward_flops(encode_layers(taps), lead_num)
