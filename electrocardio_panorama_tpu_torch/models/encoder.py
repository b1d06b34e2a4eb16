"""Grouped 1-D ResNet encoder (the W-encoder of Nef-Net).

The reference keeps only conv1/relu/maxpool/layer1 of a resnet34
(codes/network/encoder/encoder.py:19-26):

  conv1 k15 s2 p7 grouped by lead -> relu -> maxpool k3 s2 p1
  -> layer1: 3 BasicBlocks (k7, no BatchNorm, dropout 0.2)

[B, lead_num, 512] -> [B, 128*lead_num, 128]; each lead owns a private
128-channel tower through the conv groups.
"""

from __future__ import annotations

import torch
from torch import nn

from electrocardio_panorama_tpu_torch.models.blocks import Conv, resnet_block, resnet_block_apply
from electrocardio_panorama_tpu_torch.ops import conv1d, max_pool1d

NUM_LAYER1_BLOCKS = 3  # resnet34 layers[0] == 3 (resnet_1d.py:180)


def encoder(lead_num: int, init_channels: int = 128) -> nn.ModuleDict:
    ch = init_channels * lead_num
    return nn.ModuleDict({
        "conv1": Conv((ch, 1, 15), resnet=True),
        "layer1": nn.ModuleDict({str(i): resnet_block(ch, ch, lead_num)
                                 for i in range(NUM_LAYER1_BLOCKS)}),
    })


def encoder_apply(p: dict, prefix: str, x, *, lead_num: int, masks=None, train: bool = False,
                  conv=conv1d):
    """x [B, lead_num, 512] -> [B, 128*lead_num, 128]. In train mode `masks`
    holds the three layer1 blocks' dropout masks, each [B, 128*lead_num, 128].
    `conv` is every convolution's primitive (blocks.py)."""
    h = torch.relu(conv(x, p[f"{prefix}.conv1.weight"], stride=2, padding=7, groups=lead_num))
    h = max_pool1d(h, kernel=3, stride=2, padding=1)
    for i in range(NUM_LAYER1_BLOCKS):
        h = resnet_block_apply(p, f"{prefix}.layer1.{i}", h, groups=lead_num,
                               mask=masks[i] if train else None, train=train, conv=conv)
    return h
