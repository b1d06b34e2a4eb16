"""Building blocks shared by the encoder and Nef-Net: a module tree that
fixes the torch-style checkpoint keys, and eval/train functions over the flat
{name: tensor} dicts that the tree's `named_parameters()` / `named_buffers()`
give (the JAX package's models/blocks.py).

Block semantics match the reference exactly:
  * resnet BasicBlock (k7, no BN): conv1 -> relu -> dropout(0.2) -> conv2 +
    identity residual -> relu (reference resnet_1d.py:27-53);
  * model-level BasicBlock (k3): the same, but the residual passes through a
    grouped 1x1 conv iff channel counts differ (model_nefnet.py:36-60); the
    1x1 conv's parameters exist either way (checkpoint-key compatibility);
  * DoubleConv: (conv k3 -> BN -> relu) x2 (model_nefnet.py:10-27).
"""

from __future__ import annotations

import torch
from torch import nn

from electrocardio_panorama_tpu_torch.models import init as inits
from electrocardio_panorama_tpu_torch.ops import batch_norm1d, conv1d, dropout, group_batch_norm1d

DROPOUT_RATE = 0.2


# ------------------------------------------------------------ key schema
class Conv(nn.Module):
    """Parameter holder of one conv / linear layer. `fan_in` picks torch's
    default init; `resnet=True` the reference ResNet init."""

    def __init__(self, weight_shape, bias: int | None = None, *, fan_in: int | None = None,
                 resnet: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(bias)) if bias is not None else None
        self.fan_in = fan_in
        self.resnet = resnet

    def reset(self, generator: torch.Generator) -> None:
        if self.resnet:
            inits.resnet_(self.weight, generator)
        else:
            inits.default_(self.weight, self.bias, self.fan_in, generator)


def conv(out_ch: int, in_pg: int, k: int, *, bias: bool) -> Conv:
    return Conv((out_ch, in_pg, k), out_ch if bias else None, fan_in=in_pg * k)


class BatchNorm(nn.Module):
    """BatchNorm1d's parameters and buffers under torch's names."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))
        self.register_buffer("running_mean", torch.empty(ch))
        self.register_buffer("running_var", torch.empty(ch))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def reset(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()


def resnet_block(in_ch: int, out_ch: int, groups: int) -> nn.ModuleDict:
    return nn.ModuleDict({"conv1": Conv((out_ch, in_ch // groups, 7), resnet=True),
                          "conv2": Conv((out_ch, out_ch // groups, 7), resnet=True)})


def model_block(in_ch: int, out_ch: int, groups: int) -> nn.ModuleDict:
    return nn.ModuleDict({"conv1": conv(out_ch, in_ch // groups, 3, bias=False),
                          "conv2": conv(out_ch, out_ch // groups, 3, bias=False),
                          "residual_conv": conv(out_ch, in_ch // groups, 1, bias=True)})


def double_conv(in_ch: int, out_ch: int) -> nn.ModuleDict:
    # numeric keys follow the reference's nn.Sequential (2 and 5 are ReLUs)
    return nn.ModuleDict({"double_conv": nn.ModuleDict({
        "0": conv(out_ch, in_ch, 3, bias=True), "1": BatchNorm(out_ch),
        "3": conv(out_ch, out_ch, 3, bias=True), "4": BatchNorm(out_ch)})})


# ----------------------------------------------------------------- apply
# `mask` is the block's pre-scaled dropout mask (ops.dropout_mask), shaped
# like the conv1 output; None, or train=False, is the eval block. `conv` is
# the block's convolution primitive (ops.conv1d or ops.conv1d_measured).
def resnet_block_apply(p: dict, prefix: str, x, *, groups: int, mask=None, train: bool = False,
                       conv=conv1d):
    out = torch.relu(conv(x, p[f"{prefix}.conv1.weight"], padding=3, groups=groups))
    out = dropout(out, DROPOUT_RATE, mask, train)
    out = conv(out, p[f"{prefix}.conv2.weight"], padding=3, groups=groups)
    return torch.relu(out + x)


def model_block_apply(p: dict, prefix: str, x, *, groups: int, mask=None, train: bool = False,
                      conv=conv1d):
    out = torch.relu(conv(x, p[f"{prefix}.conv1.weight"], padding=1, groups=groups))
    out = dropout(out, DROPOUT_RATE, mask, train)
    out = conv(out, p[f"{prefix}.conv2.weight"], padding=1, groups=groups)
    residual = x
    if out.shape[1] != x.shape[1]:
        residual = conv(x, p[f"{prefix}.residual_conv.weight"], p[f"{prefix}.residual_conv.bias"],
                        groups=groups)
    return torch.relu(out + residual)


def double_conv_apply(p: dict, s: dict, prefix: str, x, *, train: bool = False, bn_groups: int = 1,
                      bn_sync=None):
    """Eval: BN normalizes with the running statistics; returns the output.
    Train: batch statistics, per group when `bn_groups` > 1 (x group-major,
    ops.group_batch_norm1d), over every rank's batch under `bn_sync`;
    returns (out, state updates), where the updates hold the new running
    stats and `num_batches_tracked + bn_groups`."""
    updates = {}

    def bn(h, i):
        args = (h, p[f"{prefix}.{i}.weight"], p[f"{prefix}.{i}.bias"],
                s[f"{prefix}.{i}.running_mean"], s[f"{prefix}.{i}.running_var"])
        if not train:
            return batch_norm1d(*args)
        if bn_groups > 1:
            out, m, v = group_batch_norm1d(*args, groups=bn_groups, sync=bn_sync)
        else:
            out, m, v = batch_norm1d(*args, train=True, sync=bn_sync)
        updates[f"{prefix}.{i}.running_mean"] = m
        updates[f"{prefix}.{i}.running_var"] = v
        updates[f"{prefix}.{i}.num_batches_tracked"] = s[f"{prefix}.{i}.num_batches_tracked"] + bn_groups
        return out

    out = conv1d(x, p[f"{prefix}.0.weight"], p[f"{prefix}.0.bias"], padding=1)
    out = torch.relu(bn(out, 1))
    out = conv1d(out, p[f"{prefix}.3.weight"], p[f"{prefix}.3.bias"], padding=1)
    out = torch.relu(bn(out, 4))
    return (out, updates) if train else out
