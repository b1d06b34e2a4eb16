"""Plain 1-D ResNet classifier in PyTorch, float32: the yardstick that decides
`correct` for the classifier's cells.

The reference's codes/network/encoder/resnet_1d.py (github.com/WhatAShot/
Electrocardio-Panorama), written from its layer equations with
`torch.nn.functional` alone: no kernel, no cache, no batching trick. It
imports nothing of the program, of JAX or of the JAX package, and runs its
convolutions and matmuls at full float32 (TF32 off) unless asked for the TF32
control.

  * stem: conv1 k15 stride 2 padding 7, grouped by lead_num, no bias;
    maxpool k3 s2 p1 (resnet_1d.py:102-105);
  * Bottleneck (resnet_1d.py:56-94): conv k7 p3 -> BN -> relu -> conv k11
    (the block's stride) p5 -> BN -> relu -> dropout 0.2 -> conv k7 p3 to 4x
    the planes -> BN, plus the residual (a 1x1 strided conv and BN at a
    stage's first block), then relu;
  * BasicBlock (resnet_1d.py:27-53): conv k7 (stride) p3 -> relu -> dropout
    0.2 -> conv k7 p3, both grouped by lead_num, no BN, plus the residual (a
    grouped 1x1 strided conv and BN where the shape changes), then relu;
  * layers of planes 64, 128, 256, 512 x init_channels / 64, stride 2 from
    the second; average pool over time, Linear, sigmoid (resnet_1d.py:139-158);
  * BatchNorm in train mode normalizes with the batch's biased variance and
    moves the running statistics by momentum 0.1 with the unbiased one
    (`F.batch_norm`), and counts num_batches_tracked;
  * SGD with momentum 0.9 is written out: buf = 0.9 buf + g, p -= lr buf.

Departures, each as the program has them:
  * the stem is conv -> relu -> maxpool: `ResNet.forward` reads `self.bn1`,
    which the reference never defines (resnet_1d.py:141);
  * the loss is the mean binary cross-entropy of the sigmoid scores, each
    log clamped at -100 as torch's `binary_cross_entropy` clamps it: the
    reference gives its classifier no loss;
  * dropout takes explicit pre-scaled masks (0 or 1/0.8), drawn per step from
    a torch.Generator seeded from (seed, epoch, step), one per block in block
    order, shaped like the block's dropout input (`dropout_masks`): the
    program's rule, frozen here, so that both sides drop the same units.

Weights are a flat {torch-style name: tensor} dict under the reference's
state_dict keys (`param_table`, `bn_state_table` give names and shapes).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LAYER_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}
EXPANSION = {"basic": 1, "bottleneck": 4}
DROPOUT = 0.2
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 convolutions and matmuls at full float32 (tf32=False), or in
    TF32 (tf32=True, the control), restoring the process's flags after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Arch:
    """The static shape of one classifier: its block kind and, per block,
    (name, in planes, planes, stride, downsample)."""

    def __init__(self, arch: str = "resnet50", *, in_channel: int = 8, num_classes: int = 55,
                 lead_num: int = 1, init_channels: int = 64):
        self.kind, counts = LAYER_SPECS[arch]
        self.in_channel, self.num_classes = in_channel, num_classes
        self.lead_num, self.init_channels = lead_num, init_channels
        exp = EXPANSION[self.kind]
        self.blocks = []
        inplanes = init_channels * lead_num
        for li, n in enumerate(counts):
            planes = init_channels * 2 ** li * lead_num
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                down = bi == 0 and (stride != 1 or inplanes != planes * exp)
                self.blocks.append((f"layer{li + 1}.{bi}", inplanes, planes, stride, down))
                inplanes = planes * exp
        self.features = inplanes


# ------------------------------------------------------------------ parameters
def param_table(a: Arch) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter: init 'normal' (std
    scale, the reference's sqrt(2 / (k*k*out)), resnet_1d.py:114-117),
    'uniform' (bound scale, torch's Linear default), 'bn_weight' or
    'bn_bias'."""
    rows = []
    g = a.lead_num

    def conv(name, out, in_pg, k):
        rows.append((f"{name}.weight", (out, in_pg, k), "normal", math.sqrt(2.0 / (k * k * out))))

    def bn(name, c):
        rows.extend([(f"{name}.weight", (c,), "bn_weight", 1.0), (f"{name}.bias", (c,), "bn_bias", 1.0)])

    conv("conv1", a.init_channels * g, a.in_channel // g, 15)
    for name, inplanes, planes, _, down in a.blocks:
        if a.kind == "basic":
            conv(f"{name}.conv1", planes, inplanes // g, 7)
            conv(f"{name}.conv2", planes, planes // g, 7)
        else:
            conv(f"{name}.conv1", planes, inplanes, 7)
            bn(f"{name}.bn1", planes)
            conv(f"{name}.conv2", planes, planes, 11)
            bn(f"{name}.bn2", planes)
            conv(f"{name}.conv3", planes * 4, planes, 7)
            bn(f"{name}.bn3", planes * 4)
        if down:
            exp = EXPANSION[a.kind]
            conv(f"{name}.downsample.0", planes * exp, inplanes // (g if a.kind == "basic" else 1), 1)
            bn(f"{name}.downsample.1", planes * exp)
    rows.append(("fc.weight", (a.num_classes, a.features), "uniform", 1 / math.sqrt(a.features)))
    rows.append(("fc.bias", (a.num_classes,), "uniform", 1 / math.sqrt(a.features)))
    return rows


def bn_state_table(a: Arch) -> list[tuple[str, tuple]]:
    """(name, channels) of every BatchNorm layer's running statistics."""
    return [(name[: -len(".weight")], shape) for name, shape, init, _ in param_table(a) if init == "bn_weight"]


# ------------------------------------------------------------------ forward
def dropout_shapes(a: Arch, batch: int, length: int) -> list[tuple[int, int, int]]:
    """The shape of each block's dropout input, in block order."""
    n = (length + 2 * 7 - 15) // 2 + 1
    n = (n + 2 - 3) // 2 + 1
    shapes = []
    for _, _, planes, stride, _ in a.blocks:
        n = (n - 1) // stride + 1  # the strided conv: k11 p5 (Bottleneck) or k7 p3 (BasicBlock)
        shapes.append((batch, planes, n))
    return shapes


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The dropout generator's seed of a train step, a function of (seed,
    epoch, step) alone (the program's rule, frozen here)."""
    return int(np.random.SeedSequence([seed, epoch, step, 0xD809]).generate_state(1)[0])


def dropout_masks(a: Arch, seed: int, epoch: int, step: int, batch: int, length: int, device) -> list:
    """The step's pre-scaled dropout masks (0 or 1/0.8), one per block,
    drawn in block order from a torch.Generator on `device` seeded by
    step_seed."""
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, epoch, step))
    keep = 1.0 - DROPOUT
    out = []
    for shape in dropout_shapes(a, batch, length):
        u = torch.rand(shape, generator=gen, device=device)
        out.append((u < keep).to(torch.float32) * torch.tensor(1.0 / keep, device=device))
    return out


def batch_norm(p, s, name, x, train: bool):
    if train:
        s[f"{name}.num_batches_tracked"] += 1
    return F.batch_norm(x, s[f"{name}.running_mean"], s[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], training=train, momentum=BN_MOMENTUM, eps=BN_EPS)


def block(a: Arch, p, s, blk, x, mask, train: bool):
    name, _, _, stride, down = blk
    g = a.lead_num
    if a.kind == "basic":
        out = F.relu(F.conv1d(x, p[f"{name}.conv1.weight"], stride=stride, padding=3, groups=g))
        out = out * mask if mask is not None else out
        out = F.conv1d(out, p[f"{name}.conv2.weight"], padding=3, groups=g)
    else:
        out = F.relu(batch_norm(p, s, f"{name}.bn1", F.conv1d(x, p[f"{name}.conv1.weight"], padding=3), train))
        out = F.conv1d(out, p[f"{name}.conv2.weight"], stride=stride, padding=5)
        out = F.relu(batch_norm(p, s, f"{name}.bn2", out, train))
        out = out * mask if mask is not None else out
        out = batch_norm(p, s, f"{name}.bn3", F.conv1d(out, p[f"{name}.conv3.weight"], padding=3), train)
    residual = x
    if down:
        residual = F.conv1d(x, p[f"{name}.downsample.0.weight"], stride=stride,
                            groups=g if a.kind == "basic" else 1)
        residual = batch_norm(p, s, f"{name}.downsample.1", residual, train)
    return F.relu(out + residual)


def forward(a: Arch, p, s, x, masks=None, train: bool = False):
    """x [B, in_channel, T] -> sigmoid scores [B, num_classes]. Train mode
    (batch statistics, dropout from `masks`) moves `s`'s running statistics
    in place."""
    h = F.relu(F.conv1d(x, p["conv1.weight"], stride=2, padding=7, groups=a.lead_num))
    h = F.max_pool1d(h, kernel_size=3, stride=2, padding=1)
    for i, blk in enumerate(a.blocks):
        h = block(a, p, s, blk, h, masks[i] if masks is not None else None, train)
    return torch.sigmoid(F.linear(h.mean(dim=2), p["fc.weight"], p["fc.bias"]))


def bce(probs, labels):
    """Mean binary cross-entropy, each log clamped at -100."""
    return -(labels * torch.log(probs).clamp(min=-100)
             + (1 - labels) * torch.log(1 - probs).clamp(min=-100)).mean()


# ------------------------------------------------------------------ train step
def train_steps(a: Arch, params, bn_state, batches, seed, lr, *, tf32=False, epoch=0, momentum=0.9,
                weight_decay=0.0, rows=None, past_grads=()):
    """Run len(batches) train steps from (params, bn_state); a batch is
    {'data': [B, in_channel, T] float32, 'label': [B, C] float32}. Returns
    {'losses': [steps, 1], 'grads': {name: first step's gradient}, 'params':
    the params after the steps, 'bn_state': the running statistics after
    them}, on the params' device; nothing of the inputs is modified.

    `past_grads`, the gradients of the steps before these (oldest first),
    restarts a run in the middle: the batches are then steps len(past_grads)
    onward (their dropout masks), and SGD's momentum buffer starts as those
    gradients made it. `rows` keeps only each batch's first rows (and their
    masks), and `weight_decay` adds weight_decay * p to each gradient before
    the momentum (0 in every cell): faults that the comparison has to
    catch."""
    dev = next(iter(params.values())).device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    s = {k: v.detach().clone() for k, v in bn_state.items()}
    buf, losses, first = {}, [], None

    def accumulate(k, g):
        buf[k] = g.clone() if k not in buf else buf[k].mul_(momentum).add_(g)

    for past in past_grads:
        for k, g in past.items():
            accumulate(k, g)
    with matmul_precision(tf32):
        for step, batch in enumerate(batches, start=len(past_grads)):
            x, y = batch["data"], batch["label"]
            masks = dropout_masks(a, seed, epoch, step, x.shape[0], x.shape[-1], dev)
            if rows is not None:
                x, y, masks = x[:rows], y[:rows], [m[:rows] for m in masks]
            loss = bce(forward(a, p, s, x, masks, train=True), y)
            grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            losses.append(loss.detach()[None])
            with torch.no_grad():
                for (k, v), g in zip(p.items(), grads):
                    if g is None:
                        continue
                    accumulate(k, g + weight_decay * v if weight_decay else g)
                    v.sub_(lr * buf[k])
            if first is None:
                first = {k: g.detach() for k, g in zip(p, grads) if g is not None}
    return {"losses": torch.stack(losses), "grads": first,
            "params": {k: v.detach() for k, v in p.items()}, "bn_state": s}
