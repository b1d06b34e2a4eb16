"""The full 1-D ResNet family for ECG classification (reference
codes/network/encoder/resnet_1d.py:97-218; the JAX package's
models/resnet1d.py).

Nef-Net's encoder uses only conv1 and layer1 of a resnet34
(models/encoder.py); this module has the complete towers, the reference's
multi-label ECG classifier:

  * BasicBlock: k7 convs, no BatchNorm, dropout 0.2 (resnet_1d.py:27-53);
  * Bottleneck: k7 / k11 / k7 convs with BatchNorm, expansion 4
    (resnet_1d.py:56-94);
  * a k15 s2 p7 stem grouped by lead_num, maxpool k3 s2 p1, layers 1-4 with
    stride-2 downsampling, adaptive average pool, a Linear head and a
    sigmoid (multi-label, resnet_1d.py:139-158).

The reference's `ResNet.forward` reads `self.bn1`, which it never defines
(resnet_1d.py:141); like the JAX package, the stem here is conv -> relu,
what the Encoder wrapper runs (encoder.py:35-37). Conv weights draw
normal(0, sqrt(2/(k*k*C_out))), BN weight 1 and bias 0 (resnet_1d.py:114-120).

`meta` is the JAX package's static layer plan: {"arch", "block", "plan":
[[{"prefix", "stride", "downsample", "inplanes", "planes"}, ...] per layer],
"lead_num", "out_features"}.

The forward records the span ecgpan.resnet1d.forward (stem to head) with the
children ecgpan.resnet1d.stem, .layer1 to .layer4 and .head, each with the
input's device (utils/profiling.py: they record only under a profiler
session or `recording()`).
"""

from __future__ import annotations

import torch

from electrocardio_panorama_tpu_torch.models import init as inits
from electrocardio_panorama_tpu_torch.models.blocks import DROPOUT_RATE
from electrocardio_panorama_tpu_torch.ops import batch_norm1d, conv1d, dropout, dropout_mask, linear, max_pool1d
from electrocardio_panorama_tpu_torch.utils.profiling import span

LAYER_SPECS = {
    "resnet18": ("basic", [2, 2, 2, 2]),
    "resnet34": ("basic", [3, 4, 6, 3]),
    "resnet50": ("bottleneck", [3, 4, 6, 3]),
    "resnet101": ("bottleneck", [3, 4, 23, 3]),
    "resnet152": ("bottleneck", [3, 8, 36, 3]),
}
_EXPANSION = {"basic": 1, "bottleneck": 4}


def resnet1d_plan(arch: str = "resnet34", *, lead_num: int = 1, init_channels: int = 64) -> dict:
    """The static layer plan (`meta`) of `arch`, without weights."""
    block, layers = LAYER_SPECS[arch]
    exp = _EXPANSION[block]
    plan = []
    inplanes = init_channels * lead_num
    for li, (blocks, mult) in enumerate(zip(layers, (1, 2, 4, 8)), start=1):
        planes = init_channels * mult * lead_num
        layer_plan = []
        for bi in range(blocks):
            stride = 2 if li > 1 and bi == 0 else 1
            downsample = bi == 0 and (stride != 1 or inplanes != planes * exp)
            layer_plan.append({"prefix": f"layer{li}.{bi}", "stride": stride, "downsample": downsample,
                               "inplanes": inplanes, "planes": planes})
            inplanes = planes * exp
        plan.append(layer_plan)
    return {"arch": arch, "block": block, "plan": plan, "lead_num": lead_num, "out_features": inplanes}


def init_resnet1d(generator: torch.Generator, arch: str = "resnet34", *, in_channel: int = 8,
                  num_classes: int = 55, lead_num: int = 1, init_channels: int = 64,
                  dtype=torch.float32, device="cpu"):
    """(params, state, meta): flat dicts under the reference's keys, drawn
    from `generator` (a CPU generator) and moved to `device`, and the layer
    plan."""
    meta = resnet1d_plan(arch, lead_num=lead_num, init_channels=init_channels)
    block, exp = meta["block"], _EXPANSION[meta["block"]]
    params: dict = {}
    state: dict = {}

    def conv_w(name, out_ch, in_pg, k):
        w = torch.empty(out_ch, in_pg, k)
        inits.resnet_(w, generator)
        params[name] = w

    def bn(prefix, ch):
        params[f"{prefix}.weight"], params[f"{prefix}.bias"] = torch.ones(ch), torch.zeros(ch)
        state[f"{prefix}.running_mean"], state[f"{prefix}.running_var"] = torch.zeros(ch), torch.ones(ch)
        state[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    conv_w("conv1.weight", init_channels * lead_num, in_channel // lead_num, 15)
    for bp in (bp for layer_plan in meta["plan"] for bp in layer_plan):
        prefix, inplanes, planes = bp["prefix"], bp["inplanes"], bp["planes"]
        if block == "basic":
            conv_w(f"{prefix}.conv1.weight", planes, inplanes // lead_num, 7)
            conv_w(f"{prefix}.conv2.weight", planes, planes // lead_num, 7)
        else:
            conv_w(f"{prefix}.conv1.weight", planes, inplanes, 7)
            bn(f"{prefix}.bn1", planes)
            conv_w(f"{prefix}.conv2.weight", planes, planes, 11)
            bn(f"{prefix}.bn2", planes)
            conv_w(f"{prefix}.conv3.weight", planes * 4, planes, 7)
            bn(f"{prefix}.bn3", planes * 4)
        if bp["downsample"]:
            conv_w(f"{prefix}.downsample.0.weight", planes * exp,
                   inplanes // (lead_num if block == "basic" else 1), 1)
            bn(f"{prefix}.downsample.1", planes * exp)

    inplanes = meta["out_features"]
    params["fc.weight"], params["fc.bias"] = torch.empty(num_classes, inplanes), torch.empty(num_classes)
    inits.default_(params["fc.weight"], params["fc.bias"], inplanes, generator)
    params = {k: v.to(device=device, dtype=dtype) for k, v in params.items()}
    state = {k: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
             for k, v in state.items()}
    return params, state, meta


def dropout_sites(meta) -> int:
    """One dropout site per block."""
    return sum(len(layer) for layer in meta["plan"])


def mask_shapes(meta, batch: int, length: int) -> list[tuple[int, int, int]]:
    """The shape of each block's dropout input, in block order, for `batch`
    records of `length` samples: the block's planes at the length after its
    strided conv (conv1 of a BasicBlock, conv2 of a Bottleneck)."""
    n = ((length + 2 * 7 - 15) // 2 + 1 - 1) // 2 + 1  # the stem conv, then the maxpool
    shapes = []
    for bp in (bp for layer_plan in meta["plan"] for bp in layer_plan):
        n = (n - 1) // bp["stride"] + 1
        shapes.append((batch, bp["planes"], n))
    return shapes


def resnet1d_apply(params: dict, state: dict, meta: dict, x, *, train: bool = False, masks=None,
                   generator: torch.Generator | None = None, features_only: bool = False):
    """x [B, in_channel, T] -> ([B, num_classes] sigmoid multi-label scores,
    or the pooled features [B, out_features] when `features_only`; BN state
    updates, empty at eval).

    Train mode normalizes with batch statistics and applies dropout from
    `masks` (one pre-scaled mask per block, in block order, shaped like the
    block's dropout input) or, without them, from masks drawn from
    `generator` as the blocks reach them; with neither, dropout passes
    through."""
    p, s = params, state
    updates: dict = {}
    block, g = meta["block"], meta["lead_num"]
    site = iter(masks if masks is not None else [None] * dropout_sites(meta))

    def drop(h):
        m = next(site)
        if train and m is None and generator is not None:
            m = dropout_mask(h.shape, DROPOUT_RATE, generator, dtype=h.dtype)
        return dropout(h, DROPOUT_RATE, m, train)

    def bn(prefix, h):
        args = (h, p[f"{prefix}.weight"], p[f"{prefix}.bias"], s[f"{prefix}.running_mean"],
                s[f"{prefix}.running_var"])
        if not train:
            return batch_norm1d(*args)
        out, mean, var = batch_norm1d(*args, train=True)
        updates[f"{prefix}.running_mean"], updates[f"{prefix}.running_var"] = mean, var
        updates[f"{prefix}.num_batches_tracked"] = s[f"{prefix}.num_batches_tracked"] + 1
        return out

    def block_apply(bp, h):
        prefix, stride = bp["prefix"], bp["stride"]
        if block == "basic":
            out = torch.relu(conv1d(h, p[f"{prefix}.conv1.weight"], stride=stride, padding=3, groups=g))
            out = conv1d(drop(out), p[f"{prefix}.conv2.weight"], padding=3, groups=g)
        else:
            out = torch.relu(bn(f"{prefix}.bn1", conv1d(h, p[f"{prefix}.conv1.weight"], padding=3)))
            out = conv1d(out, p[f"{prefix}.conv2.weight"], stride=stride, padding=5)
            out = drop(torch.relu(bn(f"{prefix}.bn2", out)))
            out = bn(f"{prefix}.bn3", conv1d(out, p[f"{prefix}.conv3.weight"], padding=3))
        residual = h
        if bp["downsample"]:
            residual = conv1d(h, p[f"{prefix}.downsample.0.weight"], stride=stride,
                              groups=g if block == "basic" else 1)
            residual = bn(f"{prefix}.downsample.1", residual)
        return torch.relu(out + residual)

    dev = x.device
    with span("ecgpan.resnet1d.forward", device=dev):
        with span("ecgpan.resnet1d.stem", device=dev):
            h = max_pool1d(torch.relu(conv1d(x, p["conv1.weight"], stride=2, padding=7, groups=g)))
        for li, layer_plan in enumerate(meta["plan"], start=1):
            with span(f"ecgpan.resnet1d.layer{li}", device=dev):
                for bp in layer_plan:
                    h = block_apply(bp, h)
        with span("ecgpan.resnet1d.head", device=dev):
            pooled = h.mean(dim=2)  # AdaptiveAvgPool1d(1)
            if features_only:
                return pooled, updates
            return torch.sigmoid(linear(pooled, p["fc.weight"], p["fc.bias"])), updates
