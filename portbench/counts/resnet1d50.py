"""The 1-D ResNet-50 classifier's operation counts, by hand from its shapes
(the reference's resnet_1d.py: a k15 stride-2 stem, maxpool k3 s2 p1, 16
Bottleneck blocks of k7 / k11 (strided) / k7 convs at 64-512 planes, expansion
4, a 1x1 strided downsample at each stage's first block, a Linear head),
over counts/convs.py's layer list. BatchNorm, relu, dropout, the pooling, the
sigmoid, the loss and SGD are elementwise and left out, as convs.py says.

At the published sizes (8 leads x 5000 samples, 55 labels) a record's
forward is 41.30 GFLOP over the taps inside the input (41.59 over every tap,
zero padding too), and a train step at batch 64 is 7.93 TFLOP.
"""

from __future__ import annotations

from portbench.counts.convs import Layer, conv_macs, step_flops
from portbench.counts.convs import forward_flops as _forward

LAYERS = (3, 4, 6, 3)
EXPANSION = 4


def layers(taps: str = "inside", *, in_channel: int = 8, length: int = 5000, init_channels: int = 64,
           num_classes: int = 55, blocks=LAYERS) -> list[Layer]:
    """Every matmul of one record's forward, in order."""
    n = (length + 2 * 7 - 15) // 2 + 1
    out = [Layer(conv_macs(init_channels, in_channel, 15, length, stride=2, padding=7, taps=taps), "beat",
                 False, True)]
    n = (n + 2 - 3) // 2 + 1  # maxpool k3 s2 p1
    inplanes = init_channels
    for li, count in enumerate(blocks):
        planes = init_channels * 2 ** li
        for bi in range(count):
            stride = 2 if li > 0 and bi == 0 else 1
            m = (n - 1) // stride + 1
            out += [Layer(conv_macs(planes, inplanes, 7, n, padding=3, taps=taps), "beat", True, True),
                    Layer(conv_macs(planes, planes, 11, n, stride=stride, padding=5, taps=taps), "beat", True, True),
                    Layer(conv_macs(planes * EXPANSION, planes, 7, m, padding=3, taps=taps), "beat", True, True)]
            if bi == 0:
                out.append(Layer(conv_macs(planes * EXPANSION, inplanes, 1, n, stride=stride, taps=taps), "beat",
                                 True, True))
            inplanes, n = planes * EXPANSION, m
    out.append(Layer(inplanes * num_classes, "beat", True, True))  # fc
    return out


def forward_flops(batch: int, taps: str = "inside", **sizes) -> float:
    """The forward of `batch` records (resnet_forward_roofline's count)."""
    return batch * _forward(layers(taps, **sizes), 1)


def train_step_flops(batch: int, lead_num: int = 1, taps: str = "inside", backward: bool = True, **sizes) -> float:
    """One train step at `batch` records: the forward and every data and
    weight gradient (train_mfu's count). The classifier's stem is not
    grouped here: `lead_num` is 1 in its configuration and is not read."""
    return step_flops(layers(taps, **sizes), batch, 1, backward)
