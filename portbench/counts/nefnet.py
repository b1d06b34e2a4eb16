"""Nef-Net's operation counts, by hand from its shapes: a frozen copy of the
program's utils/flops.py (the train step, the per-beat encode and the
streamed-basis decode's executed count), rewritten over counts/convs.py's
layer list.

Nef-Net gives each of its L leads a private 128-channel tower through conv
groups, so every encode layer runs once per beat on L*128 channels.
"""

from __future__ import annotations

from portbench.counts.convs import Layer, block_layers, conv_macs, decoder_layers, forward_flops, step_flops

LEADS = 3


def encode_layers(lead_num: int = LEADS, taps: str = "inside") -> list[Layer]:
    """Every matmul of the encode, per beat."""
    c, cz, L = 128 * lead_num, 128 * 7 * lead_num, lead_num
    return ([Layer(conv_macs(c, 1, 15, 512, stride=2, padding=7, taps=taps), "beat", False, True)]
            + [Layer(conv_macs(c, 128, 7, 128, padding=3, taps=taps), "beat", True, True)] * 6
            + [Layer(L * 128 * 12, "beat", False, True)]  # mlp1 on the angular encodings
            + block_layers(c, c, L, 128, "beat", taps)
            + block_layers(c // 2, c, L, 128, "beat", taps)      # z1_conv
            + block_layers(c // 2, c, L, 128, "beat", taps)      # z2_conv1
            + block_layers(cz, cz, 7 * L, 16, "beat", taps)      # z2_conv2.0
            + [Layer(cz * 64 * 2 * 16, "beat", True, True)]      # ConvTranspose1d k2 s2
            + block_layers(cz // 2, cz, 7 * L, 32, "beat", taps)  # z2_conv2.2
            + [Layer(c * 7 * 32 * 128, "beat", True, False)])   # roi_reverse: [C, R*S] @ a constant [R*S, T]


def train_step_flops(batch: int, lead_num: int = LEADS, taps: str = "inside", backward: bool = True) -> float:
    """One train step at `batch` beats: 120.992 GFLOP at 32, 483.968 at 128."""
    return step_flops(encode_layers(lead_num, taps) + decoder_layers(taps), batch, lead_num, backward)


def encode_flops_per_beat(lead_num: int = LEADS, taps: str = "inside") -> float:
    return forward_flops(encode_layers(lead_num, taps), lead_num)


def render_flops_per_view(views_per_beat: int, lead_num: int = LEADS, v_tile: int = 16, j: int = 13) -> float:
    """Executed operations per view of the streamed-basis render (the
    program's utils/flops.py::basis_decode_executed_flops_per_view): the
    in-kernel view mix, conv2 N-fused, upconv3 M-stacked, conv4, the conv5
    selector dots, plus each beat's basis planes and encode spread over its
    views. 75.97 MFLOP a view at 336 views a beat."""
    mac = 128 * j * 256
    mac += 3 * 128 * 128 * 256
    mac += 6 * 128 * 128 * 128
    mac += 8 * 64 * 128 * 128
    mac += 3 * v_tile * 64 * 512
    beat_mac = 3 * 256 * 128 * 256 + 3 * j * 128 * 256 * 256
    return 2.0 * mac + (2.0 * beat_mac + encode_flops_per_beat(lead_num)) / views_per_beat
