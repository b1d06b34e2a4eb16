"""Model-FLOP accounting for MFU on the H100 (the JAX package's utils/flops.py).

The JAX package takes its four workload counts from XLA's cost analysis on
the CPU. Here they are counted by hand from Nef-Net's shapes: 2 FLOPs per
multiply-add of every conv, transposed conv, linear layer and matmul, over
the taps that land inside the input (zero-padding taps are not work; XLA
counts the same way). Elementwise work (biases, relu, BatchNorm, dropout,
upsampling, the view gates, the loss, the optimizer) is left out: it is
0.4-2.2% of XLA's counts. MFU is then

    mfu = model_flops / wall_time / peak_flops

which counts the algorithm, not any kernel's instructions: a kernel that
skips work (the streamed-basis decode A1) can read above its executed rate.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at the 700 W power
limit: 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s of HBM3. A card set below 700 W runs slower.
"""

from __future__ import annotations

H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12

LEADS, THETA_FEATURES, VIEWS_PER_BEAT, TRAIN_BATCH = 3, 12, 336, 32


def conv_macs(c_out: int, c_in_per_group: int, k: int, l_in: int, *, stride: int = 1,
              padding: int = 0) -> int:
    """Multiply-adds of one conv1d over the taps inside the input."""
    l_out = (l_in + 2 * padding - k) // stride + 1
    taps = sum(1 for o in range(l_out) for j in range(k) if 0 <= o * stride - padding + j < l_in)
    return c_out * c_in_per_group * taps


def encode_macs_per_beat(lead_num: int = LEADS, theta_features: int = THETA_FEATURES) -> dict:
    """Multiply-adds of one beat's encode (models/nefnet.py::encode_latents),
    by layer."""
    c, cz = 128 * lead_num, 128 * 7 * lead_num

    def block(c_in, c_out, length):  # model_block: conv1, conv2, the 1x1 residual if shapes differ
        g = lead_num if length == 128 else 7 * lead_num  # lead groups; the z2 grid's segment groups
        macs =conv_macs(c_out, c_in // g, 3, length, padding=1) + conv_macs(c_out, c_out // g, 3, length, padding=1)
        return macs + (conv_macs(c_out, c_in // g, 1, length) if c_in != c_out else 0)

    return {
        "conv1": conv_macs(c, 1, 15, 512, stride=2, padding=7),
        "layer1": 6 * conv_macs(c, 128, 7, 128, padding=3),
        "mlp1": lead_num * 128 * theta_features,
        "w_conv": block(c, c, 128),
        "z1_conv": block(c // 2, c, 128),
        "z2_conv1": block(c // 2, c, 128),
        "z2_conv2.0": block(cz, cz, 16),
        "z2_conv2.1": cz * 64 * 2 * 16,  # ConvTranspose1d k2 s2: every input into two taps
        "z2_conv2.2": block(cz // 2, cz, 32),
        "roi_reverse": c * 7 * 32 * 128,  # [C, R*S] @ [R*S, T]
    }


def decoder_macs_per_sample() -> int:
    """Multiply-adds of one decoder pass [256, 128] -> [1, 512]."""
    return (conv_macs(128, 256, 3, 256, padding=1) + conv_macs(128, 128, 3, 256, padding=1)
            + conv_macs(64, 128, 3, 512, padding=1) + conv_macs(64, 64, 3, 512, padding=1)
            + conv_macs(1, 64, 3, 512, padding=1))


def train_step_macs(batch: int = TRAIN_BATCH, lead_num: int = LEADS,
                    theta_features: int = THETA_FEATURES) -> int:
    """One train step: the encode, the mlp2 gate and three decodes per beat
    forward; backward a data and a weight gradient of every layer, except
    that no gradient flows into the inputs of conv1 and the two gate layers
    (the data and the angular encodings) and roi_reverse's matrix is a
    constant."""
    enc = encode_macs_per_beat(lead_num, theta_features)
    gate = 256 * theta_features
    fwd = batch * (sum(enc.values()) + gate + 3 * decoder_macs_per_sample())
    no_dgrad = batch * (enc["conv1"] + enc["mlp1"] + gate + enc["roi_reverse"])
    return fwd + 2 * fwd - no_dgrad


ENCODE_FLOPS_PER_BEAT = 2.0 * sum(encode_macs_per_beat().values())
# decode per view: the mlp2 gate and the decoder
DECODE_FLOPS_PER_VIEW = 2.0 * (256 * THETA_FEATURES + decoder_macs_per_sample())
# encode once per beat, then VIEWS_PER_BEAT views
FULL_WORKLOAD_FLOPS_PER_VIEW = DECODE_FLOPS_PER_VIEW + ENCODE_FLOPS_PER_BEAT / VIEWS_PER_BEAT
TRAIN_STEP_FLOPS_B32 = 2.0 * train_step_macs()


def mfu_pct(flops: float, seconds: float, peak: float = H100_BF16_FLOPS) -> float:
    """Achieved fraction of the card's peak, in percent."""
    return 100.0 * flops / seconds / peak


def basis_decode_executed_flops_per_view(v_tile: int = 16, j: int = 13, views_per_beat: int = VIEWS_PER_BEAT,
                                         encode_flops_per_beat: float = ENCODE_FLOPS_PER_BEAT) -> float:
    """Executed FLOPs per view of the streamed-U basis decode: the in-kernel
    multiply-adds of the TPU kernel's dot shapes (the f-batched [vt, J] mix,
    conv2 N-fused, upconv2 M-stacked, conv4 at K=128, conv5 selector dots,
    vt-times redundant by structure), plus the per-beat basis-plane build and
    encode amortized over the sweep's views. The JAX package's formula, with
    the encode count as a parameter."""
    mac = 128 * j * 256                   # in-kernel view mix
    mac += 3 * 128 * 128 * 256            # conv2 N-fused (3 dots, N=256)
    mac += 6 * 128 * 128 * 128            # upconv2 M-stacked (2 planes x 3)
    mac += 8 * 64 * 128 * 128             # conv4, 2 dots x 4 phases, K=128
    mac += 3 * v_tile * 64 * 512          # conv5 selector dots
    beat_mac = 3 * 256 * 128 * 256        # T[b,k] = lat @ u1eo[k]
    beat_mac += 3 * j * 128 * 256 * 256   # U[b,j] = sum_k w1a[k,j] @ T[b,k]
    return 2.0 * mac + (2.0 * beat_mac + encode_flops_per_beat) / views_per_beat
