"""Nef-Net2: the per-lead shared-encoder variant (reference
codes/network/model_nefnet2.py:63-227; the JAX package's models/nefnet2.py).

Against Nef-Net: one single-lead encoder tower shared by every lead (Nef-Net
gives each lead its own tower through conv groups), the extra
`single_conv_z1` / `single_conv_z2` convs, ROI align and reverse per lead,
and phase='gen' returning the post-reverse lead means
(model_nefnet2.py:159-160).

The reference's per-lead Python loop (model_nefnet2.py:126-151) is a
lead-into-batch fold: [B, L, 512] -> [B*L, 1, 512] through the shared tower
in one pass. The decoder half is Nef-Net's (`nefnet.decode_heads`), so the
train step's fused decoder pair (A4f/A4b) and the eval rest-view kernel (A1)
serve both models unchanged.

The reference never registers this model, and its own gen_ecg expects
pre-reverse grids that its gen phase never returns; the JAX package
registers it as 'model_nefnet2' and so does the port, without gen_ecg.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from electrocardio_panorama_tpu_torch.models.blocks import (
    DROPOUT_RATE,
    Conv,
    conv,
    model_block,
    model_block_apply,
)
from electrocardio_panorama_tpu_torch.models.encoder import encoder, encoder_apply
from electrocardio_panorama_tpu_torch.models.nefnet import (
    ALIGN_SIZE,
    FEAT_LEN,
    ROI_SEGMENTS,
    SEQ_LEN,
    SPATIAL_SCALE,
    decode_heads,
    decoder,
    init_tree,
)
from electrocardio_panorama_tpu_torch.ops import (
    angular_encode,
    conv1d_measured,
    conv_transpose1d_k2s2,
    dropout_mask,
    linear,
    roi_align_1d,
    roi_reverse_1d,
    theta_feature_dim,
)


class NefNet2(nn.Module):
    """Parameter/buffer tree of Model_nefnet2 under the reference's names;
    no parameter depends on the lead count."""

    def __init__(self, theta_encoder_len: int = 1):
        super().__init__()
        tdim = theta_feature_dim(theta_encoder_len)
        g7 = ROI_SEGMENTS
        self.W_encoder = encoder(1, 128)
        self.mlp1 = Conv((128, tdim), 128, fan_in=tdim)
        self.mlp2 = Conv((256, tdim), 256, fan_in=tdim)
        self.w_feature_extractor = nn.ModuleDict({"0": conv(128, 128, 3, bias=True)})  # never applied
        self.w_conv = nn.ModuleDict({"0": model_block(128, 128, 1)})
        self.z1_conv = nn.ModuleDict({"0": model_block(64, 128, 1)})
        self.z2_conv1 = nn.ModuleDict({"0": model_block(64, 128, 1)})
        self.z2_conv2 = nn.ModuleDict({
            "0": model_block(128 * g7, 128 * g7, g7),
            "1": Conv((128 * g7, 64, 2), 64 * g7, fan_in=64 * 2),
            "2": model_block(64 * g7, 128 * g7, g7),
        })
        self.single_conv_z1 = nn.ModuleDict({"0": conv(128, 128, 3, bias=True)})
        self.single_conv_z2 = nn.ModuleDict({"0": conv(128, 128, 3, bias=True)})
        self.decoder = decoder()


def init_nefnet2(generator: torch.Generator, *, lead_num: int, theta_encoder_len: int = 1,
                 dtype=torch.float32, device="cpu") -> tuple[dict, dict]:
    """(params, state) flat dicts keyed by torch-style names, drawn from
    `generator` (a CPU generator), then moved to `device`. `lead_num` is
    accepted for the registry's signature; the shared tower does not use it."""
    return init_tree(NefNet2(theta_encoder_len), generator, dtype=dtype, device=device)


def draw_masks(generator: torch.Generator, B: int, *, lead_num: int, dtype=torch.float32):
    """Pre-scaled dropout masks of the eight dropout sites over the folded
    batch of B*L single-lead rows (row b*L + l is lead l of beat b), on the
    generator's device: (m6 [6, B*L, 128, 128] for the tower's layer1
    blocks 0-2, w_conv, z1_conv and z2_conv1; mc20 [B*L, 896, 16] for
    z2_conv2.0; mc22 [B*L, 896, 32] for z2_conv2.2)."""
    n, cz = B * lead_num, 128 * ROI_SEGMENTS
    return (dropout_mask((6, n, 128, FEAT_LEN), DROPOUT_RATE, generator, dtype=dtype),
            dropout_mask((n, cz, ALIGN_SIZE), DROPOUT_RATE, generator, dtype=dtype),
            dropout_mask((n, cz, 2 * ALIGN_SIZE), DROPOUT_RATE, generator, dtype=dtype))


def encode_latents2(p: dict, x, input_thetas, rois, *, lead_num: int, theta_encoder_len: int = 1,
                    masks=None, train: bool = False):
    """x [B, L, 512], input_thetas [B, L, 2], rois [B, 7, 2] -> per-lead z1,
    z2 [B, L, 128, 128] through the shared tower. In train mode `masks` are
    `draw_masks`'s; without them the dropout sites pass through.

    Every convolution of the chain but the ConvTranspose runs through
    `conv1d_measured`: over the folded rows (T = 128, 128 channels, f32
    with TF32 off) cuDNN's heuristic picks FFT convolutions, many times
    slower than the direct engines its measurement finds."""
    B, L = x.shape[0], lead_num
    m6, mc20, mc22 = masks if (train and masks is not None) else ([None] * 6, None, None)
    train = train and masks is not None

    w = encoder_apply(p, "W_encoder", x.reshape(B * L, 1, SEQ_LEN), lead_num=1, masks=m6[:3],
                      train=train, conv=conv1d_measured)  # [B*L, 128, 128]
    gate1 = linear(angular_encode(input_thetas, theta_encoder_len), p["mlp1.weight"], p["mlp1.bias"])
    w = w * gate1.reshape(B * L, 128)[:, :, None]
    w = model_block_apply(p, "w_conv.0", w, groups=1, mask=m6[3], train=train, conv=conv1d_measured)

    z1 = model_block_apply(p, "z1_conv.0", w[:, :64], groups=1, mask=m6[4], train=train,
                           conv=conv1d_measured)
    z1 = conv1d_measured(z1, p["single_conv_z1.0.weight"], p["single_conv_z1.0.bias"], padding=1)
    z2 = model_block_apply(p, "z2_conv1.0", w[:, 64:], groups=1, mask=m6[5], train=train,
                           conv=conv1d_measured)

    rois_f = rois.repeat_interleave(L, dim=0)  # every lead of a beat shares its rois
    a = roi_align_1d(z2, rois_f, size=ALIGN_SIZE, spatial_scale=SPATIAL_SCALE)
    a = a.reshape(B * L, 128 * ROI_SEGMENTS, ALIGN_SIZE)
    a = model_block_apply(p, "z2_conv2.0", a, groups=ROI_SEGMENTS, mask=mc20, train=train,
                          conv=conv1d_measured)
    a = conv_transpose1d_k2s2(a, p["z2_conv2.1.weight"], p["z2_conv2.1.bias"], groups=ROI_SEGMENTS)
    a = model_block_apply(p, "z2_conv2.2", a, groups=ROI_SEGMENTS, mask=mc22, train=train,
                          conv=conv1d_measured)
    z2_grid = a.reshape(B * L, 128, ROI_SEGMENTS, 2 * ALIGN_SIZE)

    z2 = roi_reverse_1d(z2_grid, rois_f, spatial_scale=SPATIAL_SCALE, out_len=FEAT_LEN)
    z2 = conv1d_measured(z2, p["single_conv_z2.0.weight"], p["single_conv_z2.0.bias"], padding=1)
    return z1.reshape(B, L, 128, FEAT_LEN), z2.reshape(B, L, 128, FEAT_LEN)


def nefnet2_apply(p: dict, s: dict, x, input_thetas, query_theta, rois, rest_theta=None, *,
                  lead_num: int, theta_encoder_len: int = 1, phase: str = "train", masks=None,
                  shuffle_idx=None, rest_decode_fn=None, train_decode_fn=None, encode_fn=None):
    """Full forward, the JAX package's nefnet2_apply.

    phase 'train': ((out, shuffle_p, shuffle_l), new_state); dropout from
                   `masks` (draw_masks), per-group BN batch statistics;
    phase 'val'/'test': ((out, shuffle_p, shuffle_l, rest_out), state);
    phase 'gen': ((z1_mean, z2_mean) [B, 128, 128] each, state).
    `shuffle_idx` = (z1 lead, z2 lead), default (0, 0); the `rest_decode_fn`
    and `train_decode_fn` hooks are nefnet_apply's; `encode_fn(p, x,
    input_thetas, rois, masks=, train=) -> (z1, z2)` replaces
    encode_latents2 (the Solver passes NefNet2Def.graphed_encode's).
    """
    if phase not in ("train", "val", "test", "gen"):
        raise KeyError("please type correct phase")
    train = phase == "train"
    encode = encode_fn or partial(encode_latents2, lead_num=lead_num, theta_encoder_len=theta_encoder_len)
    z1_leads, z2_leads = encode(p, x, input_thetas, rois, masks=masks, train=train)
    z1_mean, z2_mean = z1_leads.mean(dim=1), z2_leads.mean(dim=1)
    if phase == "gen":
        return (z1_mean, z2_mean), s
    i1, i2 = shuffle_idx if shuffle_idx is not None else (0, 0)
    return decode_heads(p, s, torch.cat([z1_mean, z2_mean], dim=1),
                        torch.cat([z1_leads[:, i1], z2_mean], dim=1),
                        torch.cat([z1_mean, z2_leads[:, i2]], dim=1), query_theta, rest_theta,
                        theta_encoder_len=theta_encoder_len, train=train, rest_decode_fn=rest_decode_fn,
                        train_decode_fn=train_decode_fn)
