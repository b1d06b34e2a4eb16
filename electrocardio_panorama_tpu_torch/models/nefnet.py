"""Nef-Net: the reference `Model_nefnet`
(codes/network/model_nefnet.py:63-218) as functions over flat
{torch-style name: tensor} dicts, split like the JAX package's
models/nefnet.py into the two halves the panorama path runs:

  encode_latents : few-view ECG -> (z1 per lead, z2 per lead, latent_all),
                   once per batch;
  decode_views   : latent x V query viewpoints -> V waveforms in one batched
                   decoder pass (the reference loops over views,
                   model_nefnet.py:185-190).

`NefNet` is the module tree that fixes the parameter and BN-buffer names:
its `state_dict()` keys are exactly the reference checkpoint's, so
`load_state_dict` is the weight transfer. The dead `w_feature_extractor`
exists for key compatibility (model_nefnet.py:79-83) and is never applied.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from electrocardio_panorama_tpu_torch.models.blocks import (
    BatchNorm,
    Conv,
    conv,
    double_conv,
    double_conv_apply,
    model_block,
    model_block_apply,
)
from electrocardio_panorama_tpu_torch.models.encoder import encoder, encoder_apply
from electrocardio_panorama_tpu_torch.ops import (
    angular_encode,
    conv1d,
    conv_transpose1d_k2s2,
    linear,
    roi_align_1d,
    roi_reverse_1d,
    theta_feature_dim,
    upsample_linear_x2,
)

ROI_SEGMENTS = 7
ALIGN_SIZE = 16
SPATIAL_SCALE = 128 / 512
SEQ_LEN = 512
FEAT_LEN = 128


class NefNetLatents(NamedTuple):
    z1: torch.Tensor          # [B, 128*L, 128]  electrocardio-field (patient) half
    z2: torch.Tensor          # [B, 128*L, 128]  morphology half (post roi-reverse)
    z1_mean: torch.Tensor     # [B, 128, 128]
    z2_mean: torch.Tensor     # [B, 128, 128]
    latent_all: torch.Tensor  # [B, 256, 128]


class NefNet(nn.Module):
    """Parameter/buffer tree of Model_nefnet under the reference's names."""

    def __init__(self, lead_num: int, theta_encoder_len: int = 1):
        super().__init__()
        L = lead_num
        tdim = theta_feature_dim(theta_encoder_len)
        g7 = ROI_SEGMENTS * L
        self.W_encoder = encoder(L, 128)
        self.mlp1 = Conv((128, tdim), 128, fan_in=tdim)
        self.mlp2 = Conv((256, tdim), 256, fan_in=tdim)
        self.w_feature_extractor = nn.ModuleDict({"0": conv(128, 128, 3, bias=True)})
        self.w_conv = nn.ModuleDict({"0": model_block(128 * L, 128 * L, L)})
        self.z1_conv = nn.ModuleDict({"0": model_block(64 * L, 128 * L, L)})
        self.z2_conv1 = nn.ModuleDict({"0": model_block(64 * L, 128 * L, L)})
        self.z2_conv2 = nn.ModuleDict({
            "0": model_block(128 * g7, 128 * g7, g7),
            # ConvTranspose1d [in, out/groups, k]; torch's fan_in is (out/groups)*k
            "1": Conv((128 * g7, 64, 2), 64 * g7, fan_in=64 * 2),
            "2": model_block(64 * g7, 128 * g7, g7),
        })
        self.decoder = decoder()


def decoder() -> nn.ModuleDict:
    # keys follow the reference nn.Sequential: 0 and 2 are Upsample
    return nn.ModuleDict({"1": double_conv(256, 128), "3": double_conv(128, 64), "4": conv(1, 64, 3, bias=True)})


def init_nefnet(generator: torch.Generator, *, lead_num: int, theta_encoder_len: int = 1,
                dtype=torch.float32, device="cpu") -> tuple[dict, dict]:
    """Returns (params, state): flat dicts keyed by torch-style names. The
    draws come from `generator` (a CPU generator) and then move to `device`."""
    return init_tree(NefNet(lead_num, theta_encoder_len), generator, dtype=dtype, device=device)


def init_tree(net: nn.Module, generator: torch.Generator, *, dtype=torch.float32, device="cpu"):
    """(params, state) of a module tree of `Conv` / `BatchNorm` holders, each
    reset from `generator` in registration order, cast and moved."""
    for m in net.modules():
        if isinstance(m, (Conv, BatchNorm)):
            m.reset(generator)
    params = {k: v.detach().to(device=device, dtype=dtype) for k, v in net.named_parameters()}
    state = {k: v.detach().to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
             for k, v in net.named_buffers()}
    return params, state


# -------------------------------------------------------------------- decoder
def decoder_apply(p: dict, s: dict, x, *, train: bool = False, bn_groups: int = 1, bn_sync=None):
    """Upsample -> DoubleConv(256,128) -> Upsample -> DoubleConv(128,64) ->
    Conv(64,1): x [N, 256, 128] -> [N, 1, 512] logits. Eval returns the
    logits; train returns (logits, BN state updates), with per-group batch
    statistics when `bn_groups` > 1 (x group-major [G*B, ...]: G sequential
    decoder calls in one batched pass, blocks.double_conv_apply), summed over
    the ranks under `bn_sync` (parallel.sharding.BatchStatSync)."""
    if not train:
        h = double_conv_apply(p, s, "decoder.1.double_conv", upsample_linear_x2(x))
        h = double_conv_apply(p, s, "decoder.3.double_conv", upsample_linear_x2(h))
        return conv1d(h, p["decoder.4.weight"], p["decoder.4.bias"], padding=1)
    updates = {}
    h, u = double_conv_apply(p, s, "decoder.1.double_conv", upsample_linear_x2(x), train=True,
                             bn_groups=bn_groups, bn_sync=bn_sync)
    updates.update(u)
    h, u = double_conv_apply(p, s, "decoder.3.double_conv", upsample_linear_x2(h), train=True,
                             bn_groups=bn_groups, bn_sync=bn_sync)
    updates.update(u)
    return conv1d(h, p["decoder.4.weight"], p["decoder.4.bias"], padding=1), updates


def query_gates(p: dict, thetas, *, theta_encoder_len: int = 1):
    """Angular encoding + mlp2 gate of query viewpoints: [..., 2] -> [..., 256]."""
    return linear(angular_encode(thetas, theta_encoder_len), p["mlp2.weight"], p["mlp2.bias"])


def decode_views(p: dict, s: dict, latent_all, view_thetas, *, theta_encoder_len: int = 1):
    """latent_all [B, 256, 128], view_thetas [B, V, 2] -> [B, V, 512]: all V
    views decode as one [B*V, 256, 128] decoder batch."""
    B, V = view_thetas.shape[0], view_thetas.shape[1]
    gates = query_gates(p, view_thetas, theta_encoder_len=theta_encoder_len)  # [B, V, 256]
    x = gates[..., None] * latent_all[:, None]  # [B, V, 256, 128]
    out = decoder_apply(p, s, x.reshape(B * V, 256, FEAT_LEN))
    return torch.sigmoid(out / 3.0).reshape(B, V, SEQ_LEN)


# -------------------------------------------------------------------- encoder
def encode_latents(p: dict, x, input_thetas, rois, *, lead_num: int, theta_encoder_len: int = 1,
                   masks=None, train: bool = False, stop_before_reverse: bool = False):
    """Few-view encode: x [B, L, 512], input_thetas [B, L, 2], rois [B, 7, 2]
    -> NefNetLatents, or (z1, z2_pre_reverse [B, 128L, 7, 32]) when
    `stop_before_reverse` (the reference's phase='gen' early return,
    model_nefnet.py:140-141).

    In train mode `masks` = (m6 [6, B, 128L, 128], mc20 [B, 896L, 16],
    mc22 [B, 896L, 32]) are the pre-scaled dropout masks of the eight
    dropout sites (layer1 blocks 0-2, w_conv, z1_conv, z2_conv1; z2_conv2.0;
    z2_conv2.2), drawn by ops.kernels.encoder_fused.draw_masks; the fused
    encoder takes the same tuple, so both paths can run on identical masks.
    """
    L = lead_num
    B = x.shape[0]
    m6, mc20, mc22 = masks if (train and masks is not None) else ([None] * 6, None, None)
    train = train and masks is not None
    w = encoder_apply(p, "W_encoder", x, lead_num=L, masks=m6[:3], train=train)  # [B, 128L, 128]

    gate1 = linear(angular_encode(input_thetas, theta_encoder_len),
                   p["mlp1.weight"], p["mlp1.bias"])  # [B, L, 128]
    w = (w.reshape(B, L, 128, FEAT_LEN) * gate1[..., None]).reshape(B, 128 * L, FEAT_LEN)
    w = model_block_apply(p, "w_conv.0", w, groups=L, mask=m6[3], train=train)

    # per-lead split into z1 (first 64 ch) / z2 (last 64 ch) (model_nefnet.py:127-131)
    w4 = w.reshape(B, L, 128, FEAT_LEN)
    z1 = w4[:, :, :64].reshape(B, 64 * L, FEAT_LEN)
    z2 = w4[:, :, 64:].reshape(B, 64 * L, FEAT_LEN)
    z1 = model_block_apply(p, "z1_conv.0", z1, groups=L, mask=m6[4], train=train)   # [B, 128L, 128]
    z2 = model_block_apply(p, "z2_conv1.0", z2, groups=L, mask=m6[5], train=train)  # [B, 128L, 128]

    a = roi_align_1d(z2, rois, size=ALIGN_SIZE, spatial_scale=SPATIAL_SCALE)  # [B, 128L, 7, 16]
    # torch .view row-major: channels and segments interleave across the
    # group boundaries because 7 does not divide 128 (model_nefnet.py:137)
    a = a.reshape(B, 128 * L * ROI_SEGMENTS, ALIGN_SIZE)
    g7 = ROI_SEGMENTS * L
    a = model_block_apply(p, "z2_conv2.0", a, groups=g7, mask=mc20, train=train)
    a = conv_transpose1d_k2s2(a, p["z2_conv2.1.weight"], p["z2_conv2.1.bias"], groups=g7)
    a = model_block_apply(p, "z2_conv2.2", a, groups=g7, mask=mc22, train=train)  # [B, 128L*7, 32]
    z2_grid = a.reshape(B, 128 * L, ROI_SEGMENTS, 2 * ALIGN_SIZE)
    if stop_before_reverse:
        return z1, z2_grid
    return latents_from_grid(z1, z2_grid, rois, lead_num=L)


def latents_from_grid(z1, z2_grid, rois, *, lead_num: int) -> NefNetLatents:
    """roi_reverse of the z2 grid, then the lead means and latent_all."""
    B = z1.shape[0]
    z2 = roi_reverse_1d(z2_grid, rois, spatial_scale=SPATIAL_SCALE, out_len=FEAT_LEN)
    z1_mean = z1.reshape(B, lead_num, 128, FEAT_LEN).mean(dim=1)
    z2_mean = z2.reshape(B, lead_num, 128, FEAT_LEN).mean(dim=1)
    latent_all = torch.cat([z1_mean, z2_mean], dim=1)  # [B, 256, 128]
    return NefNetLatents(z1, z2, z1_mean, z2_mean, latent_all)


# -------------------------------------------------------------------- forward
def nefnet_apply(p: dict, s: dict, x, input_thetas, query_theta, rois, rest_theta=None, *,
                 lead_num: int, theta_encoder_len: int = 1, phase: str = "train", masks=None,
                 shuffle_idx=None, rest_decode_fn=None, train_decode_fn=None, encode_fn=None):
    """Full forward (model_nefnet.py:109-194), the JAX package's nefnet_apply.

    phase 'train': ((out, shuffle_p, shuffle_l), new_state); dropout from
                   `masks` (encode_latents), BN batch statistics;
                   `shuffle_idx` = (z1_lead, z2_lead), default (0, 0).
    phase 'val'/'test': ((out, shuffle_p, shuffle_l, rest_out), state).
    phase 'gen': ((z1, z2_pre_reverse), state).

    Hooks, as in the JAX package: `encode_fn(p, x, input_thetas, rois,
    masks=, train=) -> NefNetLatents` replaces encode_latents (the Solver
    passes the fused encoder, kernels A2/A3); `rest_decode_fn(latent_all,
    rest_theta) -> [B, R, 512]` replaces decode_views for the rest views
    (kernel A1); `train_decode_fn(p, s, stacked [3B, 256, 128]) ->
    (outs [3, B, 1, 512], state updates)` replaces the grouped train decode.
    """
    if phase == "gen":
        z1, z2_grid = encode_latents(p, x, input_thetas, rois, lead_num=lead_num,
                                     theta_encoder_len=theta_encoder_len, stop_before_reverse=True)
        return (z1, z2_grid), s
    if phase not in ("train", "val", "test"):
        raise KeyError("please type correct phase")
    train = phase == "train"
    if encode_fn is not None:
        lat = encode_fn(p, x, input_thetas, rois, masks=masks, train=train)
    else:
        lat = encode_latents(p, x, input_thetas, rois, lead_num=lead_num,
                             theta_encoder_len=theta_encoder_len, masks=masks, train=train)
    B = x.shape[0]
    L = lead_num
    i1, i2 = shuffle_idx if shuffle_idx is not None else (0, 0)

    # Standin-Learning: one lead index per forward, shared across the batch
    # (model_nefnet.py:154-157)
    shuffle_z1 = lat.z1.reshape(B, L, 128, FEAT_LEN)[:, i1]
    shuffle_z2 = lat.z2.reshape(B, L, 128, FEAT_LEN)[:, i2]
    return decode_heads(p, s, lat.latent_all, torch.cat([shuffle_z1, lat.z2_mean], dim=1),
                        torch.cat([lat.z1_mean, shuffle_z2], dim=1), query_theta, rest_theta,
                        theta_encoder_len=theta_encoder_len, train=train, rest_decode_fn=rest_decode_fn,
                        train_decode_fn=train_decode_fn)


def decode_heads(p: dict, s: dict, latent_all, shuffle_patient_all, shuffle_lead_all, query_theta,
                 rest_theta=None, *, theta_encoder_len: int = 1, train: bool = False, rest_decode_fn=None,
                 train_decode_fn=None):
    """The decoder half of the forward, shared by Nef-Net and Nef-Net2: the
    three latents [B, 256, 128] gated by the query view, decoded.

    train: ((out, shuffle_p, shuffle_l), new_state), one group-major batch
           with per-group BN statistics and the running stats chained in the
           reference's call order (model_nefnet.py:167-176), or through
           `train_decode_fn`;
    eval:  ((out, shuffle_p, shuffle_l, rest_out), state), BN on running
           statistics, so the three decodes batch into one pass; the rest
           views through `rest_decode_fn` or decode_views.
    """
    B = latent_all.shape[0]
    gate_q = query_gates(p, query_theta, theta_encoder_len=theta_encoder_len)  # [B, 256]
    if train:
        gx = gate_q[:, :, None]
        stacked = torch.cat([gx * latent_all, gx * shuffle_patient_all, gx * shuffle_lead_all], dim=0)
        if train_decode_fn is not None:
            outs, u = train_decode_fn(p, s, stacked)
        else:
            o, u = decoder_apply(p, s, stacked, train=True, bn_groups=3)
            outs = torch.sigmoid(o / 3.0).reshape(3, B, 1, SEQ_LEN)
        new_s = dict(s)
        new_s.update(u)
        return (outs[0], outs[1], outs[2]), new_s

    stacked = torch.stack([latent_all, shuffle_patient_all, shuffle_lead_all], dim=1)
    outs3 = decoder_apply(p, s, (gate_q[:, None, :, None] * stacked).reshape(B * 3, 256, FEAT_LEN))
    outs3 = torch.sigmoid(outs3 / 3.0).reshape(B, 3, 1, SEQ_LEN)
    out, shuffle_p, shuffle_l = outs3[:, 0], outs3[:, 1], outs3[:, 2]
    if rest_decode_fn is not None:
        rest_out = rest_decode_fn(latent_all, rest_theta)
    else:
        rest_out = decode_views(p, s, latent_all, rest_theta, theta_encoder_len=theta_encoder_len)
    return (out, shuffle_p, shuffle_l, rest_out), s


def gen_ecg(p: dict, s: dict, z1, z2_grid, query_thetas, rois, *, lead_num: int,
            theta_encoder_len: int = 1):
    """Synthesis-from-scratch decode (reference gen_ecg, model_nefnet.py:196-218):
    pre-reverse latents from phase='gen' and query views [B, V, 2] ->
    [B, V, 512], eval mode."""
    lat = latents_from_grid(z1, z2_grid, rois, lead_num=lead_num)
    return decode_views(p, s, lat.latent_all, query_thetas, theta_encoder_len=theta_encoder_len)
