"""Plain Nef-Net and Nef-Net2 in PyTorch, float32: the yardstick that decides
`correct`.

Nef-Net (IJCAI 2021, arXiv:2105.06293; the reference's
codes/network/model_nefnet.py) and Nef-Net2 (codes/network/model_nefnet2.py)
written from their layer equations with `torch.nn.functional` alone: no
kernel, no cache, no batching trick. It imports nothing of the program, of
JAX or of the JAX package. Where the published code does a thing by a library
call, so does this file: the ROI align is `F.grid_sample` on a [B, C, L, 1]
tensor, as the reference feeds it; the ROI reverse is `F.interpolate` of each
segment's grid back to its length; the x2 upsampling is `F.interpolate`; the
three grouped decodes of a train step are three sequential decoder calls in
train-mode `F.batch_norm`, which updates the running statistics in call
order; SGD with momentum is written out.

Weights are a flat {torch-style name: tensor} dict (`param_table` gives the
names and shapes); the benchmark makes them and hands the same dict to the
program and to this file.

Only theta_L = 1 (12 angular features) is written, the published setting.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

SEQ, FEAT, SEGS, ALIGN = 512, 128, 7, 16
SPATIAL_SCALE = 128 / 512
DROPOUT = 0.2
THETA_FEATURES = 12
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
DECODER_BN = ("decoder.1.double_conv.1", "decoder.1.double_conv.4",
              "decoder.3.double_conv.1", "decoder.3.double_conv.4")


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


# ------------------------------------------------------------------ parameters
def param_table(model: str, lead_num: int) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter: init 'normal' (std
    scale, the ResNet tower's sqrt(2 / (k*k*out))), 'uniform' (bound scale,
    torch's default 1/sqrt(fan_in)), 'bn_weight' or 'bn_bias'."""
    L = 1 if model == "model_nefnet2" else lead_num
    C, g7 = 128 * L, SEGS * L
    rows = []

    def conv(name, out, in_pg, k, bias=True, fan_in=None):
        fan_in = fan_in or in_pg * k
        rows.append((f"{name}.weight", (out, in_pg, k), "uniform", 1 / math.sqrt(fan_in)))
        if bias:
            rows.append((f"{name}.bias", (out,), "uniform", 1 / math.sqrt(fan_in)))

    def tower_conv(name, out, in_pg, k):
        rows.append((f"{name}.weight", (out, in_pg, k), "normal", math.sqrt(2.0 / (k * k * out))))

    def block(name, c_in, c_out, groups):
        conv(f"{name}.conv1", c_out, c_in // groups, 3, bias=False)
        conv(f"{name}.conv2", c_out, c_out // groups, 3, bias=False)
        conv(f"{name}.residual_conv", c_out, c_in // groups, 1)

    tower_conv("W_encoder.conv1", C, 1, 15)
    for i in range(3):
        tower_conv(f"W_encoder.layer1.{i}.conv1", C, 128, 7)
        tower_conv(f"W_encoder.layer1.{i}.conv2", C, 128, 7)
    conv("mlp1", 128, THETA_FEATURES, 1)
    rows[-2] = ("mlp1.weight", (128, THETA_FEATURES), "uniform", 1 / math.sqrt(THETA_FEATURES))
    conv("mlp2", 256, THETA_FEATURES, 1)
    rows[-2] = ("mlp2.weight", (256, THETA_FEATURES), "uniform", 1 / math.sqrt(THETA_FEATURES))
    conv("w_feature_extractor.0", 128, 128, 3)  # never applied (published key)
    block("w_conv.0", C, C, L)
    block("z1_conv.0", C // 2, C, L)
    block("z2_conv1.0", C // 2, C, L)
    block("z2_conv2.0", 128 * g7, 128 * g7, g7)
    # ConvTranspose1d [in, out/groups, k]; torch's fan_in is (out/groups)*k
    rows.append(("z2_conv2.1.weight", (128 * g7, 64, 2), "uniform", 1 / math.sqrt(128)))
    rows.append(("z2_conv2.1.bias", (64 * g7,), "uniform", 1 / math.sqrt(128)))
    block("z2_conv2.2", 64 * g7, 128 * g7, g7)
    if model == "model_nefnet2":
        conv("single_conv_z1.0", 128, 128, 3)
        conv("single_conv_z2.0", 128, 128, 3)
    for pre, c_in, c_out in (("decoder.1", 256, 128), ("decoder.3", 128, 64)):
        conv(f"{pre}.double_conv.0", c_out, c_in, 3)
        rows.append((f"{pre}.double_conv.1.weight", (c_out,), "bn_weight", 0.0))
        rows.append((f"{pre}.double_conv.1.bias", (c_out,), "bn_bias", 0.0))
        conv(f"{pre}.double_conv.3", c_out, c_out, 3)
        rows.append((f"{pre}.double_conv.4.weight", (c_out,), "bn_weight", 0.0))
        rows.append((f"{pre}.double_conv.4.bias", (c_out,), "bn_bias", 0.0))
    conv("decoder.4", 1, 64, 3)
    return rows


def bn_state_table() -> list[tuple[str, tuple]]:
    """(name, channels) of the decoder's four BatchNorm layers' running
    statistics."""
    return [(k, (128,) if k.startswith("decoder.1") else (64,)) for k in DECODER_BN]


# ------------------------------------------------------------------ layers
def angular(theta):
    """[..., 2] -> [..., 12]: (t, p, t+p, t-p), each with its sine and cosine,
    interleaved per feature."""
    t, p = theta[..., 0:1], theta[..., 1:2]
    f = torch.cat([t, p, t + p, t - p], dim=-1)
    return torch.stack([f, torch.sin(f), torch.cos(f)], dim=-1).reshape(*theta.shape[:-1], THETA_FEATURES)


def linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def drop(x, mask):
    return x if mask is None else x * mask


def resnet_block(p, name, x, groups, mask):
    out = drop(F.relu(F.conv1d(x, p[f"{name}.conv1.weight"], padding=3, groups=groups)), mask)
    out = F.conv1d(out, p[f"{name}.conv2.weight"], padding=3, groups=groups)
    return F.relu(out + x)


def model_block(p, name, x, groups, mask):
    out = drop(F.relu(F.conv1d(x, p[f"{name}.conv1.weight"], padding=1, groups=groups)), mask)
    out = F.conv1d(out, p[f"{name}.conv2.weight"], padding=1, groups=groups)
    res = x
    if out.shape[1] != x.shape[1]:
        res = F.conv1d(x, p[f"{name}.residual_conv.weight"], p[f"{name}.residual_conv.bias"], groups=groups)
    return F.relu(out + res)


def tower(p, x, groups, masks):
    """conv1 k15 s2 -> relu -> maxpool k3 s2 -> three k7 BasicBlocks."""
    h = F.relu(F.conv1d(x, p["W_encoder.conv1.weight"], stride=2, padding=7, groups=groups))
    h = F.max_pool1d(h, kernel_size=3, stride=2, padding=1)
    for i in range(3):
        h = resnet_block(p, f"W_encoder.layer1.{i}", h, groups, masks[i])
    return h


def roi_align(x, rois):
    """The published roi_align as executed: grid_sample of x as a [B, C, L, 1]
    image, the ROI's ramp on the width-1 axis and 0 on the time axis.
    x [B, C, L], rois [B, 7, 2] (512-sample scale) -> [B, C, 7, 16]."""
    B, C, L = x.shape
    c = rois.to(torch.float32) * (SPATIAL_SCALE * 2.0 / L) - 1.0  # [B, R, 2]
    frac = torch.linspace(0.0, 1.0, ALIGN, dtype=torch.float32, device=x.device)
    ramp = c[..., 0:1] + (c[..., 1:2] - c[..., 0:1]) * frac  # [B, R, S]
    grid = torch.stack([ramp, torch.zeros_like(ramp)], dim=-1)  # (x = width, y = time)
    return F.grid_sample(x[..., None], grid, mode="bilinear", padding_mode="zeros", align_corners=False)


def roi_reverse_matrices(rois, device) -> torch.Tensor:
    """[B, 7*32, 128]: each segment's 32-point grid resampled by
    F.interpolate(linear) to its length floor(e*s) - floor(s*s) at the
    feature scale, segments laid end to end."""
    r = np.floor(np.asarray(rois.detach().cpu(), np.float64) * SPATIAL_SCALE).astype(np.int64)
    eye = torch.eye(2 * ALIGN, dtype=torch.float32)[:, None, :]  # [S, 1, S]
    mats = torch.zeros(r.shape[0], SEGS * 2 * ALIGN, FEAT)
    for b in range(r.shape[0]):
        t = 0
        for s in range(SEGS):
            n = int(r[b, s, 1] - r[b, s, 0])
            if n <= 0:
                continue
            m = F.interpolate(eye, size=n, mode="linear", align_corners=False)[:, 0, :]  # [S, n]
            mats[b, s * 2 * ALIGN:(s + 1) * 2 * ALIGN, t:t + n] = m
            t += n
        if t != FEAT:
            raise ValueError(f"rois of beat {b} cover {t} feature steps, not {FEAT}")
    return mats.to(device)


def roi_reverse(grid, mats):
    """grid [B, C, 7, 32] -> [B, C, 128]."""
    B, C = grid.shape[:2]
    return torch.bmm(grid.reshape(B, C, SEGS * 2 * ALIGN), mats)


def z2_grid_blocks(p, a, groups, mc20, mc22):
    a = model_block(p, "z2_conv2.0", a, groups, mc20)
    a = F.conv_transpose1d(a, p["z2_conv2.1.weight"], p["z2_conv2.1.bias"], stride=2, groups=groups)
    return model_block(p, "z2_conv2.2", a, groups, mc22)


def encode_nefnet(p, x, input_theta, rois, mats, L, masks=None):
    """Nef-Net's few-view encode: per-lead z1, z2 [B, L, 128, 128]. Each lead
    owns a private tower through the conv groups."""
    B = x.shape[0]
    m6, mc20, mc22 = masks if masks is not None else ([None] * 6, None, None)
    w = tower(p, x, L, m6[:3])  # [B, 128L, 128]
    gate = linear(p, "mlp1", angular(input_theta))  # [B, L, 128]
    w = (w.reshape(B, L, 128, FEAT) * gate[..., None]).reshape(B, 128 * L, FEAT)
    w = model_block(p, "w_conv.0", w, L, m6[3]).reshape(B, L, 128, FEAT)
    z1 = model_block(p, "z1_conv.0", w[:, :, :64].reshape(B, 64 * L, FEAT), L, m6[4])
    z2 = model_block(p, "z2_conv1.0", w[:, :, 64:].reshape(B, 64 * L, FEAT), L, m6[5])
    a = roi_align(z2, rois).reshape(B, 128 * L * SEGS, ALIGN)
    a = z2_grid_blocks(p, a, SEGS * L, mc20, mc22)
    z2 = roi_reverse(a.reshape(B, 128 * L, SEGS, 2 * ALIGN), mats)
    return z1.reshape(B, L, 128, FEAT), z2.reshape(B, L, 128, FEAT)


def encode_nefnet2(p, x, input_theta, rois, mats, L, masks=None):
    """Nef-Net2's encode: every lead through one shared single-lead tower
    (the leads folded into the batch), the extra single_conv_z1/z2 convs.
    `mats` are the ROI reverse matrices of the folded rows."""
    B = x.shape[0]
    n = B * L
    m6, mc20, mc22 = masks if masks is not None else ([None] * 6, None, None)
    w = tower(p, x.reshape(n, 1, SEQ), 1, m6[:3])  # [B*L, 128, 128]
    gate = linear(p, "mlp1", angular(input_theta)).reshape(n, 128)
    w = model_block(p, "w_conv.0", w * gate[:, :, None], 1, m6[3])
    z1 = model_block(p, "z1_conv.0", w[:, :64], 1, m6[4])
    z1 = F.conv1d(z1, p["single_conv_z1.0.weight"], p["single_conv_z1.0.bias"], padding=1)
    z2 = model_block(p, "z2_conv1.0", w[:, 64:], 1, m6[5])
    rois_f = rois.repeat_interleave(L, dim=0)
    a = roi_align(z2, rois_f).reshape(n, 128 * SEGS, ALIGN)
    a = z2_grid_blocks(p, a, SEGS, mc20, mc22)
    z2 = roi_reverse(a.reshape(n, 128, SEGS, 2 * ALIGN), mats)
    z2 = F.conv1d(z2, p["single_conv_z2.0.weight"], p["single_conv_z2.0.bias"], padding=1)
    return z1.reshape(B, L, 128, FEAT), z2.reshape(B, L, 128, FEAT)


ENCODERS = {"model_nefnet": encode_nefnet, "model_nefnet2": encode_nefnet2}


def reverse_rows(model: str, rois, L: int):
    """The rois whose reverse matrices the encode needs: one row per beat,
    or per (beat, lead) for Nef-Net2's folded rows."""
    return rois.repeat_interleave(L, dim=0) if model == "model_nefnet2" else rois


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="linear", align_corners=False)


def decoder(p, s, x, train: bool):
    """up2 -> DoubleConv(256,128) -> up2 -> DoubleConv(128,64) -> conv(64,1),
    then sigmoid(out / 3). BatchNorm in train mode updates `s`'s running
    statistics in place (torch's F.batch_norm), and num_batches_tracked."""
    def bn(h, name):
        if train:
            s[f"{name}.num_batches_tracked"] += 1
        return F.batch_norm(h, s[f"{name}.running_mean"], s[f"{name}.running_var"], p[f"{name}.weight"],
                            p[f"{name}.bias"], training=train, momentum=BN_MOMENTUM, eps=BN_EPS)

    h = x
    for pre in ("decoder.1", "decoder.3"):
        h = up2(h)
        h = F.relu(bn(F.conv1d(h, p[f"{pre}.double_conv.0.weight"], p[f"{pre}.double_conv.0.bias"], padding=1),
                      f"{pre}.double_conv.1"))
        h = F.relu(bn(F.conv1d(h, p[f"{pre}.double_conv.3.weight"], p[f"{pre}.double_conv.3.bias"], padding=1),
                      f"{pre}.double_conv.4"))
    out = F.conv1d(h, p["decoder.4.weight"], p["decoder.4.bias"], padding=1)
    return torch.sigmoid(out / 3.0)


# ------------------------------------------------------------------ train step
def step_seed(seed: int, epoch: int, step: int) -> int:
    """The dropout generator's seed of a train step, a function of (seed,
    epoch, step) alone (the program's rule, frozen here)."""
    return int(np.random.SeedSequence([seed, epoch, step, 0xD809]).generate_state(1)[0])


def dropout_masks(model: str, seed: int, epoch: int, step: int, B: int, L: int, device):
    """The step's pre-scaled dropout masks (0 or 1/0.8) of the eight dropout
    sites, drawn in this order from a torch.Generator on `device` seeded by
    step_seed: m6 [6, rows, 128*c, 128] (layer1 blocks 0-2, w_conv, z1_conv,
    z2_conv1), mc20 [rows, 896*c, 16], mc22 [rows, 896*c, 32]; rows = B and
    c = L for Nef-Net, rows = B*L and c = 1 for Nef-Net2."""
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, epoch, step))
    rows, c = (B * L, 1) if model == "model_nefnet2" else (B, L)
    keep = 1.0 - DROPOUT

    def mask(shape):
        u = torch.rand(shape, generator=gen, device=device)
        return (u < keep).to(torch.float32) * torch.tensor(1.0 / keep, device=device)

    return (mask((6, rows, 128 * c, FEAT)), mask((rows, 896 * c, ALIGN)), mask((rows, 896 * c, 2 * ALIGN)))


def forward_train(model, p, s, batch, masks, i1, i2, L, mats, loss_factor=(0.5, 0.5, 1.0)):
    """Loss tuple (loss, f0*loss1, f1*loss2, f2*loss3) of one train forward;
    BN running statistics in `s` advance by the three decodes."""
    z1, z2 = ENCODERS[model](p, batch["data"], batch["input_theta"], batch["rois"], mats, L, masks)
    z1m, z2m = z1.mean(dim=1), z2.mean(dim=1)
    latents = (torch.cat([z1m, z2m], 1), torch.cat([z1[:, i1], z2m], 1), torch.cat([z1m, z2[:, i2]], 1))
    gate = linear(p, "mlp2", angular(batch["target_theta"]))[:, :, None]  # [B, 256, 1]
    out, sp, sl = (decoder(p, s, gate * lat, train=True)[:, 0] for lat in latents)
    target = batch["target_view"]
    loss1 = (out.detach() - sp).abs().mean()
    loss2 = (out.detach() - sl).abs().mean()
    loss3 = (out - target).abs().mean()
    f = loss_factor
    return loss1 * f[0] + loss2 * f[1] + loss3 * f[2], loss1 * f[0], loss2 * f[1], loss3 * f[2]


def train_steps(model, params, bn_state, batches, shuffles, seed, L, lr, *, tf32=False, epoch=0,
                momentum=0.9, rows=None):
    """Run len(batches) train steps from (params, bn_state), SGD with
    momentum. Returns {'losses': [steps, 4], 'grads': {name: first step's
    gradient}, 'params': the params after the steps, 'bn_state': the running
    statistics after them}. Tensors on the params' device; nothing of the
    inputs is modified. `rows` keeps only each batch's first rows (and their
    masks), a fault that the comparison has to catch."""
    dev = next(iter(params.values())).device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    s = {k: v.detach().clone() for k, v in bn_state.items()}
    buf, losses, first = {}, [], None
    with matmul_precision(tf32):
        for step, (batch, (i1, i2)) in enumerate(zip(batches, shuffles)):
            B = batch["data"].shape[0]
            masks = dropout_masks(model, seed, epoch, step, B, L, dev)
            if rows is not None:
                k = rows * L if model == "model_nefnet2" else rows
                batch = {n: t[:rows] for n, t in batch.items()}
                masks = (masks[0][:, :k], masks[1][:k], masks[2][:k])
            mats = roi_reverse_matrices(reverse_rows(model, batch["rois"], L), dev)
            loss = forward_train(model, p, s, batch, masks, i1, i2, L, mats)
            grads = torch.autograd.grad(loss[0], list(p.values()), allow_unused=True)
            losses.append(torch.stack([t.detach() for t in loss]))
            with torch.no_grad():
                for (k, v), g in zip(p.items(), grads):
                    if g is None:
                        continue
                    buf[k] = g.clone() if k not in buf else buf[k].mul_(momentum).add_(g)
                    v.sub_(lr * buf[k])
            if first is None:
                first = {k: g.detach() for k, g in zip(p, grads) if g is not None}
    return {"losses": torch.stack(losses), "grads": first,
            "params": {k: v.detach() for k, v in p.items()}, "bn_state": s}


# ------------------------------------------------------------------ render
def render(model, params, bn_state, batch, views, L, *, tf32=False, view_block=48):
    """Eval render: encode once, decode every view with BatchNorm on its
    running statistics. views [V, 2] -> [B, V, 512] float32, computed
    `view_block` views at a time so that it fits beside the program."""
    if model != "model_nefnet":
        raise ValueError("the render path is Nef-Net's")
    p, s = params, bn_state
    with torch.no_grad(), matmul_precision(tf32):
        mats = roi_reverse_matrices(batch["rois"], batch["data"].device)
        z1, z2 = encode_nefnet(p, batch["data"], batch["input_theta"], batch["rois"], mats, L)
        latent = torch.cat([z1.mean(dim=1), z2.mean(dim=1)], dim=1)  # [B, 256, 128]
        gates = linear(p, "mlp2", angular(views))  # [V, 256]
        B, V = latent.shape[0], views.shape[0]
        out = torch.empty(B, V, SEQ, device=latent.device)
        for v0 in range(0, V, view_block):
            g = gates[v0:v0 + view_block]
            x = (g[None, :, :, None] * latent[:, None]).reshape(-1, 256, FEAT)
            out[:, v0:v0 + g.shape[0]] = decoder(p, s, x, train=False).reshape(B, g.shape[0], SEQ)
    return out
