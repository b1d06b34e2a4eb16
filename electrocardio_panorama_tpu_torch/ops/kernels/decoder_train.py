"""Fused train-mode decoder: forward (kernel A4f) and backward (kernel A4b).

Port of electrocardio_panorama_tpu/ops/pallas/decoder_train.py:
`_train_fwd_kernel` (via `_fwd_call`) and `_train_bwd_kernel` (via
`_bwd_call`) under the custom VJP `train_decode_groups`, and the
`make_train_decode_fn` hook of `models.nefnet.nefnet_apply`.

The three decodes of a train step (pred, shuffle_patient, shuffle_lead) are
G=3 groups of nb samples; BatchNorm uses each group's own batch statistics:

    x_g [256, nb*128] -> up x2 -> conv1 -> BN1 -> relu -> conv2 -> BN2 -> relu
        -> up x2 -> conv3 -> BN3 -> relu -> conv4 -> BN4 -> relu -> conv5
        -> sigmoid(./3)

The kernels return the per-group biased batch moments of every BN layer; the
running-stat EMA chain (the group order is part of the reference semantics)
applies outside them in `chain_running_stats`, the closed form of
`ops.convs.group_batch_norm1d`. The moments carry no gradient: running
statistics are auxiliary state, not a loss path.

`train_decode_groups` runs the CUDA kernels (`csrc/decoder_train_fwd.cu`,
`csrc/decoder_train_bwd.cu`, shared stages in `csrc/decoder_train_common.cuh`)
for CUDA tensors, inside one torch.autograd.Function whose forward launches
A4f and whose backward launches A4b; for CPU tensors it runs
`train_decode_groups_plain`, the same function as eager ops through autograd.
A failed build or launch raises; nothing falls back. The kernels hold their
planes in device memory and take any per-group batch, so the TPU kernel's
VMEM rule (`_validate_train_nb`) has no counterpart here.

Residual: the TPU kernel's custom VJP keeps only (weights, x) and its
backward recomputes the forward. Here the autograd Function keeps the planes
that A4f fills (a1..a4, h1..h4, out and the moments; about 82 MB in bfloat16
and 100 MB in float32 at 3 groups of 32) and A4b reads them instead of
recomputing them. The function of (weights, x, dout) is the same; only the
residual differs, as the fused encoder's `encoder_ckpt` modes do.
`backward_cuda(w, x, dout)` without planes launches A4f first.

Storage dtype: that of x and the conv weights (float32, or bfloat16 under the
mixed-precision step). Values round to it where the TPU kernel rounds them
(h1, h2, h3 after their relu; h4 only as conv5's operand), BatchNorm and every
product and sum are float32, and in the backward a gradient rounds to it only
as a conv product's operand (`GradRound`). The TPU kernel's upsample matmuls
round one more intermediate that the time-order form does not have, so
bfloat16 agrees with the JAX package within a tolerance, not bitwise.
A4f runs its four conv stages, and A4b its conv data and weight gradients,
on the engine of the storage type: in float32 a register-tiled FMA engine at
full float32 (`csrc/decoder_train_fma.cuh`; A4f's upsampled convs read up2
planes it materializes in a workspace, with this module's upsample values),
in bfloat16 `mma.sync` tensor cores (`csrc/decoder_train_tc.cuh`; every
product is of two bfloat16 values, as here; A4f's upsampled convs run at
input resolution, the identity of `upconv_taps_plain`, with no extra
rounding). Only the order of the float32 sums differs from this module's
plain version. BatchNorm's moments come from a two-pass reduction kernel in
both.

`train_decode_groups_plain(..., float64=True)` runs the function in float64
with no rounding, from float32 or bfloat16 storage: a third point that both
the kernels and the plain version are measured against (`chip_smoke.py`);
bfloat16's moments are held to it by `BF16_MOMENTS_BAR`.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from electrocardio_panorama_tpu_torch.ops.convs import conv1d, full_f32
from electrocardio_panorama_tpu_torch.ops.kernels import build
from electrocardio_panorama_tpu_torch.ops.kernels.rounding import GradRound, Round
from electrocardio_panorama_tpu_torch.ops.resample import upsample_linear_x2

FEAT = 128
SEQ = 512
EPS = 1e-5
# (channels, time per sample) after each BN layer
BN_SHAPES = ((128, 2 * FEAT), (128, 2 * FEAT), (64, SEQ), (64, SEQ))
BN_KEYS = (
    "decoder.1.double_conv.1",
    "decoder.1.double_conv.4",
    "decoder.3.double_conv.1",
    "decoder.3.double_conv.4",
)
_CONV_KEYS = (
    "decoder.1.double_conv.0",
    "decoder.1.double_conv.3",
    "decoder.3.double_conv.0",
    "decoder.3.double_conv.3",
    "decoder.4",
)
WNAMES = ["w1", "b1", "g1", "o1", "w2", "b2", "g2", "o2",
          "w3", "b3", "g3", "o3", "w4", "b4", "g4", "o4", "w5", "b5"]
_WSHAPES = {"w1": (3, 128, 256), "w2": (3, 128, 128), "w3": (3, 64, 128), "w4": (3, 64, 64), "w5": (3, 1, 64)}

# launches of the CUDA kernels, keyed "fwd_<dtype>" / "bwd_<dtype>"; counted
# where they are launched
LAUNCHES: collections.Counter = collections.Counter()

# csrc/decoder_train_common.cuh `enum Ptr`, in order: the planes A4f fills and
# A4b reads
PLANES = ["P_A1", "P_H1", "P_A2", "P_H2", "P_A3", "P_H3", "P_A4", "P_H4", "OUT", "MEAN", "VAR"]
PTR_NAMES = ["X", *(n.upper() for n in WNAMES), *PLANES, "DOUT", "DX", *("G" + n.upper() for n in WNAMES)]

# The bfloat16 moments bar. Over 16 input sets (tests/test_torch_decoder_train.py:
# the test's own set at 3 groups of 2, and x ~ N(0, 0.5) from numpy seeds
# BF16_BAR_SEEDS at 3 groups of 32, the trainer's shape) the plain version's
# bfloat16 moments lie at most c = 1.0209e-4 from the float64 pass
# (`moments_distance`; the nb-2 set, the seeded sets 2.30e-5 to 3.76e-5). B is
# 2c rounded up to two significant digits: one digit (3e-4) would leave B at
# 2.9c, past the 2.5c at which the test calls the bar loose. The kernel and
# the plain version are each held within B of the float64 pass.
BF16_MOMENTS_BAR = 2.1e-4
BF16_BAR_SEEDS = tuple(range(1, 16))


# --------------------------------------------------------------- weight packing
def pack_train_weights(params: dict, dtype=torch.float32) -> dict:
    """Tap-major conv weights [3, Cout, Cin] in `dtype`, and float32 biases
    and BN affines, from the flat torch-keyed params (decoder.* keys)."""
    out = {}
    for i, key in enumerate(_CONV_KEYS, start=1):
        out[f"w{i}"] = params[f"{key}.weight"].float().permute(2, 0, 1).to(dtype)
        out[f"b{i}"] = params[f"{key}.bias"].float()
    for i, key in enumerate(BN_KEYS, start=1):
        out[f"g{i}"] = params[f"{key}.weight"].float()
        out[f"o{i}"] = params[f"{key}.bias"].float()
    return out


def chain_running_stats(state: dict, mean, var, nb: int, momentum: float = 0.1) -> dict:
    """EMA-chain the per-group batch moments into the running statistics in
    group order (closed form; equal to ops.convs.group_batch_norm1d).

    mean / var: [G, 4, 128] float32 (channel-padded) from train_decode_groups;
    nb the per-group batch (the unbiased variance's n is nb * time per layer).
    Returns the torch-keyed running_mean / running_var / num_batches_tracked
    updates."""
    G = mean.shape[0]
    keep = (1 - momentum) ** G
    w = momentum * (1 - momentum) ** torch.arange(G - 1, -1, -1, dtype=torch.float32, device=mean.device)
    updates = {}
    for i, (key, (c, t)) in enumerate(zip(BN_KEYS, BN_SHAPES)):
        n = nb * t
        unbiased = var[:, i, :c] * n / max(n - 1, 1)
        updates[f"{key}.running_mean"] = keep * state[f"{key}.running_mean"] + torch.tensordot(w, mean[:, i, :c], dims=1)
        updates[f"{key}.running_var"] = keep * state[f"{key}.running_var"] + torch.tensordot(w, unbiased, dims=1)
        updates[f"{key}.num_batches_tracked"] = state[f"{key}.num_batches_tracked"] + G
    return updates


def moments_distance(a, t) -> float:
    """c(a, t) = max |a - t| / (1 + |t|) over every entry of the moments
    a = (mean, var) against t = (mean, var): allclose with rtol = atol = c."""
    return max(float(((u.double() - v.double()).abs() / (1 + v.double().abs())).max()) for u, v in zip(a, t))


# ------------------------------------------------------------- plain version
def train_decode_groups_plain(w: dict, x, *, float64: bool = False):
    """The kernel pair's function in eager PyTorch, differentiable by
    autograd. w = pack_train_weights(params, dtype); x [G, 256, nb*128] in
    the same dtype. Returns (out [G, nb, 512] float32, mean [G, 4, 128], var
    [G, 4, 128]): the moments are biased batch moments, channel-padded,
    detached. `float64=True` (float32 or bfloat16 storage) upcasts w and x
    exactly, runs every op in float64 with no intermediate rounding and
    returns float64: a reference that the kernels and this function's pass
    in the storage type are both held against."""
    sd = w["w1"].dtype
    if float64 and (sd not in (torch.float32, torch.bfloat16) or x.dtype != sd):
        raise ValueError(f"train_decode_groups_plain: float64=True takes float32 or bfloat16 storage, "
                         f"got {sd} / {x.dtype}")
    mixed = sd != torch.float32 and not float64
    cd = torch.float64 if float64 else torch.float32
    G, C, n = x.shape
    nb = n // FEAT

    def R(t):
        return Round.apply(t, sd) if mixed else t

    def conv(h, i):
        # the output's gradient rounds as the operand of the conv's data and
        # weight gradients; the bias gradient sums it unrounded
        y = conv1d(h, w[f"w{i}"].to(cd).permute(1, 2, 0), padding=1)
        return (GradRound.apply(y, sd) if mixed else y) + w[f"b{i}"].to(cd)[:, None]

    means, variances = [], []

    def bn_relu(a, i):
        c, t = a.shape[1], a.shape[2]
        ag = a.reshape(G, nb, c, t)
        mean = ag.mean(dim=(1, 3))
        var = ag.var(dim=(1, 3), unbiased=False)
        means.append(torch.nn.functional.pad(mean.detach(), (0, FEAT - c)))
        variances.append(torch.nn.functional.pad(var.detach(), (0, FEAT - c)))
        xhat = (ag - mean[:, None, :, None]) * torch.rsqrt(var + EPS)[:, None, :, None]
        out = torch.relu(xhat * w[f"g{i}"].to(cd)[None, None, :, None] + w[f"o{i}"].to(cd)[None, None, :, None])
        return out.reshape(G * nb, c, t)

    with full_f32():
        h = x.to(cd).reshape(G, C, nb, FEAT).permute(0, 2, 1, 3).reshape(G * nb, C, FEAT)
        h = R(bn_relu(conv(upsample_linear_x2(h), 1), 1))
        h = R(bn_relu(conv(h, 2), 2))
        h = R(bn_relu(conv(upsample_linear_x2(h), 3), 3))
        h = bn_relu(conv(h, 4), 4)
        out = torch.sigmoid(conv(R(h), 5) / 3.0)
    return out.reshape(G, nb, SEQ), torch.stack(means, dim=1), torch.stack(variances, dim=1)


def upconv_taps_plain(x, w, b):
    """conv3(up2(x); w) + b at x's resolution, the form of bfloat16 A4f's
    upsampled convs: up2 is linear per channel in time, so with Y_k = w[k] x
    (a 1x1 product per tap over x's Th steps) the conv is b + sum over k of
    up2(Y_k)[t + k - 1], a tap outside [0, 2*Th) left out (the conv's zero
    padding). x [N, Cin, Th], w [3, Cout, Cin] tap-major, b [Cout]; returns
    [N, Cout, 2*Th] in x's dtype. Not on the main path: the tests hold it
    against `conv1d(upsample_linear_x2(x))`."""
    y = upsample_linear_x2(torch.einsum("koi,nit->knot", w.to(x.dtype), x))  # [3, N, Cout, 2*Th]
    out = y[1] + b.to(x.dtype)[:, None]
    out[..., 1:] += y[0][..., :-1]
    out[..., :-1] += y[2][..., 1:]
    return out


# ------------------------------------------------------------------ kernels
def _check(w: dict, x):
    sd = x.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage dtype {sd} not supported (float32 | bfloat16)")
    if x.dim() != 3 or x.shape[1] != 2 * FEAT or x.shape[2] == 0 or x.shape[2] % FEAT:
        raise ValueError(f"x must be [G, {2 * FEAT}, nb*{FEAT}], got {list(x.shape)}")
    for k in WNAMES:
        shape = _WSHAPES[k] if k[0] == "w" else (_WSHAPES["w" + k[1]][1],)
        want = sd if k[0] == "w" else torch.float32
        if tuple(w[k].shape) != shape or w[k].dtype != want or w[k].device != x.device:
            raise ValueError(f"w[{k!r}] must be {list(shape)} {want} on {x.device}, got "
                             f"{list(w[k].shape)} {w[k].dtype} on {w[k].device}")


def _suffix(sd) -> str:
    return "bf16" if sd == torch.bfloat16 else "f32"


def _lib(kind: str, sd):
    """(library, launch function, workspace size function) of kernel A4f
    (kind "fwd") or A4b ("bwd") for storage dtype sd. The launch takes (ptrs,
    G, nb, workspace, stream); the workspace holds `decoder_train_<kind>_
    workspace_floats_<suffix>(G, nb)` floats."""
    lib = build.load(f"decoder_train_{kind}")
    nptr = getattr(lib, f"decoder_train_{kind}_nptr")
    nptr.restype = ctypes.c_int
    if nptr() != len(PTR_NAMES):
        raise RuntimeError(f"decoder_train_{kind}: {nptr()} kernel pointers, the wrapper has {len(PTR_NAMES)}")
    fn = getattr(lib, f"decoder_train_{kind}_{_suffix(sd)}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    ws = getattr(lib, f"decoder_train_{kind}_workspace_floats_{_suffix(sd)}")
    ws.restype = ctypes.c_longlong
    ws.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib, fn, ws


def _ptr_table(tensors: dict):
    unknown = set(tensors) - set(PTR_NAMES)
    if unknown:
        raise KeyError(f"unknown kernel pointers {sorted(unknown)}")
    return (ctypes.c_void_p * len(PTR_NAMES))(
        *[tensors[n].data_ptr() if n in tensors else None for n in PTR_NAMES])


def _raise(lib, kind: str, rc: int):
    err = getattr(lib, f"decoder_train_{kind}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    raise RuntimeError(f"decoder_train_{kind} launch failed: {err(rc).decode()} (cudaError {rc})")


def _stream(dev) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _plane_specs(G: int, nb: int, sd) -> dict:
    """{name: (shape, dtype)} of the forward's planes and outputs: a* pre-BN
    float32, h1..h3 in the storage dtype, h4 float32, out [G, nb, 512], and
    the moments [G, 4, 128] float32."""
    N = G * nb
    f32 = torch.float32
    return {"P_A1": ((N, 128, 256), f32), "P_H1": ((N, 128, 256), sd), "P_A2": ((N, 128, 256), f32),
            "P_H2": ((N, 128, 256), sd), "P_A3": ((N, 64, SEQ), f32), "P_H3": ((N, 64, SEQ), sd),
            "P_A4": ((N, 64, SEQ), f32), "P_H4": ((N, 64, SEQ), f32), "OUT": ((G, nb, SEQ), f32),
            "MEAN": ((G, 4, FEAT), f32), "VAR": ((G, 4, FEAT), f32)}


def _planes(G: int, nb: int, sd, dev) -> dict:
    """Empty planes for A4f to fill; mean and var zero-filled (padded
    channels)."""
    return {n: (torch.zeros if n in ("MEAN", "VAR") else torch.empty)(s, dtype=d, device=dev)
            for n, (s, d) in _plane_specs(G, nb, sd).items()}


def _check_planes(planes: dict, x):
    """The planes A4b reads: every name of PLANES, contiguous, with the shape
    and dtype A4f gives them for x, on x's device."""
    if set(planes) != set(PLANES):
        raise ValueError(f"planes must hold {PLANES}, got {sorted(planes)}")
    for k, (shape, want) in _plane_specs(x.shape[0], x.shape[2] // FEAT, x.dtype).items():
        v = planes[k]
        if tuple(v.shape) != shape or v.dtype != want or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"planes[{k!r}] must be {list(shape)} {want} contiguous on {x.device}, got "
                             f"{list(v.shape)} {v.dtype} on {v.device}")


def _inputs(x, weights) -> dict:
    t = {"X": x.contiguous()}
    t.update((n.upper(), v.contiguous()) for n, v in zip(WNAMES, weights))
    return t


@torch.library.custom_op("ecgpan_torch::decoder_train_fwd", mutates_args=())
def _decoder_train_fwd_op(x: torch.Tensor, weights: list[torch.Tensor]) -> list[torch.Tensor]:
    """Kernel A4f. `weights` in WNAMES order; returns the planes in PLANES
    order (the last three: out, mean, var)."""
    t = _inputs(x, weights)
    G, nb = x.shape[0], x.shape[2] // FEAT
    lib, fn, ws_floats = _lib("fwd", x.dtype)
    planes = _planes(G, nb, x.dtype, x.device)
    ws = torch.empty(ws_floats(G, nb), dtype=torch.float32, device=x.device)
    rc = fn(_ptr_table({**t, **planes}), G, nb, ws.data_ptr(), _stream(x.device))
    if rc != 0:
        _raise(lib, "fwd", rc)
    return list(planes.values())


@torch.library.custom_op("ecgpan_torch::decoder_train_bwd", mutates_args=())
def _decoder_train_bwd_op(x: torch.Tensor, weights: list[torch.Tensor], dout: torch.Tensor,
                          planes: list[torch.Tensor]) -> list[torch.Tensor]:
    """Kernel A4b on A4f's planes (PLANES order). Returns [dx [G, 256,
    nb*128], *gradients in WNAMES order], float32."""
    t = _inputs(x, weights)
    t.update(zip(PLANES, planes))
    G, nb = x.shape[0], x.shape[2] // FEAT
    dev = x.device
    lib, fn, ws_floats = _lib("bwd", x.dtype)
    t["DOUT"] = dout.float().contiguous()
    t["DX"] = torch.empty(x.shape, dtype=torch.float32, device=dev)
    grads = {"G" + n.upper(): torch.empty(v.shape, dtype=torch.float32, device=dev)
             for n, v in zip(WNAMES, weights)}
    ws = torch.empty(ws_floats(G, nb), dtype=torch.float32, device=dev)
    rc = fn(_ptr_table({**t, **grads}), G, nb, ws.data_ptr(), _stream(dev))
    if rc != 0:
        _raise(lib, "bwd", rc)
    return [t["DX"], *grads.values()]


def _key(sd) -> str:
    return str(sd).removeprefix("torch.")


def forward_cuda(w: dict, x) -> dict:
    """Launch A4f on CUDA tensors: {name: plane} in PLANES order, out, mean
    and var last."""
    _check(w, x)
    if not x.is_cuda:
        raise ValueError("forward_cuda needs CUDA tensors")
    planes = dict(zip(PLANES, _decoder_train_fwd_op(x, [w[k] for k in WNAMES])))
    LAUNCHES[f"fwd_{_key(x.dtype)}"] += 1
    return planes


def backward_cuda(w: dict, x, dout, planes: dict | None = None) -> list:
    """Launch A4b on CUDA tensors: [dx, *gradients in WNAMES order], float32.
    `planes` are A4f's (forward_cuda) for these (w, x); without them A4f is
    launched first to fill them."""
    _check(w, x)
    if planes is not None:
        _check_planes(planes, x)
    if not x.is_cuda:
        raise ValueError("backward_cuda needs CUDA tensors")
    if planes is None:
        planes = forward_cuda(w, x)
    out = _decoder_train_bwd_op(x, [w[k] for k in WNAMES], dout, [planes[k] for k in PLANES])
    LAUNCHES[f"bwd_{_key(x.dtype)}"] += 1
    return out


class TrainDecodeGroups(torch.autograd.Function):
    """forward: kernel A4f, whose planes are kept; backward: kernel A4b on
    them. Arguments: (x, *weights in WNAMES order). The moments are marked
    non-differentiable."""

    @staticmethod
    def forward(ctx, x, *weights):
        planes = forward_cuda(dict(zip(WNAMES, weights)), x)
        ctx.save_for_backward(x, *weights, *planes.values())
        ctx.mark_non_differentiable(planes["MEAN"], planes["VAR"])
        return planes["OUT"], planes["MEAN"], planes["VAR"]

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, *rest = ctx.saved_tensors
        weights, kept = rest[:len(WNAMES)], rest[len(WNAMES):]
        dx, *dw = backward_cuda(dict(zip(WNAMES, weights)), x, dout, dict(zip(PLANES, kept)))
        return (dx.to(x.dtype), *(g.to(v.dtype) for g, v in zip(dw, weights)))


def train_decode_groups(w: dict, x, *, plain: bool = False):
    """w = pack_train_weights(params, dtype); x [G, 256, nb*128] channel-major
    gated latents in the same dtype. Returns (out [G, nb, 512] post-sigmoid
    float32, mean [G, 4, 128], var [G, 4, 128]): biased batch moments per BN
    layer, padded to 128 channels, without gradient. A CUDA tensor launches
    the kernels; a CPU tensor, or `plain=True` (to hold the kernels against
    it), runs `train_decode_groups_plain`."""
    _check(w, x)
    if plain or not x.is_cuda:
        return train_decode_groups_plain(w, x)
    return TrainDecodeGroups.apply(x, *(w[k] for k in WNAMES))


def make_train_decode_fn(compute_dtype=torch.float32):
    """The `train_decode_fn` hook of models.nefnet.nefnet_apply:
    `fn(p, s, stacked [3B, 256, 128]) -> (outs [3, B, 1, 512], running-stat
    updates)`, the three post-sigmoid decodes through the fused pair and the
    EMA-chained BN state."""

    def fn(p, s, stacked):
        nb = stacked.shape[0] // 3
        w = pack_train_weights(p, dtype=compute_dtype)
        x = (stacked.reshape(3, nb, 2 * FEAT, FEAT).permute(0, 2, 1, 3)
             .reshape(3, 2 * FEAT, nb * FEAT).to(compute_dtype))
        out, mean, var = train_decode_groups(w, x)
        return out.reshape(3, nb, 1, SEQ), chain_running_stats(s, mean, var, nb)

    return fn
