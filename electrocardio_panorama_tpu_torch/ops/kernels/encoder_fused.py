"""Fused Nef-Net encoder: forward (kernel A2) and backward (kernel A3).

Port of electrocardio_panorama_tpu/ops/pallas/encoder_fused.py: `_fwd_kernel`
(via `_fwd_call`) and `_bwd_kernel` (via `_bwd_call`) under the custom VJP
`encode_fused_train`, plus `encode_fused_eval`. The chain, in the model
layout [B, C, T]:

    conv1(k15, s2) -> relu -> maxpool(k3, s2) -> 3x BasicBlock(k7) + dropout
    -> x gate1 -> w_conv(k3) -> split z1/z2 -> z1_conv / z2_conv1
    -> roi_align (closed form) -> z2_conv2.{0, 1 (convT k2 s2), 2}

emitting z1 [B, 128L, 128] and the pre-reverse z2 grid [B, 896L, 32]. The
mlp1 gate, the ROI ramp, roi_reverse and the lead means stay plain PyTorch
around it (`make_fused_encode_fn`), as they stay XLA in the JAX package.

`encode_fused` runs the CUDA kernels (`csrc/encoder_fwd.cu`,
`csrc/encoder_bwd.cu`, shared stages in `csrc/encoder_common.cuh`; every
conv but conv1, and its weight gradient, on the tensor-core engine of
`csrc/encoder_tc.cuh` in bfloat16 and on the FMA engine of
`csrc/encoder_fma.cuh` in float32, conv1 on SIMT kernels) for CUDA
tensors, inside one torch.autograd.Function whose forward launches A2 and
whose backward launches A3; for CPU tensors it runs `encoder_plain`, the
same function as mask-explicit eager convs through autograd. A failed build
or launch raises; nothing falls back.

Storage dtype: the input's (float32, or bfloat16 under the mixed-precision
step). Values round to it where the TPU kernel rounds them (after each relu
and block output, the dropout and gate products, the roi_align midpoint and
output, the convT products), every product and sum is float32, and in the
backward a gradient rounds to it only as a product's operand. The plain
version rounds at the same points (`Round`, and `GradRound` for the
backward operands).

Dropout masks are pre-scaled inputs (0 or 1/0.8) in the model layout,
drawn by `draw_masks` from an explicit torch.Generator, so the kernel and
the eager path can run on the same masks.

`TPU.encoder_ckpt` picks what the forward keeps for the backward: 'full'
every plane, 'tower' the seven tower planes (the backward recomputes conv1,
the dropout products and every post-tower stage), 'off' none (the backward
recomputes the whole forward). The same kernels recompute the same values,
and the weight gradients reduce in a fixed order, so the three give
bitwise-identical gradients.
"""

from __future__ import annotations

import collections
import ctypes
import os

import torch

from electrocardio_panorama_tpu_torch.ops.convs import (
    conv1d,
    conv_transpose1d_k2s2,
    dropout_mask,
    linear,
    max_pool1d,
)
from electrocardio_panorama_tpu_torch.ops.kernels import build
from electrocardio_panorama_tpu_torch.ops.kernels.rounding import GradRound, Round
from electrocardio_panorama_tpu_torch.ops.roi import roi_align_ramp
from electrocardio_panorama_tpu_torch.ops.theta import angular_encode

FEAT = 128
SEQ = 512
ALIGN = 16
SEGS = 7
DROPOUT_RATE = 0.2

# launches of the CUDA kernels, keyed "fwd_<dtype>" / "bwd_<dtype>"; counted
# where they are launched (the backward's recompute is part of its launch)
LAUNCHES: collections.Counter = collections.Counter()

# csrc/encoder_common.cuh `enum Ptr`, in order
_INPUTS = ["X", "GATE", "RAMP", "M6", "MC20", "MC22"]
WEIGHT_KEYS = {
    "W_C1": "W_encoder.conv1.weight",
    "W_L0C1": "W_encoder.layer1.0.conv1.weight", "W_L0C2": "W_encoder.layer1.0.conv2.weight",
    "W_L1C1": "W_encoder.layer1.1.conv1.weight", "W_L1C2": "W_encoder.layer1.1.conv2.weight",
    "W_L2C1": "W_encoder.layer1.2.conv1.weight", "W_L2C2": "W_encoder.layer1.2.conv2.weight",
    "W_WC1": "w_conv.0.conv1.weight", "W_WC2": "w_conv.0.conv2.weight",
    "W_Z1W1": "z1_conv.0.conv1.weight", "W_Z1W2": "z1_conv.0.conv2.weight",
    "W_Z1WR": "z1_conv.0.residual_conv.weight", "B_Z1": "z1_conv.0.residual_conv.bias",
    "W_Z2W1": "z2_conv1.0.conv1.weight", "W_Z2W2": "z2_conv1.0.conv2.weight",
    "W_Z2WR": "z2_conv1.0.residual_conv.weight", "B_Z2": "z2_conv1.0.residual_conv.bias",
    "W_C20W1": "z2_conv2.0.conv1.weight", "W_C20W2": "z2_conv2.0.conv2.weight",
    "W_T": "z2_conv2.1.weight", "B_T": "z2_conv2.1.bias",
    "W_C22W1": "z2_conv2.2.conv1.weight", "W_C22W2": "z2_conv2.2.conv2.weight",
    "W_C22WR": "z2_conv2.2.residual_conv.weight", "B_C22": "z2_conv2.2.residual_conv.bias",
}
_LEAD_PLANES = ["P_H0", "P_R1_0", "P_R1M_0", "P_H1", "P_R1_1", "P_R1M_1", "P_H2", "P_R1_2", "P_R1M_2",
                "P_H3", "P_HG", "P_WR1", "P_WR1M", "P_HW", "P_ZR11", "P_ZR1M1", "P_Z1F", "P_ZR12",
                "P_ZR1M2", "P_Z2F"]
PLANES = ["P_C", *_LEAD_PLANES, "P_A", "P_C1", "P_C1M", "P_HC", "P_HT", "P_C2", "P_C2M", "P_Z2G"]
_GRAD_NAMES = ["G" + k[1:] if k.startswith("W_") else "G_B" + k[2:] for k in WEIGHT_KEYS]
PTR_NAMES = [*_INPUTS, *WEIGHT_KEYS, *PLANES, "D_Z1", "D_Z2G", "G_GATE", *_GRAD_NAMES]

# what the forward keeps per encoder_ckpt mode, and the backward's recompute level
_TOWER = ["P_H0", "P_R1_0", "P_H1", "P_R1_1", "P_H2", "P_R1_2", "P_H3"]
_KEEP = {"off": [], "tower": _TOWER, "full": PLANES}
_LEVEL = {"off": 2, "tower": 1, "full": 0}

# the sections of one A3 launch that `backward_section_ms` times, in chain order
SECTIONS = ["recompute", "z2_conv2", "roi + z-blocks", "w_conv + gate", "tower", "maxpool + conv1"]


def ckpt_mode(v) -> str:
    """TPU.encoder_ckpt: False/None/'off' -> 'off', True/'tower' -> 'tower', 'full'."""
    if v in (False, None, "off", "false", ""):
        return "off"
    if v in (True, "tower", "true"):
        return "tower"
    if v == "full":
        return "full"
    raise ValueError(f"encoder_ckpt: expected off|tower|full, got {v!r}")


def plane_shapes(B: int, L: int) -> dict:
    C, Cz, Ch = FEAT * L, FEAT * SEGS * L, 64 * SEGS * L
    shapes = {"P_C": (B, C, 2 * FEAT)}
    shapes.update({n: (B, C, FEAT) for n in _LEAD_PLANES})
    shapes.update({n: (B, Cz, ALIGN) for n in ("P_A", "P_C1", "P_C1M", "P_HC")})
    shapes["P_HT"] = (B, Ch, 2 * ALIGN)
    shapes.update({n: (B, Cz, 2 * ALIGN) for n in ("P_C2", "P_C2M", "P_Z2G")})
    return shapes


def draw_masks(generator: torch.Generator, B: int, L: int, dtype=torch.float32):
    """Pre-scaled dropout masks of the encoder's eight dropout sites, model
    layout, on the generator's device: (m6 [6, B, 128L, 128] for layer1
    blocks 0-2, w_conv, z1_conv, z2_conv1; mc20 [B, 896L, 16]; mc22
    [B, 896L, 32])."""
    C, Cz = FEAT * L, FEAT * SEGS * L
    return (dropout_mask((6, B, C, FEAT), DROPOUT_RATE, generator, dtype=dtype),
            dropout_mask((B, Cz, ALIGN), DROPOUT_RATE, generator, dtype=dtype),
            dropout_mask((B, Cz, 2 * ALIGN), DROPOUT_RATE, generator, dtype=dtype))


# ------------------------------------------------------------- plain version
def encoder_plain(w: dict, x, gate, ramp, masks=None, *, lead_num: int, planes: dict | None = None,
                  float64: bool = False):
    """The kernels' function in eager PyTorch: z1 [B, 128L, 128] and the z2
    grid [B, 896L, 32] in x's dtype. `w` maps torch keys to weights, gate is
    [B, L, 128], ramp [B, 7, 16], masks as `draw_masks` (None: eval). Every
    op runs in float32 on values rounded to x's dtype at the kernels' points,
    so autograd gives the kernels' gradient. `planes`, if given, receives the
    intermediate planes under the kernels' names. `float64=True` (float32
    inputs only) runs every op in float64 and returns float64: a reference
    that the float32 kernels and this function's float32 pass are both held
    against."""
    sd = x.dtype
    mixed = sd != torch.float32
    if float64 and mixed:
        raise ValueError(f"encoder_plain: float64=True takes float32 inputs, got {sd}")
    cd = torch.float64 if float64 else torch.float32
    L = lead_num
    B = x.shape[0]
    C, G7 = FEAT * L, SEGS * L

    def R(t):
        return Round.apply(t, sd) if mixed else t

    def G(t):
        return GradRound.apply(t, sd) if mixed else t

    def f(k):
        return w[WEIGHT_KEYS[k]].to(cd)

    def conv(h, k, pad, groups, stride=1):
        return G(conv1d(h, f(k), stride=stride, padding=pad, groups=groups))

    def keep(name, t):
        if planes is not None:
            planes[name] = t
        return t

    m6, mc20, mc22 = (None, None, None) if masks is None else (m.to(cd) for m in masks)

    def drop(name, t, m):
        return keep(name, R(t * m)) if m is not None else t

    c = keep("P_C", R(torch.relu(conv(x.to(cd), "W_C1", 7, L, stride=2))))
    h = keep("P_H0", max_pool1d(c, kernel=3, stride=2, padding=1))
    for b in range(3):
        r1 = keep(f"P_R1_{b}", R(torch.relu(conv(h, f"W_L{b}C1", 3, L))))
        r1m = drop(f"P_R1M_{b}", r1, None if m6 is None else m6[b])
        h = keep(f"P_H{b + 1}", R(torch.relu(conv(r1m, f"W_L{b}C2", 3, L) + h)))
    hg = keep("P_HG", R(h * gate.to(cd).reshape(B, C, 1)))

    wr1 = keep("P_WR1", R(torch.relu(conv(hg, "W_WC1", 1, L))))
    wr1m = drop("P_WR1M", wr1, None if m6 is None else m6[3])
    hw = keep("P_HW", R(torch.relu(conv(wr1m, "W_WC2", 1, L) + hg)))

    hw4 = hw.reshape(B, L, FEAT, FEAT)
    zf = []
    for z, nm in ((0, "Z1"), (1, "Z2")):
        zin = hw4[:, :, 64 * z:64 * (z + 1)].reshape(B, 64 * L, FEAT)
        zr1 = keep(f"P_ZR1{z + 1}", R(torch.relu(conv(zin, f"W_{nm}W1", 1, L))))
        zr1m = drop(f"P_ZR1M{z + 1}", zr1, None if m6 is None else m6[4 + z])
        pre = (conv(zr1m, f"W_{nm}W2", 1, L) + conv(zin, f"W_{nm}WR", 0, L)) + f(f"B_{nm}")[:, None]
        zf.append(keep(f"P_{nm}F", R(torch.relu(pre))))
    z1f, z2f = zf

    # roi_align in closed form, flat (channel, segment) rows
    mid = G(R(0.5 * z2f[..., FEAT // 2 - 1] + 0.5 * z2f[..., FEAT // 2]))  # [B, C]
    midx = G(mid[:, :, None].expand(B, C, ALIGN))
    A = keep("P_A", R(midx[:, :, None, :] * ramp.to(cd)[:, None]).reshape(B, C * SEGS, ALIGN))

    c1 = keep("P_C1", R(torch.relu(conv(A, "W_C20W1", 1, G7))))
    c1m = drop("P_C1M", c1, mc20)
    Hc = keep("P_HC", R(torch.relu(conv(c1m, "W_C20W2", 1, G7) + A)))
    y = conv_transpose1d_k2s2(Hc, f("W_T"), None, groups=G7)
    Ht = keep("P_HT", R(G(R(y)) + f("B_T")[:, None]))
    c2 = keep("P_C2", R(torch.relu(conv(Ht, "W_C22W1", 1, G7))))
    c2m = drop("P_C2M", c2, mc22)
    pre = (conv(c2m, "W_C22W2", 1, G7) + conv(Ht, "W_C22WR", 0, G7)) + f("B_C22")[:, None]
    z2g = keep("P_Z2G", R(torch.relu(pre)))
    od = cd if float64 else sd
    return z1f.to(od), z2g.to(od)


# ------------------------------------------------------------------ kernels
def _check(w: dict, x, gate, ramp, masks, L: int):
    sd = x.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage dtype {sd} not supported (float32 | bfloat16)")
    B = x.shape[0]
    C, Cz = FEAT * L, FEAT * SEGS * L
    want = {"x": (x, (B, L, SEQ)), "gate": (gate, (B, L, FEAT)), "ramp": (ramp, (B, SEGS, ALIGN))}
    if masks is not None:
        want.update(m6=(masks[0], (6, B, C, FEAT)), mc20=(masks[1], (B, Cz, ALIGN)),
                    mc22=(masks[2], (B, Cz, 2 * ALIGN)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != sd or t.device != x.device:
            raise ValueError(f"{name} must be {list(shape)} {sd} on {x.device}, got "
                             f"{list(t.shape)} {t.dtype} on {t.device}")
    for k in WEIGHT_KEYS.values():
        if w[k].dtype != sd or w[k].device != x.device:
            raise ValueError(f"weight {k!r} must be {sd} on {x.device}")


def _lib(kind: str, sd):
    lib = build.load(f"encoder_{kind}")
    nptr = getattr(lib, f"encoder_{kind}_nptr")
    nptr.restype = ctypes.c_int
    if nptr() != len(PTR_NAMES):
        raise RuntimeError(f"encoder_{kind}: {nptr()} kernel pointers, the wrapper has {len(PTR_NAMES)}")
    suffix = "bf16" if sd == torch.bfloat16 else "f32"
    fn = getattr(lib, f"encoder_{kind}_{suffix}")
    fn.restype = ctypes.c_int
    ws = getattr(lib, f"encoder_{kind}_workspace_floats_{suffix}")
    ws.restype = ctypes.c_longlong
    if kind == "fwd":
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        ws.argtypes = [ctypes.c_int]
    else:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        ws.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib, fn, ws


def _ptr_table(tensors: dict):
    unknown = set(tensors) - set(PTR_NAMES)
    if unknown:
        raise KeyError(f"unknown kernel pointers {sorted(unknown)}")
    return (ctypes.c_void_p * len(PTR_NAMES))(
        *[tensors[n].data_ptr() if n in tensors else None for n in PTR_NAMES])


def _raise(lib, kind: str, rc: int):
    err = getattr(lib, f"encoder_{kind}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    site = getattr(lib, f"encoder_{kind}_error_file")
    site.restype = ctypes.c_char_p
    line = getattr(lib, f"encoder_{kind}_error_line")
    line.restype = ctypes.c_int
    where = f"{os.path.basename(site().decode())}:{line()}"
    raise RuntimeError(f"encoder_{kind} launch failed: {err(rc).decode()} (cudaError {rc}, at {where})")


def _input_names(train: bool) -> list[str]:
    return [*_INPUTS, *WEIGHT_KEYS] if train else [*_INPUTS[:3], *WEIGHT_KEYS]


def _stream(dev) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


@torch.library.custom_op("ecgpan_torch::encoder_fwd", mutates_args=())
def _encoder_fwd_op(inputs: list[torch.Tensor], lead_num: int, train: bool) -> list[torch.Tensor]:
    """Kernel A2. `inputs` in `_input_names(train)` order; returns every
    forward plane, in PLANES order."""
    t = {n: v.contiguous() for n, v in zip(_input_names(train), inputs)}
    x = t["X"]
    lib, fn, ws_floats = _lib("fwd", x.dtype)
    planes = {n: torch.empty(s, dtype=x.dtype, device=x.device)
              for n, s in plane_shapes(x.shape[0], lead_num).items()}
    ws = torch.empty(ws_floats(lead_num), dtype=torch.float32, device=x.device)
    rc = fn(_ptr_table({**t, **planes}), x.shape[0], lead_num, int(train), ws.data_ptr(), _stream(x.device))
    if rc != 0:
        _raise(lib, "fwd", rc)
    return [planes[n] for n in PLANES]


def _run_bwd(inputs, kept, dz1, dz2g, lead_num: int, mode: str, section_ms=None) -> list[torch.Tensor]:
    """One A3 launch; `section_ms`: None, or a ctypes array of len(SECTIONS)
    floats that receives the sections' times (the call then waits)."""
    t = {n: v.contiguous() for n, v in zip(_input_names(True), inputs)}
    x = t["X"]
    sd, B, dev = x.dtype, x.shape[0], x.device
    lib, fn, ws_floats = _lib("bwd", sd)
    t.update(zip(_KEEP[mode], (v.contiguous() for v in kept)))
    for n, s in plane_shapes(B, lead_num).items():  # scratch the backward recomputes
        if n not in t:
            t[n] = torch.empty(s, dtype=sd, device=dev)
    t["D_Z1"] = dz1.to(sd).contiguous()
    t["D_Z2G"] = dz2g.to(sd).contiguous()
    grads = {"G_GATE": torch.empty(B, lead_num, FEAT, dtype=torch.float32, device=dev)}
    for gname, wname in zip(_GRAD_NAMES, WEIGHT_KEYS):
        grads[gname] = torch.empty(t[wname].shape, dtype=torch.float32, device=dev)
    ws = torch.empty(ws_floats(B, lead_num), dtype=torch.float32, device=dev)
    rc = fn(_ptr_table({**t, **grads}), B, lead_num, _LEVEL[mode], ws.data_ptr(), section_ms, _stream(dev))
    if rc != 0:
        _raise(lib, "bwd", rc)
    return [grads["G_GATE"], *(grads[g] for g in _GRAD_NAMES)]


@torch.library.custom_op("ecgpan_torch::encoder_bwd", mutates_args=())
def _encoder_bwd_op(inputs: list[torch.Tensor], kept: list[torch.Tensor], dz1: torch.Tensor,
                    dz2g: torch.Tensor, lead_num: int, mode: str) -> list[torch.Tensor]:
    """Kernel A3. `inputs` in `_input_names(True)` order, `kept` the planes
    `_KEEP[mode]` names; returns [dgate [B, L, 128], *weight grads in
    WEIGHT_KEYS order], float32."""
    return _run_bwd(inputs, kept, dz1, dz2g, lead_num, mode)


def _key(sd) -> str:
    return str(sd).removeprefix("torch.")


def forward_cuda(w: dict, x, gate, ramp, masks, *, lead_num: int) -> dict:
    """Launch A2 on CUDA tensors; {plane name: tensor} for every PLANES entry
    (P_Z1F is z1, P_Z2G the z2 grid)."""
    train = masks is not None
    inputs = [x, gate, ramp, *(masks if train else ()), *(w[k] for k in WEIGHT_KEYS.values())]
    out = dict(zip(PLANES, _encoder_fwd_op(inputs, lead_num, train)))
    LAUNCHES[f"fwd_{_key(x.dtype)}"] += 1
    return out


def backward_cuda(w: dict, x, gate, ramp, masks, kept: dict, dz1, dz2g, *, lead_num: int,
                  mode: str) -> list:
    """Launch A3 on CUDA tensors: [dgate, *weight grads in WEIGHT_KEYS order],
    float32. `kept` holds the planes `encoder_ckpt` mode `mode` keeps."""
    inputs = [x, gate, ramp, *masks, *(w[k] for k in WEIGHT_KEYS.values())]
    out = _encoder_bwd_op(inputs, [kept[n] for n in _KEEP[mode]], dz1, dz2g, lead_num, mode)
    LAUNCHES[f"bwd_{_key(x.dtype)}"] += 1
    return out


def backward_section_ms(w: dict, x, gate, ramp, masks, kept: dict, dz1, dz2g, *, lead_num: int,
                        mode: str) -> dict[str, float]:
    """One A3 launch on CUDA tensors (arguments as for backward_cuda) with
    each section of its chain timed by CUDA events inside the call:
    {section: ms} in SECTIONS order. A measurement, not counted in LAUNCHES."""
    if not x.is_cuda:
        raise ValueError("backward_section_ms needs CUDA tensors")
    _check(w, x, gate, ramp, masks, lead_num)
    ms = (ctypes.c_float * len(SECTIONS))()
    inputs = [x, gate, ramp, *masks, *(w[k] for k in WEIGHT_KEYS.values())]
    _run_bwd(inputs, [kept[n] for n in _KEEP[mode]], dz1, dz2g, lead_num, mode, ms)
    return {name: float(v) for name, v in zip(SECTIONS, ms)}


class EncoderFused(torch.autograd.Function):
    """forward: kernel A2 in train form; backward: kernel A3. Arguments:
    (mode, L, x, gate, ramp, m6, mc20, mc22, *weights in WEIGHT_KEYS order)."""

    @staticmethod
    def forward(ctx, mode, L, x, gate, ramp, m6, mc20, mc22, *weights):
        w = dict(zip(WEIGHT_KEYS.values(), weights))
        planes = forward_cuda(w, x, gate, ramp, (m6, mc20, mc22), lead_num=L)
        ctx.mode, ctx.L = mode, L
        ctx.save_for_backward(x, gate, ramp, m6, mc20, mc22, *weights, *(planes[n] for n in _KEEP[mode]))
        return planes["P_Z1F"], planes["P_Z2G"]

    @staticmethod
    def backward(ctx, dz1, dz2g):
        x, gate, ramp, m6, mc20, mc22, *rest = ctx.saved_tensors
        nw = len(WEIGHT_KEYS)
        weights, kept = rest[:nw], rest[nw:]
        shapes = plane_shapes(x.shape[0], ctx.L)
        dz1 = x.new_zeros(shapes["P_Z1F"]) if dz1 is None else dz1
        dz2g = x.new_zeros(shapes["P_Z2G"]) if dz2g is None else dz2g
        dgate, *dw = backward_cuda(dict(zip(WEIGHT_KEYS.values(), weights)), x, gate, ramp,
                                   (m6, mc20, mc22), dict(zip(_KEEP[ctx.mode], kept)), dz1, dz2g,
                                   lead_num=ctx.L, mode=ctx.mode)
        return (None, None, None, dgate.to(gate.dtype), None, None, None, None,
                *(g.to(v.dtype) for g, v in zip(dw, weights)))


def encode_fused(w: dict, x, gate, ramp, masks=None, *, lead_num: int, ckpt="tower",
                 plain: bool = False):
    """(z1 [B, 128L, 128], z2 grid [B, 896L, 32]) in x's dtype. With `masks`
    the train form (dropout; differentiable), without it the eval form. A
    CUDA tensor launches the kernels; a CPU tensor, or `plain=True` (to hold
    the kernels against it), runs `encoder_plain`."""
    _check(w, x, gate, ramp, masks, lead_num)
    mode = ckpt_mode(ckpt)
    if plain or not x.is_cuda:
        return encoder_plain(w, x, gate, ramp, masks, lead_num=lead_num)
    if masks is None:
        with torch.no_grad():
            planes = forward_cuda(w, x, gate, ramp, None, lead_num=lead_num)
        return planes["P_Z1F"], planes["P_Z2G"]
    return EncoderFused.apply(mode, lead_num, x, gate, ramp, *masks,
                              *(w[k] for k in WEIGHT_KEYS.values()))


def make_fused_encode_fn(lead_num: int, theta_encoder_len: int = 1, *, ckpt="tower",
                         plain: bool = False):
    """The `encode_fn` hook of models.nefnet.nefnet_apply: encode_latents
    through the fused encoder. `fn(p, x, input_thetas, rois, masks=None,
    train=False) -> NefNetLatents`."""
    from electrocardio_panorama_tpu_torch.models.nefnet import latents_from_grid

    mode = ckpt_mode(ckpt)
    L = lead_num

    def fn(p, x, input_thetas, rois, *, masks=None, train=False):
        if train and masks is None:
            raise ValueError("fused encoder: train=True needs the dropout masks (draw_masks)")
        B = x.shape[0]
        gate = linear(angular_encode(input_thetas, theta_encoder_len), p["mlp1.weight"],
                      p["mlp1.bias"]).to(x.dtype)
        ramp = roi_align_ramp(rois).to(x.dtype)
        w = {k: p[k] for k in WEIGHT_KEYS.values()}
        z1, z2g = encode_fused(w, x, gate, ramp, masks if train else None, lead_num=L, ckpt=mode,
                               plain=plain)
        return latents_from_grid(z1, z2g.reshape(B, FEAT * L, SEGS, 2 * ALIGN), rois, lead_num=L)

    return fn
