"""Streamed-basis eval decoder: the panorama hot path (kernel A1).

Port of electrocardio_panorama_tpu/ops/pallas/decoder_fused.py
`_decoder_kernel_ppu` + `_pp_tail`, entered through `fused_decode_views(enc=)`.

The eval decoder (models/nefnet.py decoder_apply) is a fixed chain

    gate x latent -> up x2 -> [conv k3 -> BN -> relu] x2 -> up x2
                  -> [conv k3 -> BN -> relu] x2 -> conv k3 -> sigmoid(x/3)

BN folds into the convs (`fold_decoder_bn`). Every op before the first ReLU
is linear in gate x latent, and the gate is affine in the J-1 angular
features (gate[v] = A @ [enc_v; 1], A = [mlp2.weight | mlp2.bias]), so the
head collapses to J basis planes per beat (`basis_planes`, J=13 at
theta_L=1) and a per-view mix:

    y1[v] = relu(sum_j ep[v, j] * U[j] + b1)        ep = [enc_v; 1]

`decode_basis` runs the mix and everything after it: the CUDA kernel
(`csrc/decoder_basis.cu`) for CUDA tensors, the plain PyTorch version below
for CPU tensors. A failed build or launch raises; nothing falls back.

Storage dtype: the folded weights' dtype. bfloat16 stores U, the weights and
the activations in bf16, rounding where the TPU kernel rounds (U and the mix
coefficients, y1, the conv2 and conv3 outputs, the conv4 output as conv5's
operand); all products and sums are float32, and the output is float32.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from electrocardio_panorama_tpu_torch.ops.convs import conv1d, full_f32
from electrocardio_panorama_tpu_torch.ops.kernels import build
from electrocardio_panorama_tpu_torch.ops.resample import upsample_linear_x2

FEAT = 128
SEQ = 512
MAX_BASIS = 32  # csrc/decoder_basis.cu MAXJ

# launches of the CUDA kernel by storage dtype; counted where it is launched
LAUNCHES: collections.Counter = collections.Counter()

_CONVS = [
    ("decoder.1.double_conv.0", "decoder.1.double_conv.1"),
    ("decoder.1.double_conv.3", "decoder.1.double_conv.4"),
    ("decoder.3.double_conv.0", "decoder.3.double_conv.1"),
    ("decoder.3.double_conv.3", "decoder.3.double_conv.4"),
    ("decoder.4", None),
]


def fold_decoder_bn(params: dict, state: dict, dtype=torch.float32) -> dict:
    """Fold eval-mode BatchNorm into the adjacent convs.

    Returns {w1, b1, ..., w5, b5, A}: w [3, Cout, Cin] tap-major ([0] = tap
    t-1, [1] = centre, [2] = t+1) in `dtype`; b [Cout] f32; A [256, J] f32 =
    [mlp2.weight | mlp2.bias], the affine gate basis.
    """
    out = {}
    for i, (conv, bn) in enumerate(_CONVS, start=1):
        w = params[f"{conv}.weight"].float()  # [Cout, Cin, 3]
        b = params[f"{conv}.bias"].float()
        if bn is not None:
            inv = params[f"{bn}.weight"].float() * torch.rsqrt(state[f"{bn}.running_var"].float() + 1e-5)
            w = w * inv[:, None, None]
            b = (b - state[f"{bn}.running_mean"].float()) * inv + params[f"{bn}.bias"].float()
        out[f"w{i}"] = w.permute(2, 0, 1).contiguous().to(dtype)
        out[f"b{i}"] = b.contiguous()
    out["A"] = torch.cat([params["mlp2.weight"].float(), params["mlp2.bias"].float()[:, None]], dim=1)
    return out


def basis_planes(folded: dict, latent_all) -> torch.Tensor:
    """U [B, J, 128, 256] f32, time order: U[b, j] = conv1(up2(A[:, j] *
    latent[b])) without bias — J conv1 evaluations per beat instead of V."""
    lat = latent_all.float()
    A = folded["A"]
    B, J = lat.shape[0], A.shape[1]
    x = (A.t()[None, :, :, None] * lat[:, None]).reshape(B * J, 2 * FEAT, FEAT)
    with full_f32():
        u = F.conv1d(upsample_linear_x2(x), folded["w1"].float().permute(1, 2, 0), padding=1)
    return u.reshape(B, J, FEAT, 2 * FEAT)


def basis_coeffs(enc) -> torch.Tensor:
    """[B, V, J] f32 mix coefficients: the angular encodings with the
    affine-gate ones column appended."""
    enc = enc.float()
    return torch.cat([enc, torch.ones(*enc.shape[:-1], 1, dtype=enc.dtype, device=enc.device)], dim=-1)


def decode_basis_plain(U, ep, folded) -> torch.Tensor:
    """The kernel's function in eager PyTorch. U [B, J, 128, 256] and the
    weights in the storage dtype, ep [B, V, J] f32 -> [B, V, 512] f32."""
    sd = folded["w2"].dtype
    B, V, J = ep.shape

    def r(x):  # round to the storage dtype, compute on in float32
        return x.to(sd).float()

    def conv(h, i):
        return conv1d(h, folded[f"w{i}"].float().permute(1, 2, 0), folded[f"b{i}"], padding=1)

    with full_f32():
        y = torch.einsum("bvj,bjfu->bvfu", ep.float(), U.float())
        h = r(torch.relu(y + folded["b1"][:, None])).reshape(B * V, FEAT, 2 * FEAT)
        h = r(torch.relu(conv(h, 2)))
        h = r(torch.relu(conv(upsample_linear_x2(h), 3)))
        h = r(torch.relu(conv(h, 4)))
        out = torch.sigmoid(conv(h, 5) / 3.0)
    return out.reshape(B, V, SEQ)


def _check(U, ep, folded):
    sd = folded["w2"].dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage dtype {sd} not supported (float32 | bfloat16)")
    B, V, J = ep.shape
    if U.shape != (B, J, FEAT, 2 * FEAT) or U.dtype != sd:
        raise ValueError(f"U must be [{B}, {J}, {FEAT}, {2 * FEAT}] {sd}, got {tuple(U.shape)} {U.dtype}")
    if ep.dtype != torch.float32 or not 0 < J <= MAX_BASIS:
        raise ValueError(f"ep must be float32 with 1..{MAX_BASIS} basis columns")
    shapes = {"w2": (3, 128, 128), "w3": (3, 64, 128), "w4": (3, 64, 64), "w5": (3, 1, 64),
              "b1": (128,), "b2": (128,), "b3": (64,), "b4": (64,), "b5": (1,)}
    for k, shape in shapes.items():
        t = folded[k]
        want = sd if k[0] == "w" else torch.float32
        if tuple(t.shape) != shape or t.dtype != want or t.device != U.device:
            raise ValueError(f"folded[{k!r}] must be {shape} {want} on {U.device}")


def _launch(U, ep, b1, w2, b2, w3, b3, w4, b4, w5, b5) -> torch.Tensor:
    lib = build.load("decoder_basis")
    sd = w2.dtype
    fn = lib.decoder_basis_bf16 if sd == torch.bfloat16 else lib.decoder_basis_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    B, V, J = ep.shape
    n = B * V
    dev = U.device
    h2 = torch.empty(n, FEAT, 2 * FEAT, dtype=sd, device=dev)
    h3 = torch.empty(n, 64, SEQ, dtype=sd, device=dev)
    h4 = torch.empty(n, 64, SEQ, dtype=sd, device=dev)
    out = torch.empty(B, V, SEQ, dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (U, ep, b1, w2, b2, w3, b3, w4, b4, w5, b5)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in (*args, h2, h3, h4, out)], B, V, J, stream)
    if rc != 0:
        lib.decoder_basis_error_string.restype = ctypes.c_char_p
        msg = lib.decoder_basis_error_string(rc).decode()
        raise RuntimeError(f"decoder_basis launch failed: {msg} (cudaError {rc})")
    return out


@torch.library.custom_op("ecgpan_torch::decoder_basis", mutates_args=())
def _decoder_basis_op(U: torch.Tensor, ep: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor, w4: torch.Tensor,
                      b4: torch.Tensor, w5: torch.Tensor, b5: torch.Tensor) -> torch.Tensor:
    return _launch(U, ep, b1, w2, b2, w3, b3, w4, b4, w5, b5)


def decode_basis_cuda(U, ep, folded) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/decoder_basis.cu) on CUDA tensors."""
    if not U.is_cuda:
        raise ValueError("decode_basis_cuda needs CUDA tensors")
    _check(U, ep, folded)
    out = _decoder_basis_op(U, ep, *(folded[k] for k in ("b1", "w2", "b2", "w3", "b3",
                                                         "w4", "b4", "w5", "b5")))
    LAUNCHES[str(folded["w2"].dtype).removeprefix("torch.")] += 1
    return out


def decode_basis(U, ep, folded) -> torch.Tensor:
    """Mix + conv2..conv5 + sigmoid: [B, V, 512] f32. A CUDA tensor launches
    the kernel; a CPU tensor runs the plain version (the caller chose the
    CPU)."""
    if U.is_cuda:
        return decode_basis_cuda(U, ep, folded)
    _check(U, ep, folded)
    return decode_basis_plain(U, ep, folded)


def fused_decode_views(folded: dict, latent_all, *, enc, v_tile: int = 16,
                       plain: bool = False) -> torch.Tensor:
    """latent_all [B, 256, 128], enc [B, V, J-1] angular encodings ->
    [B, V, 512] f32. V pads up to a multiple of `v_tile` and the output is
    trimmed back, as the JAX package does. `plain=True` runs the plain
    version on any device (to hold the kernel against it)."""
    if v_tile <= 0:
        raise ValueError(f"v_tile must be positive, got {v_tile}")
    sd = folded["w2"].dtype
    B, V = enc.shape[0], enc.shape[1]
    pad = (-V) % v_tile
    if pad:
        enc = torch.cat([enc, enc.new_zeros(B, pad, enc.shape[2])], dim=1)
    U = basis_planes(folded, latent_all).to(sd)
    ep = basis_coeffs(enc).to(sd).float()  # the mix coefficients round like U
    out = decode_basis_plain(U, ep, folded) if plain else decode_basis(U, ep, folded)
    return out[:, :V] if pad else out
