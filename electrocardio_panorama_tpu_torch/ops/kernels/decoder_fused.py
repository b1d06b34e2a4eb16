"""Fused eval decoder: the streamed-basis form of the panorama hot path
(kernel A1) and the gate-input and y1 forms (kernels A5/A7 and A6).

Port of electrocardio_panorama_tpu/ops/pallas/decoder_fused.py
`fused_decode_views` with every kernel it reaches: `_decoder_kernel_ppu`
(`enc=`, heads 'stream' / 'stream_scalar' / 'auto'), `_decoder_kernel_ppb`
(`enc=`, head 'y1'), `_decoder_kernel_pp` and `_decoder_kernel` (`gates=`),
all of them over the shared tail `_pp_tail`.

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

The two other forms are audit paths beside it (`csrc/decoder_forms.cu`, the
stage kernels shared through `csrc/decoder_common.cuh`):

  * `decode_gates` takes the views' gates [B, V, 256] (`query_gates`) and runs
    the whole chain, gate x latent and conv1 included, per view. The JAX
    package has two kernels for this function of these inputs, the polyphase
    one (float32 and bfloat16) and the float32 dense-upsample one behind
    `ECGPAN_F32_LAYOUT_A`; they differ only in their Mosaic layouts, so the
    port has one kernel and no such switch, and its float32 instantiation
    stands for both.
  * `decode_y1` takes y1 planes [B, V, 128, 256] that `basis_y1` mixed outside
    the kernel in eager PyTorch and runs conv2 onwards: it splits A1's mix
    from A1's tail.

Storage dtype: the folded weights' dtype. bfloat16 stores U, the weights and
the activations in bf16, rounding where the TPU kernel rounds (U and the mix
coefficients, y1, the conv2 and conv3 outputs, the conv4 output as conv5's
operand; in the gate form the latent, the gate and their product); all
products and sums are float32, and the output is float32. The TPU gate
kernel's polyphase conv1 rounds one more intermediate that the time-order
form does not have, so its bfloat16 agrees with the JAX package within a
tolerance, not bitwise.
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

# launches of the CUDA kernels, counted where they are launched: A1 by storage
# dtype ("float32" / "bfloat16"), the gate form "gates_<dtype>", the y1 form
# "y1_<dtype>"
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


def _conv(h, folded, i):
    return conv1d(h, folded[f"w{i}"].float().permute(1, 2, 0), folded[f"b{i}"], padding=1)


def _tail_plain(y1, folded) -> torch.Tensor:
    """conv2 .. conv5 + sigmoid in eager PyTorch on y1 [N, 128, 256] (float32
    values already rounded to the storage dtype) -> [N, 512] f32. Call inside
    `full_f32()`."""
    sd = folded["w2"].dtype

    def r(x):  # round to the storage dtype, compute on in float32
        return x.to(sd).float()

    h = r(torch.relu(_conv(y1, folded, 2)))
    h = r(torch.relu(_conv(upsample_linear_x2(h), folded, 3)))
    h = r(torch.relu(_conv(h, folded, 4)))
    return torch.sigmoid(_conv(h, folded, 5) / 3.0).reshape(-1, SEQ)


def decode_basis_plain(U, ep, folded) -> torch.Tensor:
    """The kernel's function in eager PyTorch. U [B, J, 128, 256] and the
    weights in the storage dtype, ep [B, V, J] f32 -> [B, V, 512] f32."""
    sd = folded["w2"].dtype
    B, V, J = ep.shape
    with full_f32():
        y = torch.einsum("bvj,bjfu->bvfu", ep.float(), U.float())
        y1 = torch.relu(y + folded["b1"][:, None]).to(sd).float().reshape(B * V, FEAT, 2 * FEAT)
        out = _tail_plain(y1, folded)
    return out.reshape(B, V, SEQ)


def basis_y1(folded: dict, latent_all, enc) -> torch.Tensor:
    """The materialized rank-J head: the per-beat basis planes mixed against
    the view coefficients in eager PyTorch, outside any kernel, as the JAX
    package mixes them in XLA. Returns the post-ReLU y1 [B, V, 128, 256] in
    the folded storage dtype (U and the coefficients round to it first;
    float32 runs at full float32)."""
    sd = folded["w2"].dtype
    U = basis_planes(folded, latent_all).to(sd)
    ep = basis_coeffs(enc).to(sd)
    with full_f32():
        y = torch.einsum("bvj,bjfu->bvfu", ep.float(), U.float())
        return torch.relu(y + folded["b1"][None, None, :, None]).to(sd)


def decode_y1_plain(y1, folded) -> torch.Tensor:
    """The y1 kernel's function in eager PyTorch: y1 [B, V, 128, 256] in the
    storage dtype -> [B, V, 512] f32."""
    B, V = y1.shape[:2]
    with full_f32():
        return _tail_plain(y1.float().reshape(B * V, FEAT, 2 * FEAT), folded).reshape(B, V, SEQ)


def decode_gates_plain(latent, gates, folded) -> torch.Tensor:
    """The gate kernel's function in eager PyTorch: latent [B, 256, 128] in
    the storage dtype, gates [B, V, 256] f32 -> [B, V, 512] f32. The gate
    rounds to the storage dtype, and so does its product with the latent."""
    sd = folded["w2"].dtype
    B, V = gates.shape[:2]
    with full_f32():
        x = (gates.to(sd)[..., None] * latent[:, None]).float().reshape(B * V, 2 * FEAT, FEAT)
        y1 = torch.relu(_conv(upsample_linear_x2(x), folded, 1)).to(sd).float()
        return _tail_plain(y1, folded).reshape(B, V, SEQ)


_SHAPES = {"w1": (3, 128, 256), "w2": (3, 128, 128), "w3": (3, 64, 128), "w4": (3, 64, 64), "w5": (3, 1, 64),
           "b1": (128,), "b2": (128,), "b3": (64,), "b4": (64,), "b5": (1,)}
_TAIL_KEYS = ("w2", "b2", "w3", "b3", "w4", "b4", "w5", "b5")


def _check_folded(folded, keys, device):
    sd = folded["w2"].dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage dtype {sd} not supported (float32 | bfloat16)")
    for k in keys:
        t = folded[k]
        want = sd if k[0] == "w" else torch.float32
        if tuple(t.shape) != _SHAPES[k] or t.dtype != want or t.device != device:
            raise ValueError(f"folded[{k!r}] must be {_SHAPES[k]} {want} on {device}")
    return sd


def _check(U, ep, folded):
    sd = _check_folded(folded, ("b1", *_TAIL_KEYS), U.device)
    B, V, J = ep.shape
    if U.shape != (B, J, FEAT, 2 * FEAT) or U.dtype != sd:
        raise ValueError(f"U must be [{B}, {J}, {FEAT}, {2 * FEAT}] {sd}, got {tuple(U.shape)} {U.dtype}")
    if ep.dtype != torch.float32 or not 0 < J <= MAX_BASIS:
        raise ValueError(f"ep must be float32 with 1..{MAX_BASIS} basis columns")


def _check_y1(y1, folded):
    sd = _check_folded(folded, _TAIL_KEYS, y1.device)
    if y1.dim() != 4 or y1.shape[2:] != (FEAT, 2 * FEAT) or y1.dtype != sd:
        raise ValueError(f"y1 must be [B, V, {FEAT}, {2 * FEAT}] {sd}, got {tuple(y1.shape)} {y1.dtype}")


def _check_gates(latent, gates, folded):
    sd = _check_folded(folded, ("w1", "b1", *_TAIL_KEYS), latent.device)
    B = latent.shape[0]
    if latent.shape != (B, 2 * FEAT, FEAT) or latent.dtype != sd:
        raise ValueError(f"latent must be [B, {2 * FEAT}, {FEAT}] {sd}, got {tuple(latent.shape)} {latent.dtype}")
    if gates.dim() != 3 or gates.shape[0] != B or gates.shape[2] != 2 * FEAT or gates.dtype != torch.float32 \
            or gates.device != latent.device:
        raise ValueError(f"gates must be [{B}, V, {2 * FEAT}] float32 on {latent.device}, got "
                         f"{tuple(gates.shape)} {gates.dtype} on {gates.device}")


def _scratch(n: int, sd, dev):
    """The tail's planes h2 [n, 128, 256], h3 and h4 [n, 64, 512], and out [n, 512]."""
    return (torch.empty(n, FEAT, 2 * FEAT, dtype=sd, device=dev), torch.empty(n, 64, SEQ, dtype=sd, device=dev),
            torch.empty(n, 64, SEQ, dtype=sd, device=dev), torch.empty(n, SEQ, dtype=torch.float32, device=dev))


def _call(lib_name: str, entry: str, sd, tensors, ints) -> None:
    """Call `{entry}_{f32|bf16}(*pointers, *ints, stream)` of csrc/{lib_name}.cu
    on the tensors' device and current stream; raise on a failed launch."""
    lib = build.load(lib_name)
    fn = getattr(lib, f"{entry}_{'bf16' if sd == torch.bfloat16 else 'f32'}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], *ints, stream)
    if rc != 0:
        err = getattr(lib, f"{lib_name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{entry} launch failed: {err(rc).decode()} (cudaError {rc})")


def _launch(U, ep, b1, w2, b2, w3, b3, w4, b4, w5, b5) -> torch.Tensor:
    B, V, J = ep.shape
    h2, h3, h4, out = _scratch(B * V, w2.dtype, U.device)
    args = [t.contiguous() for t in (U, ep, b1, w2, b2, w3, b3, w4, b4, w5, b5)]
    _call("decoder_basis", "decoder_basis", w2.dtype, [*args, h2, h3, h4, out], [B, V, J])
    return out


@torch.library.custom_op("ecgpan_torch::decoder_basis", mutates_args=())
def _decoder_basis_op(U: torch.Tensor, ep: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor, w4: torch.Tensor,
                      b4: torch.Tensor, w5: torch.Tensor, b5: torch.Tensor) -> torch.Tensor:
    return _launch(U, ep, b1, w2, b2, w3, b3, w4, b4, w5, b5)


@torch.library.custom_op("ecgpan_torch::decoder_y1", mutates_args=())
def _decoder_y1_op(y1: torch.Tensor, tail: list[torch.Tensor]) -> torch.Tensor:
    """Kernel A6. `tail` in _TAIL_KEYS order; returns [B*V, 512]."""
    B, V = y1.shape[:2]
    h2, h3, h4, out = _scratch(B * V, y1.dtype, y1.device)
    args = [t.contiguous() for t in (y1, *tail)]
    _call("decoder_forms", "decoder_y1", y1.dtype, [*args, h2, h3, h4, out], [B * V])
    return out


@torch.library.custom_op("ecgpan_torch::decoder_gates", mutates_args=())
def _decoder_gates_op(latent: torch.Tensor, gates: torch.Tensor, head: list[torch.Tensor]) -> torch.Tensor:
    """Kernel A5 (and, in float32, A7). `head` is (w1, b1, *tail in
    _TAIL_KEYS order); returns [B*V, 512]."""
    B, V = gates.shape[:2]
    sd, dev = latent.dtype, latent.device
    y1 = torch.empty(B * V, FEAT, 2 * FEAT, dtype=sd, device=dev)
    h2, h3, h4, out = _scratch(B * V, sd, dev)
    args = [t.contiguous() for t in (latent, gates.to(sd).float(), *head)]
    _call("decoder_forms", "decoder_gates", sd, [*args, y1, h2, h3, h4, out], [B, V])
    return out


def _key(sd) -> str:
    return str(sd).removeprefix("torch.")


def decode_basis_cuda(U, ep, folded) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/decoder_basis.cu) on CUDA tensors."""
    if not U.is_cuda:
        raise ValueError("decode_basis_cuda needs CUDA tensors")
    _check(U, ep, folded)
    out = _decoder_basis_op(U, ep, *(folded[k] for k in ("b1", *_TAIL_KEYS)))
    LAUNCHES[_key(folded["w2"].dtype)] += 1
    return out.reshape(*ep.shape[:2], SEQ)


def decode_basis(U, ep, folded) -> torch.Tensor:
    """Mix + conv2..conv5 + sigmoid: [B, V, 512] f32. A CUDA tensor launches
    the kernel; a CPU tensor runs the plain version (the caller chose the
    CPU)."""
    if U.is_cuda:
        return decode_basis_cuda(U, ep, folded)
    _check(U, ep, folded)
    return decode_basis_plain(U, ep, folded)


def decode_y1_cuda(y1, folded) -> torch.Tensor:
    """Launch the y1 kernel (csrc/decoder_forms.cu) on CUDA tensors."""
    if not y1.is_cuda:
        raise ValueError("decode_y1_cuda needs CUDA tensors")
    _check_y1(y1, folded)
    out = _decoder_y1_op(y1, [folded[k] for k in _TAIL_KEYS])
    LAUNCHES[f"y1_{_key(y1.dtype)}"] += 1
    return out.reshape(*y1.shape[:2], SEQ)


def decode_y1(y1, folded) -> torch.Tensor:
    """conv2..conv5 + sigmoid on y1 [B, V, 128, 256]: [B, V, 512] f32. A CUDA
    tensor launches the kernel; a CPU tensor runs the plain version."""
    if y1.is_cuda:
        return decode_y1_cuda(y1, folded)
    _check_y1(y1, folded)
    return decode_y1_plain(y1, folded)


def decode_gates_cuda(latent, gates, folded) -> torch.Tensor:
    """Launch the gate kernel (csrc/decoder_forms.cu) on CUDA tensors."""
    if not latent.is_cuda:
        raise ValueError("decode_gates_cuda needs CUDA tensors")
    _check_gates(latent, gates, folded)
    out = _decoder_gates_op(latent, gates, [folded[k] for k in ("w1", "b1", *_TAIL_KEYS)])
    LAUNCHES[f"gates_{_key(latent.dtype)}"] += 1
    return out.reshape(*gates.shape[:2], SEQ)


def decode_gates(latent, gates, folded) -> torch.Tensor:
    """gate x latent, up x2, conv1..conv5, sigmoid: latent [B, 256, 128] in
    the storage dtype, gates [B, V, 256] f32 -> [B, V, 512] f32. A CUDA
    tensor launches the kernel; a CPU tensor runs the plain version."""
    if latent.is_cuda:
        return decode_gates_cuda(latent, gates, folded)
    _check_gates(latent, gates, folded)
    return decode_gates_plain(latent, gates, folded)


def fused_decode_views(folded: dict, latent_all, gates=None, *, enc=None, v_tile: int = 16,
                       head: str = "auto", plain: bool = False) -> torch.Tensor:
    """latent_all [B, 256, 128] -> [B, V, 512] f32. V pads up to a multiple of
    `v_tile` (zero gates or encodings) and the output is trimmed back, as the
    JAX package does. Exactly one view-conditioning form:

      * enc [B, V, J-1], the angular encodings (not gates): the basis path.
        Needs folded['A']. head 'stream', 'stream_scalar' and 'auto' all name
        the streamed-basis kernel A1 (the JAX package's two mix forms are one
        kernel here); 'y1' materializes y1 with `basis_y1` and runs the y1
        kernel A6, the audit form.
      * gates [B, V, 256] (`query_gates` output): the gate kernel A5, whose
        float32 instantiation is also the counterpart of the JAX package's
        float32 layout-A kernel A7.

    `plain=True` runs the plain version on any device (to hold the kernel
    against it)."""
    if (gates is None) == (enc is None):
        raise ValueError("pass exactly one of gates= or enc=")
    if v_tile <= 0:
        raise ValueError(f"v_tile must be positive, got {v_tile}")
    sd = folded["w2"].dtype
    views = enc if gates is None else gates
    B, V = views.shape[0], views.shape[1]
    pad = (-V) % v_tile
    if pad:
        views = torch.cat([views, views.new_zeros(B, pad, views.shape[2])], dim=1)

    if enc is not None:
        if "A" not in folded:
            raise ValueError("basis decode needs folded['A'] — re-fold with a params dict "
                             "containing mlp2.weight/mlp2.bias (fold_decoder_bn)")
        if head not in ("auto", "stream", "stream_scalar", "y1"):
            raise ValueError(f"unknown basis head {head!r}")
        if head == "y1":
            y1 = basis_y1(folded, latent_all, views)
            out = decode_y1_plain(y1, folded) if plain else decode_y1(y1, folded)
        else:
            U = basis_planes(folded, latent_all).to(sd)
            ep = basis_coeffs(views).to(sd).float()  # the mix coefficients round like U
            out = decode_basis_plain(U, ep, folded) if plain else decode_basis(U, ep, folded)
    else:
        latent, g = latent_all.to(sd), views.float()
        out = decode_gates_plain(latent, g, folded) if plain else decode_gates(latent, g, folded)
    return out[:, :V] if pad else out
