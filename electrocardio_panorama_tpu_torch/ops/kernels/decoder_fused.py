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

The two other forms are audit paths beside it (`csrc/decoder_forms.cu`):

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

All three run the same convolution stages (`csrc/decoder_common.cuh`): on the
tensor cores in bfloat16 (`csrc/decoder_tc.cuh`), as float32 FMA otherwise
(`csrc/decoder_fma.cuh`). As in the TPU kernels, the x2 upsample before conv3
is folded into polyphase weights (`polyphase_matrices`), and the gate form
takes conv1's channel products before its upsample. The kernels read packed
layouts, which this module makes (`pack_chunked`, `pack_weights_tc`,
`pack_weights_fma`, `pack_tail`): bfloat16 planes lie in channel chunks of 8,
[C / 8, T, 8], so that a time step's 8 channels are one 16-byte row.

Storage dtype: the folded weights' dtype. bfloat16 stores U, the weights and
the activations in bf16, rounding where the TPU kernel rounds (U and the mix
coefficients, y1, the conv2 and conv3 outputs, the conv4 output as conv5's
operand; in the gate form the latent, the gate, their product and conv1's
per-tap channel products); all products and sums are float32, and the output
is float32. The plain versions round at the same places.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from electrocardio_panorama_tpu_torch.ops.convs import conv1d, full_f32
from electrocardio_panorama_tpu_torch.ops.kernels import build
from electrocardio_panorama_tpu_torch.ops.resample import upsample_linear_x2
from electrocardio_panorama_tpu_torch.utils.profiling import span

FEAT = 128
SEQ = 512
MAX_BASIS = 32  # csrc/decoder_common.cuh MAXJ
CHUNK = 8  # channels per 16-byte row of a bfloat16 plane

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


def polyphase_matrices(folded: dict):
    """The x2 upsample folded into conv3's weights (the JAX package's
    `polyphase_matrices`): with h = h2 (zero outside [0, 256)),

        h3[2k]   = A0 h[k-1] + A1 h[k] + A2 h[k+1]
        h3[2k+1] = B0 h[k-1] + B1 h[k] + B2 h[k+1]

    plus four edge corrections for the upsample's clamp: h3[0] += C0 h[0],
    h3[1] += C1 h[0], h3[510] += C2 h[255], h3[511] += C3 h[255]. Returns
    (ab3 [6, 64, 128] = A0..A2, B0..B2, c3 [4, 64, 128]) in the storage dtype:
    the combinations are formed in float32 from the folded w3 and rounded once."""
    w3 = folded["w3"].float()
    ab3 = torch.stack([
        0.75 * w3[0] + 0.25 * w3[1],
        0.25 * w3[0] + 0.75 * w3[1] + 0.75 * w3[2],
        0.25 * w3[2],
        0.25 * w3[0],
        0.75 * w3[0] + 0.75 * w3[1] + 0.25 * w3[2],
        0.25 * w3[1] + 0.75 * w3[2],
    ])
    c3 = torch.stack([0.25 * (w3[1] - w3[0]), 0.25 * w3[0], 0.25 * w3[2], 0.25 * (w3[1] - w3[2])])
    return ab3.to(folded["w3"].dtype), c3.to(folded["w3"].dtype)


def _upconv3_plain(h2, folded) -> torch.Tensor:
    """conv3 on up2(h2) in its polyphase form, before bias and ReLU:
    h2 [N, 128, 256] f32 -> [N, 64, 512] f32."""
    ab3, c3 = (m.float() for m in polyphase_matrices(folded))
    even = F.conv1d(h2, ab3[:3].permute(1, 2, 0), padding=1)
    odd = F.conv1d(h2, ab3[3:].permute(1, 2, 0), padding=1)
    first, last = h2[:, :, 0], h2[:, :, -1]
    even[:, :, 0] += first @ c3[0].t()
    odd[:, :, 0] += first @ c3[1].t()
    even[:, :, -1] += last @ c3[2].t()
    odd[:, :, -1] += last @ c3[3].t()
    return torch.stack([even, odd], dim=-1).reshape(h2.shape[0], 64, SEQ)


def _tail_plain(y1, folded) -> torch.Tensor:
    """conv2 .. conv5 + sigmoid in eager PyTorch on y1 [N, 128, 256] (float32
    values already rounded to the storage dtype) -> [N, 512] f32, rounding
    where the kernels round. Call inside `full_f32()`."""
    sd = folded["w2"].dtype

    def r(x):  # round to the storage dtype, compute on in float32
        return x.to(sd).float()

    h = r(torch.relu(_conv(y1, folded, 2)))
    h = r(torch.relu(_upconv3_plain(h, folded) + folded["b3"][:, None]))
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


def _shift_sum_up2(g) -> torch.Tensor:
    """sum_k up2(g[:, k])[t + k - 1] over the three taps k, zero outside
    [0, 2T): g [N, 3, C, T] -> [N, C, 2T]. conv1 on the upsampled input, with
    the channel product taken first at the low rate."""
    up = F.pad(upsample_linear_x2(g.flatten(0, 1)).reshape(*g.shape[:3], -1), (1, 1))
    n = up.shape[-1] - 2
    return up[:, 0, :, 0:n] + up[:, 1, :, 1:n + 1] + up[:, 2, :, 2:n + 2]


def decode_gates_plain(latent, gates, folded) -> torch.Tensor:
    """The gate kernel's function in eager PyTorch: latent [B, 256, 128] in
    the storage dtype, gates [B, V, 256] f32 -> [B, V, 512] f32. The gate
    rounds to the storage dtype, and so do its product with the latent and
    conv1's three per-tap channel products, which are taken before the
    upsample as in the TPU kernel."""
    sd = folded["w2"].dtype
    B, V = gates.shape[:2]
    with full_f32():
        x = (gates.to(sd)[..., None] * latent[:, None]).float().reshape(B * V, 2 * FEAT, FEAT)
        g = torch.einsum("kfc,nct->nkft", folded["w1"].float(), x).to(sd).float()
        y1 = torch.relu(_shift_sum_up2(g) + folded["b1"][:, None]).to(sd).float()
        return _tail_plain(y1, folded).reshape(B, V, SEQ)


def pack_chunked(x) -> torch.Tensor:
    """[..., C, T] -> [..., C / 8, T, 8]: channel chunks of 8, the 8 channels
    of one time step adjacent (element (c, t) at [c // 8, t, c % 8])."""
    *lead, C, T = x.shape
    return x.reshape(*lead, C // CHUNK, CHUNK, T).transpose(-1, -2).contiguous()


def unpack_chunked(p) -> torch.Tensor:
    """The inverse of `pack_chunked`: [..., C / 8, T, 8] -> [..., C, T]."""
    *lead, K, T, _ = p.shape
    return p.transpose(-1, -2).reshape(*lead, K * CHUNK, T)


def pack_weights_tc(w) -> torch.Tensor:
    """Tap-major weights [taps, N, Cin] -> [taps, Cin / 8, N, 8], the
    tensor-core stages' K-major operand: 8 input channels of one output
    channel are one 16-byte row (element (k, n, c) at [k, c // 8, n, c % 8])."""
    taps, N, Cin = w.shape
    return w.reshape(taps, N, Cin // CHUNK, CHUNK).permute(0, 2, 1, 3).contiguous()


def pack_weights_fma(w) -> torch.Tensor:
    """Tap-major weights [taps, N, Cin] -> [taps, Cin, N], the float32 stages'
    operand (output channels adjacent)."""
    return w.permute(0, 2, 1).contiguous()


def polyphase_order(sd, device=None):
    """(phase, co) of conv3's 128 packed output channels, as two index
    tensors. bfloat16: chunks of 8 channels alternate between the phases
    (n = 16 (co // 8) + 8 phase + co % 8), so a thread's channel pair stays
    inside one row of the chunked h3. float32: n = 2 co + phase, so a thread's
    8 packed channels are 8 adjacent output steps of 4 channels."""
    n = torch.arange(2 * 64, device=device)
    if sd == torch.bfloat16:
        return (n // CHUNK) % 2, (n // (2 * CHUNK)) * CHUNK + n % CHUNK
    return n % 2, n // 2


def pack_tail(folded: dict) -> list[torch.Tensor]:
    """conv2 .. conv5 as the kernels read them, in the order of the C entry
    points: w2, b2, w3 (polyphase, 128 packed output channels), b3 (in the
    packed order), the edge corrections [2, 128 n, 128 ci], w4, b4, w5
    [3, 64], b5."""
    sd = folded["w2"].dtype
    pack = pack_weights_tc if sd == torch.bfloat16 else pack_weights_fma
    ab3, c3 = polyphase_matrices(folded)
    phase, co = polyphase_order(sd, ab3.device)
    w3 = ab3.reshape(2, 3, 64, FEAT)[phase, :, co].transpose(0, 1)      # [3, 128 n, 128 ci]
    cedge = c3.reshape(2, 2, 64, FEAT)[:, phase, co]                    # [2, 128 n, 128 ci]
    return [pack(folded["w2"]), folded["b2"], pack(w3), folded["b3"][co].contiguous(), cedge.contiguous(),
            pack(folded["w4"]), folded["b4"], folded["w5"][:, 0].contiguous(), folded["b5"]]


_packed: collections.OrderedDict = collections.OrderedDict()


def _cached(fn, tensors):
    """fn(tensors), kept for the last few sets of (unchanged) tensors: the
    weights are packed once, not at every launch. The entry holds its source
    tensors, so their addresses are not reused while it lives."""
    key = (fn.__name__, *((t.data_ptr(), t._version, t.dtype) for t in tensors))
    if key not in _packed:
        _packed[key] = (fn(tensors), tensors)
        while len(_packed) > 8:
            _packed.popitem(last=False)
    _packed.move_to_end(key)
    return _packed[key][0]


def _pack_tail_list(tail):
    return pack_tail(dict(zip(_TAIL_KEYS, tail)))


def _pack_w1(w1):
    return (pack_weights_tc if w1[0].dtype == torch.bfloat16 else pack_weights_fma)(w1[0])


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
    """The tail's planes h2 [n, 128, 256] and h3 [n, 64, 512] (the kernels'
    own layouts), and out [n, 512]."""
    return (torch.empty(n, FEAT, 2 * FEAT, dtype=sd, device=dev), torch.empty(n, 64, SEQ, dtype=sd, device=dev),
            torch.empty(n, SEQ, dtype=torch.float32, device=dev))


def _call(lib_name: str, entry: str, sd, tensors, ints, stage_ms=None) -> None:
    """Call `{entry}_{f32|bf16}(*pointers, *ints, stage_ms, stream)` of
    csrc/{lib_name}.cu on the tensors' device and current stream; raise on a
    failed launch. `stage_ms`: a ctypes float array for the stages' times (the
    call then waits for the stream), else None."""
    lib = build.load(lib_name)
    fn = getattr(lib, f"{entry}_{'bf16' if sd == torch.bfloat16 else 'f32'}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p] * 2
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], *ints,
                None if stage_ms is None else ctypes.cast(stage_ms, ctypes.c_void_p), stream)
    if rc != 0:
        err = getattr(lib, f"{lib_name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{entry} launch failed: {err(rc).decode()} (cudaError {rc})")


def _run_basis(U, ep, b1, tail, stage_ms=None) -> torch.Tensor:
    """Kernel A1 on checked CUDA tensors; `tail` in _TAIL_KEYS order; [B*V, 512]."""
    B, V, J = ep.shape
    sd = tail[0].dtype
    if sd == torch.bfloat16:  # [B, 16, J, 256, 8]: a thread's loads over j are 16-byte rows
        U = pack_chunked(U).transpose(1, 2)
    h2, h3, out = _scratch(B * V, sd, U.device)
    _call("decoder_basis", "decoder_basis", sd,
          [U.contiguous(), ep.contiguous(), b1, *_cached(_pack_tail_list, tuple(tail)), h2, h3, out], [B, V, J],
          stage_ms)
    return out


def _run_y1(y1, tail, stage_ms=None) -> torch.Tensor:
    """Kernel A6 on checked CUDA tensors; [B*V, 512]."""
    n = y1.shape[0] * y1.shape[1]
    h2, h3, out = _scratch(n, y1.dtype, y1.device)
    _call("decoder_forms", "decoder_y1", y1.dtype,
          [y1.contiguous(), *_cached(_pack_tail_list, tuple(tail)), h2, h3, out], [n], stage_ms)
    return out


def _run_gates(latent, gates, head, stage_ms=None) -> torch.Tensor:
    """Kernel A5 / A7 on checked CUDA tensors; `head` is (w1, b1, *tail); [B*V, 512]."""
    B, V = gates.shape[:2]
    sd, dev = latent.dtype, latent.device
    g = torch.empty(B * V, 3, FEAT, FEAT, dtype=sd, device=dev)  # conv1's per-tap products
    h2, h3, out = _scratch(B * V, sd, dev)
    lat = pack_chunked(latent) if sd == torch.bfloat16 else latent.contiguous()
    _call("decoder_forms", "decoder_gates", sd,
          [lat, gates.to(sd).float().contiguous(), _cached(_pack_w1, (head[0],)), head[1], g,
           *_cached(_pack_tail_list, tuple(head[2:])), h2, h3, out], [B, V], stage_ms)
    return out


@torch.library.custom_op("ecgpan_torch::decoder_basis", mutates_args=())
def _decoder_basis_op(U: torch.Tensor, ep: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor, w4: torch.Tensor,
                      b4: torch.Tensor, w5: torch.Tensor, b5: torch.Tensor) -> torch.Tensor:
    """Kernel A1; returns [B*V, 512]."""
    return _run_basis(U, ep, b1, (w2, b2, w3, b3, w4, b4, w5, b5))


@torch.library.custom_op("ecgpan_torch::decoder_y1", mutates_args=())
def _decoder_y1_op(y1: torch.Tensor, tail: list[torch.Tensor]) -> torch.Tensor:
    """Kernel A6. `tail` in _TAIL_KEYS order; returns [B*V, 512]."""
    return _run_y1(y1, tail)


@torch.library.custom_op("ecgpan_torch::decoder_gates", mutates_args=())
def _decoder_gates_op(latent: torch.Tensor, gates: torch.Tensor, head: list[torch.Tensor]) -> torch.Tensor:
    """Kernel A5 (and, in float32, A7). `head` is (w1, b1, *tail in
    _TAIL_KEYS order); returns [B*V, 512]."""
    return _run_gates(latent, gates, head)


# the stages of each form, in launch order, with the multiply-adds per view
# that each one's products take
STAGES = {
    "basis": (("mix+conv2", 128 * 128 * 3 * 256), ("conv3", 128 * 128 * 3 * 256), ("conv4+conv5", 64 * 64 * 3 * 512)),
    "y1": (("conv2", 128 * 128 * 3 * 256), ("conv3", 128 * 128 * 3 * 256), ("conv4+conv5", 64 * 64 * 3 * 512)),
    "gates": (("gate+conv1", 3 * 128 * 256 * 128), ("up+conv2", 128 * 128 * 3 * 256),
              ("conv3", 128 * 128 * 3 * 256), ("conv4+conv5", 64 * 64 * 3 * 512)),
}


def stage_smem_bytes(sd) -> dict[str, int]:
    """Dynamic shared memory of one block of each stage kernel (builds the
    library if needed): {"gate+conv1": bytes, "conv2": .., "conv3": ..,
    "conv4+conv5": ..}."""
    fn = build.load("decoder_forms").decoder_stage_smem_bytes
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
    return {name: fn(int(sd == torch.bfloat16), i)
            for i, name in enumerate(("gate+conv1", "conv2", "conv3", "conv4+conv5"))}


def decode_stage_ms(form: str, folded: dict, *inputs) -> dict[str, float]:
    """One launch of a form's kernel chain on CUDA tensors with every stage
    timed by CUDA events inside the call: {stage: ms} in STAGES[form] order.
    `inputs` as for decode_basis (U, ep), decode_y1 (y1) or decode_gates
    (latent, gates). A measurement, not counted in LAUNCHES."""
    if not inputs[0].is_cuda:
        raise ValueError("decode_stage_ms needs CUDA tensors")
    ms = (ctypes.c_float * len(STAGES[form]))()
    tail = [folded[k] for k in _TAIL_KEYS]
    if form == "basis":
        _check(*inputs, folded)
        _run_basis(*inputs, folded["b1"], tail, ms)
    elif form == "y1":
        _check_y1(*inputs, folded)
        _run_y1(*inputs, tail, ms)
    else:
        _check_gates(*inputs, folded)
        _run_gates(*inputs, [folded["w1"], folded["b1"], *tail], ms)
    return {name: float(t) for (name, _), t in zip(STAGES[form], ms)}


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
            with span("ecgpan.basis_planes", device=latent_all.device):
                U = basis_planes(folded, latent_all).to(sd)
                ep = basis_coeffs(views).to(sd).float()  # the mix coefficients round like U
            out = decode_basis_plain(U, ep, folded) if plain else decode_basis(U, ep, folded)
    else:
        latent, g = latent_all.to(sd), views.float()
        out = decode_gates_plain(latent, g, folded) if plain else decode_gates(latent, g, folded)
    return out[:, :V] if pad else out
