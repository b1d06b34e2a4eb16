"""1-D convolution primitives with the JAX package's signatures (eval subset).

Weights keep torch layouts, so reference checkpoints apply directly:
conv1d [O, I/groups, K], conv_transpose1d [I, O/groups, K], linear [out, in].

float32 work runs at full float32 on the card. PyTorch lets cuDNN run a
float32 convolution in TF32 by default (`torch.backends.cudnn.allow_tf32`),
which keeps about three decimal digits — the GPU form of the TPU's
default-precision trap. Every float32 op here runs inside `full_f32()`,
which pins TF32 off for the op and restores the process-wide flags after.
"""

from __future__ import annotations

import collections
import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32():
    """Disable TF32 for cuDNN convolutions and CUDA matmuls inside the block."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def precise(x: torch.Tensor):
    """`full_f32()` for a float32 CUDA tensor, else a no-op context."""
    if x.is_cuda and x.dtype == torch.float32:
        return full_f32()
    return contextlib.nullcontext()


def conv1d(x, weight, bias=None, *, stride: int = 1, padding: int = 0, groups: int = 1):
    """x [B, C_in, L], weight [C_out, C_in/groups, K]."""
    with precise(x):
        return F.conv1d(x, weight, bias, stride=stride, padding=padding, groups=groups)


# calls through conv1d_measured ("fwd", "bwd"), and the distinct CUDA keys
# cuDNN measured once each ("shapes": pass, shapes, stride, padding, groups,
# dtype, device; the passes are fwd, dgrad and wgrad, cuDNN's three searches)
MEASURED: collections.Counter = collections.Counter()
_MEASURED_KEYS: set = set()

# The most memory the process may add while cuDNN measures a new key. Its
# find sizes one trial workspace to the largest candidate plan's, GiBs for
# the FFT plans at Nef-Net2's shapes, bounded only by the device's free
# memory; when that allocation fails it halves it and drops the plans that
# need more. The cap keeps the trials from raising the peak memory.
FIND_HEADROOM_BYTES = 1 << 30


@contextlib.contextmanager
def _find_headroom(device: torch.device):
    """The per-process memory fraction held at what the process has reserved
    plus FIND_HEADROOM_BYTES inside the block, restored on exit."""
    saved = torch.cuda.get_per_process_memory_fraction(device)
    total = torch.cuda.get_device_properties(device).total_memory
    cap = (torch.cuda.memory_reserved(device) + FIND_HEADROOM_BYTES) / total
    torch.cuda.set_per_process_memory_fraction(min(cap, saved), device)
    try:
        yield
    finally:
        torch.cuda.set_per_process_memory_fraction(saved, device)


@contextlib.contextmanager
def _measured(x: torch.Tensor, new_key: bool):
    """cuDNN's find mode (`cudnn.benchmark`) inside the block, TF32 off as
    `precise(x)` holds it, and for a key cuDNN has not measured yet the
    memory its trials may take capped (`_find_headroom`); all restored on
    exit."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        with precise(x), (_find_headroom(x.device) if new_key else contextlib.nullcontext()):
            yield
    finally:
        torch.backends.cudnn.benchmark = saved


def _first_sight(passes, x, weight, stride, padding, groups) -> bool:
    """Records the CUDA keys of `passes`; True if any is new."""
    new = False
    if x.is_cuda:
        for pass_ in passes:
            key = (pass_, tuple(x.shape), tuple(weight.shape), stride, padding, groups, x.dtype, x.device)
            if key not in _MEASURED_KEYS:
                _MEASURED_KEYS.add(key)
                MEASURED["shapes"] += 1
                new = True
    return new


class _MeasuredConv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, groups, bias is not None)
        MEASURED["fwd"] += 1
        with _measured(x, _first_sight(["fwd"], x, weight, stride, padding, groups)):
            return F.conv1d(x, weight, bias, stride=stride, padding=padding, groups=groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, groups, has_bias = ctx.conv
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], has_bias and ctx.needs_input_grad[2]]
        MEASURED["bwd"] += 1
        passes = [p for p, needed in (("dgrad", mask[0]), ("wgrad", mask[1])) if needed]
        with _measured(x, _first_sight(passes, x, weight, stride, padding, groups)):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None, [stride], [padding], [1], False,
                [0], groups, mask)
        return gx, gw, gb, None, None, None


def conv1d_measured(x, weight, bias=None, *, stride: int = 1, padding: int = 0, groups: int = 1):
    """`conv1d` with cuDNN's algorithm chosen by measurement, once per shape,
    for the forward and both gradients (`cudnn.benchmark` set around each),
    where `conv1d` takes the heuristic's choice: for short 128-channel f32
    convolutions with TF32 off that is an FFT path many times slower than a
    direct engine. The same result on the CPU, bit for bit."""
    return _MeasuredConv1d.apply(x, weight, bias, stride, padding, groups)


def conv_transpose1d_k2s2(x, weight, bias=None, *, groups: int = 1):
    """ConvTranspose1d(kernel=2, stride=2), the z2 morphology upsampler
    (reference model_nefnet.py:96-97). weight [C_in, C_out/groups, 2]."""
    assert weight.shape[2] == 2, "specialized for kernel_size=2, stride=2"
    with precise(x):
        return F.conv_transpose1d(x, weight, bias, stride=2, groups=groups)


def max_pool1d(x, *, kernel: int = 3, stride: int = 2, padding: int = 1):
    return F.max_pool1d(x, kernel_size=kernel, stride=stride, padding=padding)


def linear(x, weight, bias=None):
    """torch.nn.Linear: weight [out, in]."""
    with precise(x):
        return F.linear(x, weight, bias)


def dropout_mask(shape, rate: float, generator: torch.Generator, *, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Pre-scaled inverted-dropout mask: 0 with probability `rate`, else
    1/(1-rate) rounded to `dtype`, drawn from `generator` (which fixes the
    device). The scale is a Python float, rounded to `dtype` on the host: a
    multiply by it copies nothing to the device, so drawing a mask never
    waits for the card."""
    keep = 1.0 - rate
    u = torch.rand(shape, generator=generator, device=device or generator.device)
    return (u < keep).to(dtype) * torch.tensor(1.0 / keep, dtype=dtype).item()


def dropout(x, rate: float, mask: torch.Tensor | None, train: bool):
    """Inverted dropout with an explicit pre-scaled mask (`dropout_mask`);
    the identity at eval or without a mask. The product rounds to x's dtype,
    as the JAX package's `x * mask` does."""
    if not train or rate == 0.0 or mask is None:
        return x
    return x * mask.to(x.dtype)


def _batch_moments(x, dims, sync):
    """(mean, biased variance, count) of x over `dims`, in x's dtype. With
    `sync` (parallel.sharding.BatchStatSync) the sums and sums of squares,
    taken in float32, are summed over the ranks first: the moments of the
    global batch, as the JAX package's `axis_name` gives them."""
    n = math.prod(x.shape[d] for d in dims)
    if sync is None:
        return x.mean(dim=dims), x.var(dim=dims, unbiased=False), n
    xf = x.float()
    s = sync(torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]))
    n *= sync.size
    mean = s[0] / n
    return mean.to(x.dtype), (s[1] / n - mean * mean).to(x.dtype), n


def batch_norm1d(x, scale, offset, running_mean, running_var, *, train: bool = False,
                 momentum: float = 0.1, eps: float = 1e-5, sync=None):
    """torch BatchNorm1d on [B, C, L]. Eval: normalizes with the running
    statistics and returns the output. Train: normalizes with the biased batch
    statistics over (B, L), over every rank's batch under `sync`
    (`_batch_moments`), and returns (out, new_running_mean,
    new_running_var); the running variance takes the unbiased variance."""
    if not train:
        inv = torch.rsqrt(running_var + eps)
        return (x - running_mean[None, :, None]) * (inv * scale)[None, :, None] + offset[None, :, None]
    mean, var, n = _batch_moments(x, (0, 2), sync)
    unbiased = var * n / max(n - 1, 1)
    new_mean = (1 - momentum) * running_mean + momentum * mean.detach()
    new_var = (1 - momentum) * running_var + momentum * unbiased.detach()
    inv = torch.rsqrt(var + eps)
    out = (x - mean[None, :, None]) * (inv * scale)[None, :, None] + offset[None, :, None]
    return out, new_mean, new_var


def group_batch_norm1d(x, scale, offset, running_mean, running_var, *, groups: int,
                       momentum: float = 0.1, eps: float = 1e-5, sync=None):
    """`groups` train-mode BatchNorm1d calls batched into one op: x is
    group-major [G*B, C, L]; group g normalizes with its own biased batch
    statistics (over every rank's batch under `sync`), and the running
    statistics take the G sequential EMA updates in closed form,
    r_G = (1-m)^G r_0 + m * sum_g (1-m)^(G-1-g) stat_g, in the reference's
    order. Returns (out, new_running_mean, new_running_var)."""
    gb, c, L = x.shape
    b = gb // groups
    xg = x.reshape(groups, b, c, L)
    mean, var, n = _batch_moments(xg, (1, 3), sync)  # [G, C]
    unbiased = var * n / max(n - 1, 1)
    keep = (1 - momentum) ** groups
    w = momentum * (1 - momentum) ** torch.arange(groups - 1, -1, -1, dtype=var.dtype, device=x.device)
    new_mean = keep * running_mean + torch.tensordot(w, mean.detach(), dims=1)
    new_var = keep * running_var + torch.tensordot(w, unbiased.detach(), dims=1)
    inv = torch.rsqrt(var + eps)
    out = (xg - mean[:, None, :, None]) * (inv * scale[None])[:, None, :, None] \
        + offset[None, None, :, None]
    return out.reshape(gb, c, L), new_mean, new_var
