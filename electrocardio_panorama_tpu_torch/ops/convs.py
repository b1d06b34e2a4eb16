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

import contextlib

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


def dropout(x, rate: float, generator: torch.Generator | None, train: bool):
    """Inverted dropout; an identity at eval, which is all this slice runs."""
    if not train or rate == 0.0 or generator is None:
        return x
    raise NotImplementedError("train-mode dropout lands with the training slice (ROADMAP.md Queue A item 6)")


def batch_norm1d(x, scale, offset, running_mean, running_var, *, eps: float = 1e-5):
    """Eval-mode BatchNorm1d on [B, C, L] with the running statistics."""
    inv = torch.rsqrt(running_var + eps)
    return (x - running_mean[None, :, None]) * (inv * scale)[None, :, None] + offset[None, :, None]
