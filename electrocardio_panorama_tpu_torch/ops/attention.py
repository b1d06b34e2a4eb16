"""The transformer's ops: LayerNorm, the exact GELU and one softmax
attention, each in float32 at full precision on the card (TF32 off, as
ops/convs.py keeps it for convolutions and matmuls).

`attention(q, k, v, scale)` takes q, k, v [B, H, N, D] and returns
softmax(q kᵀ · scale) v [B, H, N, D]. Its plain form is two matmuls and a
softmax; the scale is applied to q before the first matmul, which for a
power of two (ST-MEM's 1/8) is bitwise the same as scaling the scores. On a
CUDA tensor it runs `F.scaled_dot_product_attention` instead where the
backend PyTorch's dispatcher picks for the call is in `SDPA_BACKENDS`: the
backends read on the card to keep the float32 cell within its limits where
the TF32 control fails them (PERF.md). Such a call is pinned to that
backend, so that the counter names what ran. Every other call, and every
call on the CPU, runs the plain form.

ATTENTION counts the calls by the form that ran ("plain", or "sdpa.<backend>"
in lower case) and the query tokens they took ("tokens": B x N a call).
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from electrocardio_panorama_tpu_torch.ops.convs import precise

# SDPA's backends that run on the card in place of the plain form, by
# torch.nn.attention.SDPBackend name. The memory-efficient backend, which the
# dispatcher picks for float32 q, k, v [128, 12, 384, 64] on the H100, reads
# 6e-7 to 8e-7 from a float64 attention where the plain form reads 4.5e-7
# and TF32 4e-4 to 5e-4 (output and the three gradients, relative L2); in
# the ViT's cell its gaps from the plain reference stay at 1/700 of the TF32
# control's (PERF.md, section 6)
SDPA_BACKENDS: tuple[str, ...] = ("EFFICIENT_ATTENTION",)

ATTENTION: collections.Counter = collections.Counter()


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """torch.nn.LayerNorm over the last dim."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def gelu(x):
    """The exact GELU, x Φ(x) (torch.nn.GELU's default, the erf form)."""
    return F.gelu(x)


def attention_plain(q, k, v, scale: float):
    """softmax(q kᵀ · scale) v as two matmuls and a softmax."""
    with precise(q):
        return torch.matmul(torch.softmax(torch.matmul(q * scale, k.transpose(-2, -1)), dim=-1), v)


def sdpa_backend(q, k, v, scale: float) -> str:
    """The backend `F.scaled_dot_product_attention` would take for this call
    (lower case; 'math' is its plain path)."""
    from torch.nn.attention import SDPBackend

    names = {int(b): name.lower() for name, b in SDPBackend.__members__.items()}
    return names[int(torch._fused_sdp_choice(q, k, v, None, 0.0, False, scale=scale))]


def attention(q, k, v, scale: float):
    """softmax(q kᵀ · scale) v, q, k, v [B, H, N, D]: SDPA on the card where
    its backend is one of SDPA_BACKENDS, else the plain form."""
    ATTENTION["tokens"] += q.shape[0] * q.shape[2]
    if q.is_cuda and SDPA_BACKENDS:
        backend = sdpa_backend(q, k, v, scale)
        if backend.upper() in SDPA_BACKENDS:
            from torch.nn.attention import SDPBackend, sdpa_kernel

            ATTENTION[f"sdpa.{backend}"] += 1
            with precise(q), sdpa_kernel(getattr(SDPBackend, backend.upper())):
                return F.scaled_dot_product_attention(q, k, v, scale=scale)
    ATTENTION["plain"] += 1
    return attention_plain(q, k, v, scale)
