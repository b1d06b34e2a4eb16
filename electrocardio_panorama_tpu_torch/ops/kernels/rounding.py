"""Storage-dtype rounding for the kernels' plain versions: the values stay
float32, rounded where a kernel with bfloat16 storage rounds them, so that
autograd through the plain version gives the kernel's gradient."""

from __future__ import annotations

import torch


class Round(torch.autograd.Function):
    """Round to `dtype` in the forward (the value stays float32); the
    gradient passes through."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GradRound(torch.autograd.Function):
    """The identity in the forward; rounds the gradient to `dtype`: a
    gradient that enters a product as an operand."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None
