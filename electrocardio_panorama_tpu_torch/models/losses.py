"""Standin-Learning losses (reference codes/network/loss/losses.py).

loss1/loss2 are the self-supervision terms: L1 between the prediction,
detached as `input0.detach()` is at losses.py:17, and the standin-shuffled
decodes. loss3 is the supervised regression term (L1 or MSE per
SOLVER.reg_loss). Weighted by SOLVER.loss_factor and gated by
SOLVER.loss_using as losswrapper does (losses.py:37-45). torch.abs has the
subgradient 0 at 0 that the JAX package rebuilds by hand (its `_abs_torch`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def mse(a, b):
    return torch.mean(torch.square(a - b))


def standin_l1(pred, shuffled):
    """OurLoss1: L1 with the prediction side detached (losses.py:10-18)."""
    return l1(pred.detach(), shuffled)


def loss_wrapper(predict, predict_shuffle_p, predict_shuffle_l, target, cfg, rest_out=None,
                 rest_view=None, loss1_gt=None, loss2_gt=None):
    """`losswrapper` (losses.py:21-50): (loss, loss1*f0, loss2*f1, loss3*f2),
    plus the unsupervised regression term when rest tensors are given."""
    reg = {"l2_loss": mse, "l1_loss": l1}[cfg.SOLVER.reg_loss]
    loss1_gt = predict if loss1_gt is None else loss1_gt
    loss2_gt = predict if loss2_gt is None else loss2_gt

    using = cfg.SOLVER.loss_using
    zero = predict.new_zeros(())
    loss1 = standin_l1(loss1_gt, predict_shuffle_p) if 1 in using else zero
    loss2 = standin_l1(loss2_gt, predict_shuffle_l) if 2 in using else zero
    loss3 = reg(predict, target) if 3 in using else zero

    f = cfg.SOLVER.loss_factor
    loss = loss1 * f[0] + loss2 * f[1] + loss3 * f[2]
    if rest_out is not None and rest_view is not None:
        return loss, loss1 * f[0], loss2 * f[1], loss3 * f[2], reg(rest_out, rest_view)
    return loss, loss1 * f[0], loss2 * f[1], loss3 * f[2]


def mse_per_lead(pred, target):
    """MSELead (losses.py:53-64): the mean of the per-lead MSEs."""
    return torch.mean(torch.mean(torch.square(pred - target), dim=(0, 2)))


def bce(probs, labels):
    """The classifier's loss (MODEL.loss 'bce'): the mean binary
    cross-entropy of the sigmoid scores `probs` [B, C] against the multi-hot
    `labels` [B, C]. The reference defines no loss for its classifier
    (resnet_1d.py ends in a sigmoid); this one is assumed."""
    return F.binary_cross_entropy(probs, labels.to(probs.dtype))
