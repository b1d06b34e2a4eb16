"""Evaluation metrics with reference parity (the JAX package's
training/metrics.py).

PSNR (reference utils/mertic.py:7-21): per-(sample, lead) RMSE over the
real-signal region [0 : rois[i, -1, 0]], 20*log10(1/rmse), 100 if rmse == 0.
SSIM (utils/mertic.py:24-32): skimage structural_similarity on the same
region with data_range 1: 1-D, win 7, uniform filter, K1 0.01 / K2 0.03,
borders cropped by (win-1)//2, sample covariance N/(N-1).

`psnr_values` / `ssim_values` run on the tensors' device inside the eval
step; the numpy `psnr`, `ssim_1d` and `ssim` are the float64 oracles.

The classifier's eval (model_resnet1d) reads the micro-averaged F1 at a
threshold of 0.5 (`multilabel_counts`, `micro_f1`). The reference defines
no eval metric for its classifier; this one is assumed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from electrocardio_panorama_tpu_torch.ops.convs import precise

_WIN = 7
_K1, _K2 = 0.01, 0.03


def psnr(pred: np.ndarray, gt: np.ndarray, rois: np.ndarray | None = None) -> float:
    """pred/gt: [B, L, T]; rois: [B, 7, 2] or None (full length)."""
    vals = []
    for i in range(pred.shape[0]):
        end = int(rois[i, -1, 0]) if rois is not None else pred.shape[2]
        for j in range(pred.shape[1]):
            diff = pred[i, j, :end] - gt[i, j, :end]
            rmse = float(np.sqrt(np.mean(diff**2)))
            vals.append(100.0 if rmse == 0 else 20 * np.log10(1.0 / rmse))
    return float(np.mean(vals))


def ssim_1d(x: np.ndarray, y: np.ndarray, data_range: float = 1.0) -> float:
    """skimage structural_similarity parity for 1-D float inputs."""
    from scipy.ndimage import uniform_filter

    x = x.astype(np.float64)
    y = y.astype(np.float64)
    cov_norm = _WIN / (_WIN - 1)
    ux, uy = uniform_filter(x, _WIN), uniform_filter(y, _WIN)
    uxx, uyy, uxy = uniform_filter(x * x, _WIN), uniform_filter(y * y, _WIN), uniform_filter(x * y, _WIN)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (_K1 * data_range) ** 2
    c2 = (_K2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (_WIN - 1) // 2
    return float(s[pad:-pad].mean())


def ssim(pred: np.ndarray, gt: np.ndarray, rois: np.ndarray | None = None) -> float:
    """Reference SSIM wrapper (mertic.py:24-32): mean over (sample, lead)."""
    vals = []
    for i in range(pred.shape[0]):
        end = int(rois[i, -1, 0]) if rois is not None else pred.shape[2]
        for j in range(pred.shape[1]):
            vals.append(ssim_1d(pred[i, j, :end], gt[i, j, :end], data_range=1.0))
    return float(np.mean(vals))


def psnr_values(pred: torch.Tensor, gt: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """Per-(sample, lead) PSNR over [0 : rois[:, -1, 0]]: pred/gt [B, L, T]
    -> [B, L]. rmse 0 maps to 100. Rois full of large sentinels select the
    whole sequence (the end clamps to T)."""
    B, L, T = pred.shape
    end = torch.clamp(rois[:, -1, 0].to(pred.dtype), max=T)  # [B]
    mask = (torch.arange(T, device=pred.device)[None, :] < end[:, None]).to(pred.dtype)
    mse = (torch.square(pred - gt) * mask[:, None, :]).sum(dim=2) / torch.clamp(end[:, None], min=1)
    rmse = torch.sqrt(mse)
    return torch.where(rmse == 0, torch.full_like(rmse, 100.0),
                       20 * torch.log10(1.0 / torch.clamp(rmse, min=1e-30)))


def psnr_masked(pred, gt, rois) -> torch.Tensor:
    """Scalar mean of psnr_values: the reference PSNR() contract."""
    return psnr_values(pred, gt, rois).mean()


def ssim_values(pred: torch.Tensor, gt: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """Per-(sample, lead) SSIM over [0 : rois[:, -1, 0]]: the skimage
    algorithm as one grouped ones-kernel convolution of the five moment
    inputs and a masked mean, in float32 (agrees with the float64 oracle to
    about 1e-4). pred/gt [B, L, T] -> [B, L]. Positions whose 7-window
    crosses the region's end are excluded as skimage's crop excludes them."""
    B, L, T = pred.shape
    end = torch.clamp(rois[:, -1, 0], max=T).to(torch.int64)  # [B]
    x = pred.reshape(B * L, T).float()
    y = gt.reshape(B * L, T).float()
    stack = torch.stack([x, y, x * x, y * y, x * y], dim=1)  # [B*L, 5, T]
    kernel = torch.full((5, 1, _WIN), 1.0 / _WIN, dtype=torch.float32, device=pred.device)
    with precise(stack):  # full float32: the uxx - ux^2 cancellation needs it
        u = F.conv1d(stack, kernel, padding=_WIN // 2, groups=5)
    ux, uy, uxx, uyy, uxy = u.unbind(dim=1)
    cov_norm = _WIN / (_WIN - 1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1, c2 = _K1 * _K1, _K2 * _K2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (_WIN - 1) // 2
    pos = torch.arange(T, device=pred.device)[None, :]
    valid = ((pos >= pad) & (pos <= end[:, None] - pad - 1)).float()  # [B, T]
    count = torch.clamp(end - 2 * pad, min=1).float()
    return (s.reshape(B, L, T) * valid[:, None, :]).sum(dim=2) / count[:, None]


def ssim_masked(pred, gt, rois) -> torch.Tensor:
    """Scalar mean of ssim_values: the reference SSIM() contract."""
    return ssim_values(pred, gt, rois).mean()


def multilabel_counts(probs: torch.Tensor, labels: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """[tp, fp, fn] of multi-label scores `probs` [B, C] against the multi-hot
    `labels` [B, C], a class predicted where its score reaches `threshold`,
    summed over every record and class (float32, on the tensors' device)."""
    pred = probs >= threshold
    truth = labels > 0.5
    return torch.stack([(pred & truth).sum(), (pred & ~truth).sum(), (~pred & truth).sum()]).float()


def micro_f1(counts):
    """Micro-averaged F1 from [tp, fp, fn] (`multilabel_counts`, a tensor or
    an array, summed over any number of batches): 2 tp / (2 tp + fp + fn), 0
    where all three are 0."""
    tp, fp, fn = counts[0], counts[1], counts[2]
    den = 2 * tp + fp + fn
    return 2 * tp / (den + (den == 0))


def compute_clf_metrics(pred_probs: np.ndarray, gt_labels: np.ndarray, target_label: int = -1) -> dict:
    """Classification metric suite (reference utils/mertic.py:35-69):
    per-class PR-AUC, accuracy, per-class precision/recall. pred_probs
    [N, n_classes] probabilities; gt_labels [N] int class ids."""
    from sklearn.metrics import accuracy_score, auc, precision_recall_curve, precision_score, recall_score

    pr_auc_list = []
    target_recall = target_precision = None
    for label in np.sort(np.unique(gt_labels)):
        precision, recall, _ = precision_recall_curve(np.where(gt_labels == label, 1, 0), pred_probs[:, label])
        pr_auc_list.append(auc(recall, precision))
        if label == target_label:
            target_recall, target_precision = recall, precision
    pred_ids = np.argmax(pred_probs, axis=1)
    precision = precision_score(gt_labels, pred_ids, average=None, zero_division=0)
    recall = recall_score(gt_labels, pred_ids, average=None, zero_division=0)
    return {
        "mean_auc": float(np.mean(pr_auc_list)),
        "acc": float(accuracy_score(gt_labels, pred_ids)),
        "per_class_auc": [float(a) for a in pr_auc_list],
        "target_recall_points": target_recall,
        "target_precision_points": target_precision,
        "target_recall": float(recall[target_label]) if target_label >= 0 else None,
        "target_precision": float(precision[target_label]) if target_label >= 0 else None,
    }
