"""Signal transforms and legacy classification plotting helpers
(reference codes/utils/transform.py).

`scale_signal`/`Scale` min-max rescale a signal into a fixed range via
np.interp, `Compose` chains transforms, `to_array` replaces ToTensor. The
confusion-matrix / ROC plot helpers back the legacy classification path.
"""

from __future__ import annotations

import numpy as np


def scale_signal(signal: np.ndarray, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Per-signal min-max to [lo, hi] (reference transform.py Scale semantics)."""
    mn, mx = np.min(signal), np.max(signal)
    if mx == mn:
        return np.full_like(np.asarray(signal, dtype=np.float64), lo)
    return np.interp(signal, (mn, mx), (lo, hi))


class Scale:
    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi

    def __call__(self, x):
        return scale_signal(x, self.lo, self.hi)


def to_array(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


def plot_confusion_matrix(cm: np.ndarray, classes, path: str, normalize: bool = False,
                          title: str = "Confusion matrix") -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if normalize:
        cm = cm.astype(np.float64) / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(cm, interpolation="nearest", cmap="Blues")
    fig.colorbar(im)
    ax.set_xticks(range(len(classes)), labels=classes, rotation=45)
    ax.set_yticks(range(len(classes)), labels=classes)
    thresh = cm.max() / 2.0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            val = f"{cm[i, j]:.2f}" if normalize else f"{int(cm[i, j])}"
            ax.text(j, i, val, ha="center",
                    color="white" if cm[i, j] > thresh else "black")
    ax.set_title(title)
    ax.set_ylabel("True label")
    ax.set_xlabel("Predicted label")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_roc_curve(gt: np.ndarray, scores: np.ndarray, path: str) -> float:
    """Binary ROC plot; returns AUC."""
    from sklearn.metrics import auc, roc_curve

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fpr, tpr, _ = roc_curve(gt, scores)
    area = auc(fpr, tpr)
    fig, ax = plt.subplots()
    ax.plot(fpr, tpr, label=f"AUC = {area:.3f}")
    ax.plot([0, 1], [0, 1], linestyle="--", color="gray")
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend()
    fig.savefig(path)
    plt.close(fig)
    return float(area)
