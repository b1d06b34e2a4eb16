"""Angular Encoding of ECG viewpoint angles (reference
codes/network/utils/theta_encoder.py:13-29).

(theta, phi) per lead expands to the features [theta, phi, theta+phi,
theta-phi], each interleaved as [f, sin(omega*f), cos(omega*f)] — the
reference's `torch.stack(out_all, dim=-1).view(b, lead, -1)` order.
"""

from __future__ import annotations

import torch


def angular_encode(theta: torch.Tensor, encoder_len: int = 1, omega: float = 1.0) -> torch.Tensor:
    """[..., 2] -> [..., (2*encoder_len+1)*4]. For encoder_len=1 the 12
    features are [t, sin t, cos t, p, sin p, cos p, t+p, sin(t+p), cos(t+p),
    t-p, sin(t-p), cos(t-p)]."""
    t = theta[..., 0:1]
    p = theta[..., 1:2]
    feats = torch.cat([t, p, t + p, t - p], dim=-1)  # [..., 4]
    bands = [feats]
    for k in range(encoder_len):
        w = omega * (k + 1)
        bands.append(torch.sin(feats * w))
        bands.append(torch.cos(feats * w))
    out = torch.stack(bands, dim=-1)  # [..., 4, 2*encoder_len+1]
    return out.reshape(*theta.shape[:-1], -1)


def theta_feature_dim(encoder_len: int = 1) -> int:
    return (2 * encoder_len + 1) * 4
