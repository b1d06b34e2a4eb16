"""Compute ops of the port: convs, resampling, ROI ops, angular encoding, the
transformer's LayerNorm, GELU and attention (`ops.attention.attention`), and
the staging of a step's host arrays to the device (`ops.staging`)."""

from electrocardio_panorama_tpu_torch.ops.attention import ATTENTION, gelu, layer_norm
from electrocardio_panorama_tpu_torch.ops.convs import (
    MEASURED,
    batch_norm1d,
    conv1d,
    conv1d_measured,
    conv_transpose1d_k2s2,
    dropout,
    dropout_mask,
    full_f32,
    group_batch_norm1d,
    linear,
    max_pool1d,
)
from electrocardio_panorama_tpu_torch.ops.graphed import GRAPHED, GraphedTrain
from electrocardio_panorama_tpu_torch.ops.resample import upsample_linear_x2
from electrocardio_panorama_tpu_torch.ops.roi import roi_align_1d, roi_align_ramp, roi_pool_1d, roi_reverse_1d
from electrocardio_panorama_tpu_torch.ops.staging import STAGED, PinnedStaging
from electrocardio_panorama_tpu_torch.ops.theta import angular_encode, theta_feature_dim

__all__ = [
    "angular_encode",
    "theta_feature_dim",
    "conv1d",
    "conv1d_measured",
    "MEASURED",
    "GRAPHED",
    "GraphedTrain",
    "STAGED",
    "PinnedStaging",
    "ATTENTION",
    "gelu",
    "layer_norm",
    "conv_transpose1d_k2s2",
    "max_pool1d",
    "linear",
    "dropout",
    "dropout_mask",
    "batch_norm1d",
    "group_batch_norm1d",
    "full_f32",
    "upsample_linear_x2",
    "roi_align_1d",
    "roi_align_ramp",
    "roi_pool_1d",
    "roi_reverse_1d",
]
