"""1-D ROI ops over the 7 contiguous heartbeat segments, as batched tensor ops.

The reference loops over batch and ROI around `F.grid_sample` and
`F.interpolate` (codes/network/utils/roi_pooling_1d.py:38-99). Here:

* `roi_align_1d` reproduces the reference `roi_algin` as executed: it feeds
  `grid_sample` a [B, C, L, 1] tensor with the ROI coordinates on the width-1
  axis, so the sampled value is the time-axis midpoint 0.5*(x[L/2-1] +
  x[L/2]) scaled by the zero-padding bilinear weight (1 - |x|/2) of the ROI
  ramp. That closed form is one add and one outer product.
* `roi_reverse_1d` reproduces `roi_pooling_reverse`: each segment is linearly
  resampled (half-pixel) from its S=32 grid back to its true length
  floor(e*s) - floor(s*s), and the segments concatenate along time. The
  resample is a batched matmul against a per-beat lerp matrix [R*S, T] with
  two non-zeros per column, so it needs no gather or scatter (whose CUDA
  backward would use atomics).
* `roi_pool_1d` reproduces the reference `roi_pooling` (unused by Nef-Net).
"""

from __future__ import annotations

import torch

from electrocardio_panorama_tpu_torch.ops.convs import precise


def roi_align_ramp(rois, *, size: int = 16, spatial_scale: float = 128 / 512, feat_len: int = 128):
    """[B, R, 2] -> [B, R, size] f32: the bilinear weight of the ROI grid."""
    c = rois.to(torch.float32) * (spatial_scale * 2.0 / feat_len) - 1.0
    frac = torch.arange(size, dtype=torch.float32, device=rois.device) / (size - 1)
    grid = c[..., 0:1] + (c[..., 1:2] - c[..., 0:1]) * frac  # [B, R, size]
    return torch.clamp(1.0 - grid.abs() * 0.5, min=0.0)


def roi_align_1d(x, rois, *, size: int = 16, spatial_scale: float = 128 / 512):
    """x [B, C, L], rois [B, R, 2] (endpoints at the 512-sample scale) ->
    [B, C, R, size]."""
    L = x.shape[2]
    if L % 2 == 0:
        mid = 0.5 * (x[..., L // 2 - 1] + x[..., L // 2])  # [B, C]
    else:
        mid = x[..., (L - 1) // 2]
    w = roi_align_ramp(rois, size=size, spatial_scale=spatial_scale, feat_len=L)
    return (mid[:, :, None, None] * w[:, None, :, :]).to(x.dtype)


def _reverse_lerp_layout(rois, *, spatial_scale, out_len, S, R):
    """Per-output-slot source indices into the flat R*S axis and the lerp
    weight of the upper one: (idx0, idx1 [B, T] int64, w [B, T] f32)."""
    scaled = torch.floor(rois.to(torch.float32) * spatial_scale).to(torch.int64)
    lens = scaled[..., 1] - scaled[..., 0]  # [B, R]
    cum = torch.cumsum(lens, dim=-1)
    starts = cum - lens
    t = torch.arange(out_len, dtype=torch.int64, device=rois.device)
    seg = (t[None, None, :] >= cum[:, :, None]).sum(dim=1).clamp(max=R - 1)  # [B, T]
    seg_len = torch.gather(lens, 1, seg)
    seg_start = torch.gather(starts, 1, seg)
    local = (t[None, :] - seg_start).to(torch.float32)
    # F.interpolate(linear, align_corners=False): half-pixel, clamped at 0
    denom = seg_len.clamp(min=1).to(torch.float32)
    src = torch.clamp((local + 0.5) * (S / denom) - 0.5, min=0.0)
    i0 = torch.floor(src).to(torch.int64).clamp(max=S - 1)
    i1 = (i0 + 1).clamp(max=S - 1)
    w = src - i0.to(torch.float32)
    return seg * S + i0, seg * S + i1, w


def roi_reverse_matrix(rois, *, spatial_scale=128 / 512, out_len=128, segments=7, grid=32):
    """[B, R*S, T] lerp matrix M with roi_reverse(x) == flat(x) @ M."""
    idx0, idx1, w = _reverse_lerp_layout(
        rois, spatial_scale=spatial_scale, out_len=out_len, S=grid, R=segments)
    j = torch.arange(segments * grid, device=rois.device)
    return ((j[None, :, None] == idx0[:, None, :]) * (1.0 - w[:, None, :])
            + (j[None, :, None] == idx1[:, None, :]) * w[:, None, :])


def roi_reverse_1d(x, rois, *, spatial_scale: float = 128 / 512, out_len: int = 128):
    """x [B, C, R, S] per-segment grids -> [B, C, out_len]. The ROIs must form
    a contiguous partition of [0, 512] (the dataset guarantees it)."""
    B, C, R, S = x.shape
    m = roi_reverse_matrix(rois, spatial_scale=spatial_scale, out_len=out_len,
                           segments=R, grid=S).to(x.dtype)
    with precise(x):
        return torch.bmm(x.reshape(B, C, R * S), m)


def roi_pool_1d(x, rois, *, size: int = 8, spatial_scale: float = 1.0):
    """Reference `roi_pooling` (roi_pooling_1d.py:5-35): adaptive max pool of
    each inclusive slice x[..., r0 : r1+1] to `size` bins, as a bin-membership
    mask reduction. Not on the Nef-Net forward path (the reference defines but
    never calls it). x [B, C, L], rois [B, R, 2] -> [B, C, R, size]."""
    L = x.shape[2]
    scaled = torch.floor(rois.to(torch.float32) * spatial_scale).to(torch.int64)
    r0 = scaled[..., 0]  # [B, R]
    # the slice x[r0 : r1+1] ends at L at most (slicing clips r1+1 == L+1)
    n = (torch.clamp(scaled[..., 1] + 1, max=L) - r0)[..., None].to(torch.float32)  # [B, R, 1]
    k = torch.arange(size, dtype=torch.float32, device=x.device)
    # adaptive_max_pool1d bin k over a length-n slice: [floor(k*n/size), ceil((k+1)*n/size))
    lo = torch.floor(k * n / size).to(torch.int64) + r0[..., None]  # [B, R, size]
    hi = torch.ceil((k + 1) * n / size).to(torch.int64) + r0[..., None]
    t = torch.arange(L, device=x.device)
    mask = (t >= lo[..., None]) & (t < hi[..., None])  # [B, R, size, L]
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    return torch.where(mask[:, None], x[:, :, None, None, :], neg).amax(dim=-1)
