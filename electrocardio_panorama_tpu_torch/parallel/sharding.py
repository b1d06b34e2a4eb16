"""Data-parallel training and the view-sharded panorama over torch.distributed
(the JAX package's parallel/sharding.py: `build_dp_train_step` and
`build_sharded_panorama`).

Training (dp), which the Solver runs under TPU.mesh_shape: params and
optimizer state are replicated, each rank steps on its slice of the global
batch, and the gradients and loss components are averaged over the ranks by
`all_reduce_mean_`, one collective in a fixed order. The eager decoder's
BatchNorm sums its batch moments over the ranks (`BatchStatSync`, the JAX
package's `bn_axis`), so a sharded step normalizes with full-batch moments.
The fused train decoder (kernels A4f/A4b) normalizes each rank's sub-batch
with its own moments, as the JAX package's dp step does.

Panorama (sp over views): encode on the data axis, decode a slice of the
viewpoints per rank on the view axis, gather the views.

Collectives run on PyTorch's current stream order: NCCL waits for the
kernels launched before it, and what follows waits for NCCL.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from electrocardio_panorama_tpu_torch.models.nefnet import SEQ_LEN, decoder_apply
from electrocardio_panorama_tpu_torch.ops import angular_encode


def all_reduce_mean_(tensors, group=None) -> None:
    """Average `tensors` in place over the group's ranks: one flat buffer,
    one all_reduce, so the summation order is the same every step. At world
    size 1 the values stay bit for bit."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


class _SumOverRanks(torch.autograd.Function):
    """all_reduce (sum) with its adjoint: the backward of a sum over ranks is
    a sum over ranks of the cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class BatchStatSync:
    """Sums per-rank batch moments over a process group, with gradients.
    Given to the eager BatchNorm as `sync` (ops.convs), whose moments then
    cover the global batch."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _SumOverRanks.apply(t, self.group)


def synced_train_decode_fn(sync: BatchStatSync):
    """A `train_decode_fn` for nefnet_apply: the eager grouped train decode
    with its BatchNorm moments summed over the ranks."""

    def decode(p, s, stacked):
        o, updates = decoder_apply(p, s, stacked, train=True, bn_groups=3, bn_sync=sync)
        return torch.sigmoid(o / 3.0).reshape(3, -1, 1, SEQ_LEN), updates

    return decode


def _shard(n: int, mesh, axis: str) -> slice:
    size, rank = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    if n % size:
        raise ValueError(f"{n} does not divide over the {size} ranks of mesh axis {axis!r}")
    return slice(rank * n // size, (rank + 1) * n // size)


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def build_sharded_panorama(model_def, mesh, *, data_axis: str = "data", view_axis: str = "view",
                           use_fused: bool = False, compute_dtype=torch.float32, v_tile: int = 16):
    """render(params, bn_state, data, input_theta, rois, views [V, 2]) ->
    [B, V, 512] on every rank. Every rank gets the global inputs; it encodes
    its data-axis slice of the batch and decodes its view-axis slice of the
    views, and the outputs are gathered over both axes. B divides the data
    axis and V the view axis.

    `use_fused=True` decodes with the streamed-basis kernel A1 (BN folded
    from the replicated params, in `compute_dtype` storage), exactly as
    `PanoramaGenerator.render` does; otherwise the eager decoder."""
    from electrocardio_panorama_tpu_torch.ops.kernels.decoder_fused import fold_decoder_bn, fused_decode_views

    @torch.no_grad()
    def render(params, bn_state, data, input_theta, rois, views):
        bs, vs = _shard(data.shape[0], mesh, data_axis), _shard(views.shape[0], mesh, view_axis)
        p = {k: v.to(compute_dtype) for k, v in params.items()}
        latent = model_def.encode(p, data[bs].to(compute_dtype), input_theta[bs].to(compute_dtype),
                                  rois[bs]).latent_all
        v = views[vs].to(compute_dtype)[None].expand(latent.shape[0], -1, -1)
        if use_fused:
            folded = fold_decoder_bn(params, bn_state, dtype=compute_dtype)
            out = fused_decode_views(folded, latent, enc=angular_encode(v, model_def.theta_encoder_len),
                                     v_tile=v_tile)
        else:
            out = model_def.decode_views(p, bn_state, latent, v)
        out = _gather(out, 1, mesh.get_group(view_axis))
        return _gather(out, 0, mesh.get_group(data_axis))

    return render
