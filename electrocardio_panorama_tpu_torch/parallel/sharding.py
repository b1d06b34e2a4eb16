"""Data-parallel and lead-parallel training and the sharded panoramas over
torch.distributed (the JAX package's parallel/sharding.py).

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

Lead tensor parallelism (tp): every per-lead-grouped weight (the encoder
tower, w_conv, z1_conv, z2_conv1, z2_conv2, lead-major on axis 0) shards over
the `lead` axis with the input's lead columns; each rank encodes only its
leads (every encoder op is grouped per lead, so that is exactly the
L_local-lead model) and the lead mean of z1 / z2 becomes one all_reduce. The
decoder and the mlp gates replicate. `build_3d_train_step` composes it with
the batch sharded over (data, view); `build_lead_parallel_panorama` renders
with it. Neither launches a kernel: both encode and decode eagerly, as the
JAX package's do.

Collectives run on PyTorch's current stream order: NCCL waits for the
kernels launched before it, and what follows waits for NCCL.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from electrocardio_panorama_tpu_torch.models.nefnet import (
    FEAT_LEN,
    ROI_SEGMENTS,
    SEQ_LEN,
    decode_heads,
    decoder_apply,
    encode_latents,
)
from electrocardio_panorama_tpu_torch.ops import angular_encode, full_f32
from electrocardio_panorama_tpu_torch.training.optim import STATE_KEYS, optimizer_name
from electrocardio_panorama_tpu_torch.training.precision import cast_floats, cast_floats_f32


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

    `use_fused=True` encodes and decodes exactly as `PanoramaGenerator.render`
    does: through the model definition's fused encode where it has one (A2)
    and the streamed-basis kernel A1 (BN folded from the replicated params,
    in `compute_dtype` storage); otherwise the eager encoder and decoder."""
    from electrocardio_panorama_tpu_torch.ops.kernels.decoder_fused import fold_decoder_bn, fused_decode_views
    from electrocardio_panorama_tpu_torch.synthesis import encode_fn

    encode = encode_fn(model_def, use_fused)

    @torch.no_grad()
    def render(params, bn_state, data, input_theta, rois, views):
        bs, vs = _shard(data.shape[0], mesh, data_axis), _shard(views.shape[0], mesh, view_axis)
        p = {k: v.to(compute_dtype) for k, v in params.items()}
        latent = encode(p, data[bs].to(compute_dtype), input_theta[bs].to(compute_dtype),
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


# ------------------------------------------------------ lead tensor parallelism
# Param-name prefixes whose leaves are per-lead-grouped, lead-major on axis 0
# (models/nefnet.py::NefNet): blocks of 128 rows per lead (the encoder tower,
# w_conv, z1_conv, z2_conv1), and of 128*7 for z2_conv2, whose ROI segments
# interleave across the group boundaries (encode_latents).
LEAD_PREFIXES = ("W_encoder.", "w_conv.", "z1_conv.", "z2_conv1.", "z2_conv2.")


def lead_param_specs(params: dict, lead_num: int, lead_axis: str = "lead") -> dict:
    """{key: lead_axis} for the per-lead-grouped leaves, which shard axis 0
    over the lead axis; {key: None} for the replicated rest (decoder, mlp
    gates, the dead w_feature_extractor)."""
    specs = {}
    for k, v in params.items():
        lead = k.startswith(LEAD_PREFIXES)
        if lead and v.shape[0] % lead_num:
            raise ValueError(f"{k} {list(v.shape)}: axis 0 not divisible by lead_num={lead_num}")
        specs[k] = lead_axis if lead else None
    return specs


def opt_state_specs(opt, params: dict, p_specs: dict) -> dict:
    """{key: {state name: spec}} for a torch.optim state kept by parameter key
    (training/optim.py::state_by_key): SGD's momentum and Adam's two moments
    have their parameter's shape, so each follows its parameter's spec."""
    return {k: {name: p_specs[k] for name in STATE_KEYS[optimizer_name(opt)]} for k in params}


def _leads(lead_num: int, mesh, lead_axis: str) -> slice:
    """This rank's leads; raises unless the lead axis divides lead_num."""
    n = mesh.size(mesh.mesh_dim_names.index(lead_axis))
    if lead_num % n:
        raise ValueError(f"lead_num={lead_num} not divisible by |{lead_axis}|={n}")
    return _shard(lead_num, mesh, lead_axis)


def _lead_block(params: dict, leads: slice, lead_num: int) -> dict:
    """Views of this rank's lead block of a full param dict."""
    return {k: v[leads.start * v.shape[0] // lead_num:leads.stop * v.shape[0] // lead_num]
            if k.startswith(LEAD_PREFIXES) else v for k, v in params.items()}


def shard_lead_params(params: dict, mesh, *, lead_num: int, lead_axis: str = "lead") -> dict:
    """One rank's block of a full, reference-keyed dict: each lead-sharded
    leaf cut to this rank's leads on axis 0, the rest whole; every tensor a
    fresh copy, detached."""
    block = _lead_block(params, _leads(lead_num, mesh, lead_axis), lead_num)
    return {k: v.detach().clone() for k, v in block.items()}


def gather_lead_params(params: dict, mesh, *, lead_axis: str = "lead") -> dict:
    """The full, reference-keyed tensors from every rank's block (params, or
    optimizer state by parameter key): each lead-sharded leaf all-gathered over
    the lead axis on axis 0, the rest as they are; detached. For pickle
    checkpoints and the tests."""
    group = mesh.get_group(lead_axis)
    return {k: _gather(v.detach(), 0, group) if k.startswith(LEAD_PREFIXES) else v.detach()
            for k, v in params.items()}


def build_lead_parallel_panorama(model_def, mesh, *, lead_axis: str = "lead", view_axis: str | None = None):
    """render(params, bn_state, data, input_theta, rois, views [V, 2]) ->
    [B, V, 512] on every rank, with lead tensor parallelism: every rank gets
    the full params and inputs, encodes its lead block of the weights and of
    `data` / `input_theta`, and the lead mean over all L leads is one
    all_reduce of the local means scaled by L_local / L. The decode is the
    eager `decode_views`, of this rank's slice of the views when `view_axis`
    is given (then gathered), else of all of them. Raises ValueError when the
    lead axis does not divide lead_num. No kernel runs here: the JAX
    package's decodes with the XLA decoder too."""
    L = model_def.lead_num
    leads = _leads(L, mesh, lead_axis)
    L_local = leads.stop - leads.start
    lead_group = mesh.get_group(lead_axis)

    @torch.no_grad()
    @full_f32()
    def render(params, bn_state, data, input_theta, rois, views):
        lat = encode_latents(_lead_block(params, leads, L), data[:, leads], input_theta[:, leads], rois,
                             lead_num=L_local, theta_encoder_len=model_def.theta_encoder_len)
        latent_all = torch.cat([_SumOverRanks.apply(z * (L_local / L), lead_group)
                                for z in (lat.z1_mean, lat.z2_mean)], dim=1)
        if view_axis is not None:
            views = views[_shard(views.shape[0], mesh, view_axis)]
        out = model_def.decode_views(params, bn_state, latent_all, views[None].expand(latent_all.shape[0], -1, -1))
        return _gather(out, 1, mesh.get_group(view_axis)) if view_axis is not None else out

    return render


def _batch_group(mesh, lead_axis: str):
    """The group of the ranks that share this rank's lead index (the joint
    (data, view) axes). Every rank creates every such group, in one order."""
    ranks = mesh.mesh
    dim = mesh.mesh_dim_names.index(lead_axis)
    mine = None
    for j in range(ranks.shape[dim]):
        members = ranks.select(dim, j).flatten().tolist()
        group = dist.new_group(members)
        if dist.get_rank() in members:
            mine = group
    return mine


def build_3d_train_step(model_def, cfg, opt, mesh, *, data_axis: str = "data", lead_axis: str = "lead",
                        view_axis: str = "view", deterministic: bool = False):
    """One training step over a 3-axis (data x lead x view) mesh: every
    parallelism axis of the framework composed in one step.

    step(params, bn_state, *, epoch, step, i1, i2, batch) -> (new bn_state,
    loss vector [4]), as `Solver.train_step`: `batch` holds the global batch's
    arrays (every rank gets all of it), `params` is this rank's block
    (`shard_lead_params`) as the leaf tensors `opt` updates in place.

      * data + view: the batch rows shard jointly over both axes, data-major
        (the JAX package's P((data, view))); the eager decoder's BatchNorm sums
        its moments over that joint group, and the gradients and loss
        components are averaged over it.
      * lead: each rank encodes its lead block of the weights and of `data` /
        `input_theta`; latent_all is one all_reduce of the scaled local lead
        means; the standin picks z1[:, i1] and z2[:, i2] come from the owning
        rank by a masked all_reduce. mlp1's gradient is lead-partial and is
        averaged over the lead group; the decoder's and mlp2's are the same
        on every lead rank and take no lead collective.

    Every lead rank holds a copy of the same loss, and the adjoint of the lead
    all_reduce sums the cotangents over the lead ranks, so each gradient that
    flows through it arrives n_lead times too large: the lead-sharded leaves'
    gradients are divided by n_lead and mlp1's averaged over the lead group
    (the JAX package's correction, parallel/sharding.py:360-379).

    TPU.compute_dtype as the Solver: float32 masters and optimizer state,
    bfloat16 forward and backward (the lead all_reduces and the BatchNorm
    moment sums in bfloat16), the gradient mean in float32. Dropout masks are
    the global batch's, drawn from the (seed, epoch, step) generator, cut to
    this rank's rows and lead channels, so the draws do not depend on the
    topology; `deterministic=True` turns dropout off. The encode and decode are
    the eager ones (the JAX package's step does not take the fused pairs)."""
    from electrocardio_panorama_tpu_torch.models import build_loss
    from electrocardio_panorama_tpu_torch.ops.kernels.encoder_fused import draw_masks
    from electrocardio_panorama_tpu_torch.training.solver import step_seed

    L = model_def.lead_num
    leads = _leads(L, mesh, lead_axis)
    L_local = leads.stop - leads.start
    n_lead = mesh.size(mesh.mesh_dim_names.index(lead_axis))
    lead_group = mesh.get_group(lead_axis)
    batch_group = _batch_group(mesh, lead_axis)
    n_batch = dist.get_world_size(batch_group)
    shard = mesh.get_local_rank(data_axis) * mesh.size(mesh.mesh_dim_names.index(view_axis)) \
        + mesh.get_local_rank(view_axis)
    # the eager grouped decode, its BatchNorm over the joint (data, view) batch
    decode_fn = synced_train_decode_fn(BatchStatSync(batch_group)) if n_batch > 1 else None
    compute_dtype = getattr(torch, cfg.TPU.compute_dtype)
    mixed = compute_dtype != torch.float32
    tlen = model_def.theta_encoder_len
    loss_fn = build_loss(cfg)
    device = opt.param_groups[0]["params"][0].device

    def pick_lead(z, idx: int):
        """z [b, 128 L_local, 128] of this rank's leads, idx a global lead ->
        [b, 128, 128] from the rank that owns it."""
        own = leads.start <= idx < leads.stop
        local = z.reshape(z.shape[0], L_local, 128, FEAT_LEN)[:, min(max(idx - leads.start, 0), L_local - 1)]
        return _SumOverRanks.apply(local * float(own), lead_group)

    def step(params: dict, bn_state: dict, *, epoch: int, step: int, i1: int, i2: int, batch: dict):
        B = len(batch["data"])
        if B % n_batch:
            raise ValueError(f"global batch {B} not divisible by |{data_axis}| x |{view_axis}| = {n_batch}")
        rows = slice(shard * B // n_batch, (shard + 1) * B // n_batch)
        data, it, tt, rois, tv, noise = (torch.as_tensor(np.asarray(batch[k])[rows]).to(device) for k in
                                         ("data", "input_theta", "target_theta", "rois", "target_view", "noise"))
        data, it = data[:, leads], it[:, leads]
        masks = None
        if not deterministic:
            gen = torch.Generator(device=device).manual_seed(step_seed(cfg.seed, epoch, step))
            m6, mc20, mc22 = draw_masks(gen, B, L, dtype=compute_dtype)
            # lead-major channels: 128 per lead in m6, 128 * 7 in mc20 / mc22
            c = slice(128 * leads.start, 128 * leads.stop)
            cz = slice(128 * ROI_SEGMENTS * leads.start, 128 * ROI_SEGMENTS * leads.stop)
            masks = (m6[:, rows, c], mc20[rows, cz], mc22[rows, cz])
        opt.zero_grad(set_to_none=True)
        with contextlib.nullcontext() if mixed else full_f32():
            p = cast_floats(params, compute_dtype) if mixed else params
            if mixed:
                data, it, tt = (t.to(compute_dtype) for t in (data, it, tt))
            lat = encode_latents(p, data, it, rois, lead_num=L_local, theta_encoder_len=tlen, masks=masks,
                                 train=True)
            z1_mean, z2_mean = (_SumOverRanks.apply(z * (L_local / L), lead_group)
                                for z in (lat.z1_mean, lat.z2_mean))
            (out, sp, sl), new_bn = decode_heads(
                p, bn_state, torch.cat([z1_mean, z2_mean], dim=1),
                torch.cat([pick_lead(lat.z1, i1), z2_mean], dim=1), torch.cat([z1_mean, pick_lead(lat.z2, i2)], dim=1),
                tt, theta_encoder_len=tlen, train=True, train_decode_fn=decode_fn)
            if mixed:
                out, sp, sl = (t.float() for t in (out, sp, sl))
                new_bn = cast_floats_f32(new_bn)
            if cfg.DATA.noise:
                out = out + noise[:, None, :]
            loss, lo1, lo2, lo3 = loss_fn(out, sp, sl, tv[:, None, :], cfg)
            loss.backward()
        grads = {k: v.grad for k, v in params.items() if v.grad is not None}
        for k, g in grads.items():
            if k.startswith(LEAD_PREFIXES):
                g.mul_(1.0 / n_lead)
        all_reduce_mean_([g for k, g in grads.items() if k.startswith("mlp1.")], group=lead_group)
        all_reduce_mean_(grads.values(), group=batch_group)
        opt.step()
        lvec = torch.stack([loss, lo1, lo2, lo3]).detach().float()
        all_reduce_mean_([lvec], group=batch_group)
        return {k: v.detach() for k, v in new_bn.items()}, lvec

    return step
