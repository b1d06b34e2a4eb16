"""One Nef-Net train step of the port's Solver against the same step in JAX,
on the CPU, at B=4, L=3, with the same weights, batch, dropout masks and
standin shuffle indices.

The JAX step is the recipe of the JAX Solver's train step (model.apply with
phase='train', the loss tuple, value_and_grad, optax update), with an
`encode_fn` built here that feeds the fixed masks to `encode_fused_train` in
interpret mode, so nothing in the JAX package changes. The port's step runs
`Solver.train_step` with its mask draw replaced by the same masks, through
the fused encoder's plain version (TPU.train_encoder 'fused' on the CPU) and
through the eager encoder ('xla'). With TPU.train_decoder 'fused' both sides
decode through their fused train decoder: the JAX step through its Pallas
kernel pair in interpret mode (`make_train_decode_fn(interpret=True)`, what
the JAX Solver builds on the CPU), the port's through the pair's plain
version, held to the float32 tolerances below.

Tolerances, float32: the loss tuple rtol 1e-5; the BN running statistics
atol 1e-5; each parameter's update (new minus old) by the bulk (99.5% of
elements within 2e-4 of the largest) plus energy (L2 relative 5e-4)
criterion of tests/test_pallas_encoder.py, since where a pre-activation
sits within rounding of 0 the two sides may take the relu mask either way.
Adam moves each weight by about lr * sign(g) on its first step, so its
moments are held to the same criterion, and the steps themselves must agree
on 98% of the elements. bfloat16: the loss tuple rtol 1e-2, and the update
of every parameter correlates with the JAX bf16 update at > 0.98, at an L2
distance from it of at most twice (or 5e-2) the JAX bf16 update's own
distance from the JAX float32 update: the two round at the same points but
differ in summation order, which bf16 turns into one-ulp steps. The 5e-2
floor is for the decoder's last conv bias, one number whose bf16 gradient
PyTorch sums over N*T terms (4.8e-2 from JAX's here; JAX's own 8.5e-3).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax

from electrocardio_panorama_tpu.config import get_cfg as jax_get_cfg
from electrocardio_panorama_tpu.models import NefNetDef as JaxNefNetDef
from electrocardio_panorama_tpu.models import build_loss as jax_build_loss
from electrocardio_panorama_tpu.models.nefnet import NefNetLatents as JaxLatents
from electrocardio_panorama_tpu.ops import angular_encode as jax_angular_encode
from electrocardio_panorama_tpu.ops import linear as jax_linear
from electrocardio_panorama_tpu.ops import roi_reverse_1d as jax_roi_reverse_1d
from electrocardio_panorama_tpu.ops.pallas import decoder_train as DT
from electrocardio_panorama_tpu.ops.pallas import encoder_fused as EF
from electrocardio_panorama_tpu.ops.roi import roi_align_ramp as jax_roi_align_ramp
from electrocardio_panorama_tpu.training.optim import get_optimizer as jax_get_optimizer
from electrocardio_panorama_tpu.training.optim import lr_for_epoch as jax_lr_for_epoch
from electrocardio_panorama_tpu.training.precision import cast_floats as jax_cast_floats
from electrocardio_panorama_tpu.training.precision import cast_floats_f32 as jax_cast_floats_f32
import torch

from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models import build_loss, loss_wrapper, mse, mse_per_lead
from electrocardio_panorama_tpu_torch.training import solver as S
from electrocardio_panorama_tpu_torch.training.optim import get_optimizer, lr_for_epoch, state_by_key

L, B = 3, 4
I1, I2 = 2, 1


def configure(cfg, optim):
    cfg.desc = "debug"
    cfg.DATA.lead_num = L
    cfg.DATA.super_mode = "IIv2v5_v4I_372"
    cfg.MODEL.model = "model_nefnet"
    cfg.SOLVER.optim = optim
    cfg.SOLVER.lr = 0.1 if optim == "sgd" else 1e-3
    cfg.SOLVER.loss_factor = [0.5, 0.5, 1]
    return cfg


def masks_model_layout(m6, mc20, mc22):
    """Kernel-layout masks -> model layout (tests/test_pallas_encoder.py)."""
    m6, mc20, mc22 = (np.asarray(m, np.float32) for m in (m6, mc20, mc22))
    nb = m6.shape[-1] // 128
    return (m6.reshape(6, L, 128, nb, 128).transpose(0, 3, 1, 2, 4).reshape(6, nb, 128 * L, 128),
            mc20.reshape(7 * L, 128, nb, 16).transpose(2, 0, 1, 3).reshape(nb, 128 * L * 7, 16),
            mc22.reshape(7 * L, 128, nb, 32).transpose(2, 0, 1, 3).reshape(nb, 128 * L * 7, 32))


@pytest.fixture(scope="module")
def setup():
    params, state = JaxNefNetDef(L).init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(9)
    cuts = np.sort(rng.integers(16, 496, (B, 6)), axis=1)
    rois = np.zeros((B, 7, 2), np.float32)
    rois[:, :6, 1] = cuts
    rois[:, 1:, 0] = cuts
    rois[:, 6, 1] = 512
    batch = {
        "data": rng.normal(0, 0.6, (B, L, 512)).astype(np.float32),
        "input_theta": rng.uniform(-np.pi, np.pi, (B, L, 2)).astype(np.float32),
        "target_theta": rng.uniform(-np.pi, np.pi, (B, 2)).astype(np.float32),
        "rois": rois,
        "target_view": rng.uniform(0, 1, (B, 512)).astype(np.float32),
        "noise": np.zeros((B, 512), np.float32),
    }
    masks_k = EF.draw_masks(jax.random.PRNGKey(5), B, L, jnp.float32)
    return params, state, batch, masks_k


def jax_grads(params, state, batch, masks_k, dtype, train_decoder="xla"):
    """(loss tuple, grads, new BN state) of the JAX train step's loss_fn."""
    cfg = configure(jax_get_cfg(), "sgd")
    model = JaxNefNetDef(L)
    loss_fn_ = jax_build_loss(cfg)
    mixed = dtype != jnp.float32
    tdf = DT.make_train_decode_fn(compute_dtype=dtype, interpret=True) if train_decoder == "fused" else None

    def encode_fn(p, x, input_thetas, rois, *, rng=None, train=False):
        gate1 = jax_linear(jax_angular_encode(input_thetas, 1), p["mlp1.weight"], p["mlp1.bias"])
        xph, gexp, ramp = EF.prep_encoder_inputs(x, gate1, jax_roi_align_ramp(rois))
        w = EF.pack_encoder_weights(p, L, x.dtype)
        z1k, z2k = EF.encode_fused_train((L, B, True, "tower"), w, xph, gexp, ramp,
                                         *(m.astype(x.dtype) for m in masks_k))
        z1, z2g = EF.unpack_outputs(z1k, z2k, L)
        z2 = jax_roi_reverse_1d(z2g, rois)
        z1m = z1.reshape(B, L, 128, 128).mean(axis=1)
        z2m = z2.reshape(B, L, 128, 128).mean(axis=1)
        return JaxLatents(z1, z2, z1m, z2m, jnp.concatenate([z1m, z2m], axis=1))

    def loss_fn(p, data, it, tt, rois, tv):
        if mixed:
            p = jax_cast_floats(p, dtype)
            data, it, tt = jax_cast_floats((data, it, tt), dtype)
        (out, sp, sl), new_bn = model.apply(p, state, data, it, tt, rois, phase="train",
                                            rng=jax.random.PRNGKey(0), shuffle_idx=(I1, I2),
                                            encode_fn=encode_fn, train_decode_fn=tdf)
        if mixed:
            out, sp, sl = jax_cast_floats_f32((out, sp, sl))
            new_bn = jax_cast_floats_f32(new_bn)
        lo = loss_fn_(out, sp, sl, tv[:, None, :], cfg)
        return lo[0], (jnp.stack(lo), new_bn)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (lo, new_bn)), grads = step(params, *(jnp.asarray(batch[k]) for k in
                                             ("data", "input_theta", "target_theta", "rois", "target_view")))
    return [float(v) for v in lo], grads, {k: np.asarray(v) for k, v in new_bn.items()}


def jax_update(params, grads, optim):
    """The JAX Solver's optimizer update: (new params, new optax state)."""
    tx = jax_get_optimizer(configure(jax_get_cfg(), optim))
    updates, new_opt = tx.update(grads, tx.init(params), params)
    return {k: np.asarray(v) for k, v in optax.apply_updates(params, updates).items()}, new_opt


def port_step(params, state, batch, masks_k, optim, encoder, dtype, monkeypatch, decoder="xla"):
    cfg = configure(get_cfg(), optim)
    cfg.TPU.train_encoder = encoder
    cfg.TPU.train_decoder = decoder
    cfg.TPU.compute_dtype = dtype
    cfg.output_dir = "unused"
    tp, ts = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                             {k: np.asarray(v) for k, v in state.items()})
    masks = tuple(torch.tensor(m).to(getattr(torch, dtype)) for m in masks_model_layout(*masks_k))
    monkeypatch.setattr(S.Solver, "draw_masks", lambda self, gen, b: masks)
    monkeypatch.setattr(S.os, "makedirs", lambda *a, **k: None)
    solver = S.Solver(cfg, use_writer=False, device="cpu")
    assert (solver.train_encoder, solver.train_decoder) == (encoder, decoder)
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    opt = get_optimizer(cfg, p)
    new_bn, lvec = solver.train_step(p, ts, opt, epoch=0, step=0, i1=I1, i2=I2, batch=batch)
    return lvec.tolist(), {k: v.detach().numpy() for k, v in p.items()}, \
        {k: v.numpy() for k, v in new_bn.items()}, state_by_key(opt, p)


def l2_rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-20))


# conv biases right before a train-mode BN: the batch mean cancels them, so
# their gradient is rounding noise on both sides (and Adam's normalized update
# of noise is noise); their updates are held to be tiny instead
BN_CANCELLED = tuple(f"decoder.{i}.double_conv.{j}.bias" for i in (1, 3) for j in (0, 3))


def update_close(a, b, key):
    d = np.abs(a - b) / max(np.abs(b).max(), 1e-20)
    assert (d > 2e-4).mean() <= 5e-3, f"{key}: {(d > 2e-4).mean():.2e} of elements over 2e-4"
    assert l2_rel(a, b) <= 5e-4, f"{key}: update L2 rel err {l2_rel(a, b):.2e}"


def update_close_or_one_channel(a, b, key):
    """`update_close`, except that one element of a per-channel vector may sit
    up to 2e-3 of the largest away: with both decoders fused, BatchNorm's
    moments come from two formulas (the TPU kernel's E[a^2] - mean^2, the
    port's two passes), a relu mask at a pre-activation within rounding of 0
    may fall either way, and one flipped element moves one channel's sum by a
    whole term, which a vector of 64 channels cannot hide in its 0.5%."""
    d = np.abs(a - b) / max(np.abs(b).max(), 1e-20)
    over = d > 2e-4
    if a.ndim == 1 and over.sum() == 1 and d.max() <= 2e-3:
        return
    update_close(a, b, key)


@pytest.fixture(scope="module")
def jax_results(setup):
    params, state, batch, masks_k = setup
    lo, grads, new_bn = jax_grads(params, state, batch, masks_k, jnp.float32)
    return {o: (lo, *jax_update(params, grads, o), new_bn) for o in ("sgd", "adam")}


@pytest.mark.parametrize("optim", ["sgd", "adam"])
@pytest.mark.parametrize("encoder", ["fused", "xla"])
def test_train_step_f32_matches_jax(setup, jax_results, optim, encoder, monkeypatch):
    params, state, batch, masks_k = setup
    port = port_step(params, state, batch, masks_k, optim, encoder, "float32", monkeypatch)
    check_f32_step(params, state, jax_results[optim], port, optim)


def test_train_step_fused_decoder_matches_jax_fused_step(setup, monkeypatch):
    """TPU.train_decoder 'fused' on both sides, fused encoder on both sides:
    the same batch, weights, masks and shuffle indices."""
    params, state, batch, masks_k = setup
    lo, grads, new_bn = jax_grads(params, state, batch, masks_k, jnp.float32, train_decoder="fused")
    port = port_step(params, state, batch, masks_k, "sgd", "fused", "float32", monkeypatch, decoder="fused")
    check_f32_step(params, state, (lo, *jax_update(params, grads, "sgd"), new_bn), port, "sgd",
                   update_close=update_close_or_one_channel)


def check_f32_step(params, state, jax_result, port_result, optim, update_close=update_close):
    jl, jp, jopt, jbn = jax_result
    pl, pp, pbn, popt = port_result
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert len(pl) == 4 and pl[0] == pytest.approx(pl[1] + pl[2] + pl[3], rel=1e-6)
    p0 = {k: np.asarray(v) for k, v in params.items()}
    inner = jopt.inner_state[0]
    for k in jp:
        if k in BN_CANCELLED:
            if optim == "sgd":
                assert np.abs(pp[k] - p0[k]).max() < 1e-7 and np.abs(jp[k] - p0[k]).max() < 1e-7, k
            continue
        if optim == "sgd":
            update_close(pp[k] - p0[k], jp[k] - p0[k], k)
            update_close(popt["state"][k]["momentum_buffer"], np.asarray(inner.trace[k]), k)
        else:
            # Adam's first step moves each weight by about lr * sign(g), so a
            # gradient at rounding level may flip; the moments are linear in g
            update_close(popt["state"][k]["exp_avg"], np.asarray(inner.mu[k]), k)
            if np.abs(np.asarray(inner.nu[k])).max() > 0:
                assert l2_rel(popt["state"][k]["exp_avg_sq"], np.asarray(inner.nu[k])) <= 1e-3, k
            off = np.abs((pp[k] - p0[k]) - (jp[k] - p0[k])) > 1e-2 * 1e-3
            assert off.mean() <= 0.02, f"{k}: {off.mean():.2e} of Adam steps differ"
    assert sorted(pbn) == sorted(jbn)
    for k in jbn:
        if k.endswith("num_batches_tracked"):
            assert int(pbn[k]) == int(jbn[k]) == int(np.asarray(state[k])) + 3
        else:
            np.testing.assert_allclose(pbn[k], jbn[k], atol=1e-5, rtol=1e-5, err_msg=k)
    if optim == "adam":
        assert popt["step"] == int(inner.count) == 1


def test_train_step_bf16_matches_jax(setup, jax_results, monkeypatch):
    params, state, batch, masks_k = setup
    jl, grads, _ = jax_grads(params, state, batch, masks_k, jnp.bfloat16)
    jp, _ = jax_update(params, grads, "sgd")
    _, jp32, _, _ = jax_results["sgd"]
    pl, pp, pbn, _ = port_step(params, state, batch, masks_k, "sgd", "fused", "bfloat16", monkeypatch)
    np.testing.assert_allclose(pl, jl, rtol=1e-2)
    assert all(v.dtype == np.float32 for v in pp.values())
    assert all(v.dtype == np.float32 for k, v in pbn.items() if "num_batches" not in k)
    p0 = {k: np.asarray(v) for k, v in params.items()}
    for k in jp:
        a, b = pp[k] - p0[k], jp[k] - p0[k]
        if k in BN_CANCELLED:
            continue
        if np.abs(b).max() == 0:
            assert np.abs(a).max() == 0, k  # the unused residual convs
            continue
        own = l2_rel(b, jp32[k] - p0[k])  # the JAX bf16 step's own distance from float32
        assert a.size == 1 or np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.98, k
        assert l2_rel(a, b) <= max(2 * own, 5e-2), f"{k}: {l2_rel(a, b):.2e} vs JAX's own {own:.2e}"


def test_lr_for_epoch_matches_jax():
    for sched, lr, steps in (("steplr", 1.0, [150, 350]), ("MultiStep", 0.05, [50, 100])):
        c, j = get_cfg(), jax_get_cfg()
        for cfg in (c, j):
            cfg.SOLVER.scheduler, cfg.SOLVER.lr, cfg.SOLVER.lr_step = sched, lr, steps
        for epoch in (0, 49, 50, 51, 99, 100, 149, 150, 400):
            assert lr_for_epoch(c, epoch) == pytest.approx(jax_lr_for_epoch(j, epoch), rel=1e-12)
    c.SOLVER.scheduler = "cosine"
    with pytest.raises(ValueError, match="scheduler"):
        lr_for_epoch(c, 0)


@pytest.mark.parametrize("reg_loss", ["l1_loss", "l2_loss"])
@pytest.mark.parametrize("using", [[1, 2, 3], [3]])
def test_losses_match_jax(reg_loss, using):
    rng = np.random.default_rng(len(using))
    out, sp, sl, tv = (rng.uniform(0, 1, (B, 1, 512)).astype(np.float32) for _ in range(4))
    ro, rv = (rng.uniform(0, 1, (B, 4, 512)).astype(np.float32) for _ in range(2))
    c, j = get_cfg(), jax_get_cfg()
    for cfg in (c, j):
        cfg.SOLVER.reg_loss, cfg.SOLVER.loss_using, cfg.SOLVER.loss_factor = reg_loss, using, [0.5, 0.5, 1]
    tensors = [torch.tensor(a, requires_grad=True) for a in (out, sp, sl)]
    ours = loss_wrapper(*tensors, torch.tensor(tv), c, torch.tensor(ro), torch.tensor(rv))
    theirs = jax_build_loss(j)(*(jnp.asarray(a) for a in (out, sp, sl, tv)), j, jnp.asarray(ro), jnp.asarray(rv))
    np.testing.assert_allclose([float(v.detach()) for v in ours], [float(v) for v in theirs], rtol=1e-6)
    # the standin terms stop the gradient on the prediction side
    ours[0].backward()

    def f(o, a, b):
        return jax_build_loss(j)(o, a, b, jnp.asarray(tv), j)[0]

    gj = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (out, sp, sl)))
    for a, b in zip(tensors, gj):  # a term left out gives no gradient (JAX: zeros)
        ga = a.grad.numpy() if a.grad is not None else np.zeros_like(a.detach().numpy())
        np.testing.assert_allclose(ga, np.asarray(b), atol=1e-9)
    assert build_loss(c) is loss_wrapper
    c.MODEL.loss = "mse"
    assert float(build_loss(c)(torch.tensor(out), torch.tensor(tv))) == pytest.approx(float(mse(
        torch.tensor(out), torch.tensor(tv))))
    np.testing.assert_allclose(float(mse_per_lead(torch.tensor(ro), torch.tensor(rv))),
                               float(np.mean(np.mean((ro - rv) ** 2, axis=(0, 2)))), rtol=1e-6)
    c.MODEL.loss = "other"
    with pytest.raises(ValueError, match="loss name"):
        build_loss(c)
