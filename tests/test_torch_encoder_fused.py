"""Fused encoder (kernels A2/A3): the port's plain version against the JAX
package's Pallas pair `encode_fused_train` / `encode_fused_eval` in
interpret mode, on the CPU, with the same dropout masks.

Tolerances:
  * f32 forward: rtol 1e-5, atol 3e-5, the bar of tests/test_pallas_encoder.py;
  * f32 gradients: the bulk (99.5% of elements within 2e-4 of the largest)
    plus energy (L2 relative <= 5e-4) criterion of the same file. A plain
    allclose is wrong here: where a pre-activation sits within rounding of 0
    the two implementations may take the relu mask either way;
  * bf16 forward: atol 0.02 and corr > 0.9999 against the JAX bf16 kernel.
    bf16 gradients: per tensor, corr > 0.995 with the JAX bf16 kernel's, and
    an L2 distance from it of at most twice (or 1e-2) the JAX bf16 kernel's
    own L2 distance from its f32 gradient. Both round at the same points and
    differ by summation order, which bf16 turns into one-ulp steps (2^-8
    relative) that the later stages carry; the z2 branch, fed by two time
    steps per sample through roi_align, shows it most (about 5e-2 either
    way at this size);
  * `encoder_ckpt` off/tower/full: bitwise-equal gradients on the card;
  * f32 kernel gradients on the card: A3 on the plain version's own forward
    planes (`full` mode, the same relu masks on both sides) against the
    plain gradients, at the f32 bars; and A2 -> A3 end to end at L2 relative
    5e-3 and corr > 0.9999, the bars of the train decoder's gradients. End
    to end, kernel and plain each take the relu masks of their own forward;
    a pre-activation within rounding of 0 may fall either way, and one such
    flip moves a tower weight gradient by about 1.4e-3 of its L2 norm at
    B=32 (measured on an H100 against a float64 pass, where either side
    flips). The bitwise checks across modes tie the recomputing modes to
    `full`;
  * the plain version's float64 pass (the reference the card's float32
    kernels are also measured against) against its float32 pass and the
    JAX f32 pair: the f32 bars above.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.models import NefNetDef as JaxNefNetDef
from electrocardio_panorama_tpu.ops import angular_encode as jax_angular_encode
from electrocardio_panorama_tpu.ops import linear as jax_linear
from electrocardio_panorama_tpu.ops.pallas import encoder_fused as EF
from electrocardio_panorama_tpu.ops.roi import roi_align_ramp as jax_roi_align_ramp
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models import encode_latents
from electrocardio_panorama_tpu_torch.ops import full_f32
from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as TE

L, B, NB = 3, 8, 8
ENC_PREFIXES = ("W_encoder", "w_conv", "z1_conv", "z2_conv1", "z2_conv2", "mlp1")


def masks_model_layout(m6, mc20, mc22, lead_num=L):
    """Kernel-layout masks -> model layout (tests/test_pallas_encoder.py)."""
    m6, mc20, mc22 = (np.asarray(m, np.float32) for m in (m6, mc20, mc22))
    nb, ld = m6.shape[-1] // 128, lead_num
    return (m6.reshape(6, ld, 128, nb, 128).transpose(0, 3, 1, 2, 4).reshape(6, nb, 128 * ld, 128),
            mc20.reshape(7 * ld, 128, nb, 16).transpose(2, 0, 1, 3).reshape(nb, 128 * ld * 7, 16),
            mc22.reshape(7 * ld, 128, nb, 32).transpose(2, 0, 1, 3).reshape(nb, 128 * ld * 7, 32))


def make_inputs(seed=0, batch=B, lead_num=L):
    params, state = JaxNefNetDef(lead_num).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 7)
    x = rng.normal(0, 0.6, (batch, lead_num, 512)).astype(np.float32)
    thetas = rng.uniform(-1, 1, (batch, lead_num, 2)).astype(np.float32)
    cuts = np.sort(rng.integers(16, 496, (batch, 6)), axis=1)
    rois = np.zeros((batch, 7, 2), np.float32)
    rois[:, :6, 1] = cuts
    rois[:, 1:, 0] = cuts
    rois[:, 6, 1] = 512
    masks = EF.draw_masks(jax.random.PRNGKey(seed + 3), batch, lead_num, jnp.float32)
    tp, _ = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                            {k: np.asarray(v) for k, v in state.items()})
    return params, tp, x, thetas, rois, masks


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def jax_encode(params, x, thetas, rois, masks, dtype):
    """The JAX pair in interpret mode: (z1 [B,128L,128], z2 grid [B,128L,7,32])."""
    gate1 = jax_linear(jax_angular_encode(jnp.asarray(thetas), 1), params["mlp1.weight"], params["mlp1.bias"])
    xph, gexp, ramp = EF.prep_encoder_inputs(jnp.asarray(x, dtype), gate1.astype(dtype),
                                             jax_roi_align_ramp(jnp.asarray(rois)))
    w = EF.pack_encoder_weights(params, L, dtype)
    if masks is None:
        z1k, z2k = EF.encode_fused_eval(w, xph, gexp, ramp, L=L, nb=NB, interpret=True)
    else:
        z1k, z2k = EF.encode_fused_train((L, NB, True), w, xph, gexp, ramp,
                                         *(m.astype(dtype) for m in masks))
    return EF.unpack_outputs(z1k, z2k, L)


def port_encode(tp, x, thetas, rois, masks, dtype):
    fn = TE.make_fused_encode_fn(L)
    p = {k: (v.to(dtype) if k in TE.WEIGHT_KEYS.values() else v) for k, v in tp.items()}
    m = None if masks is None else tuple(torch.tensor(a).to(dtype) for a in masks_model_layout(*masks))
    return fn(p, torch.tensor(x).to(dtype), torch.tensor(thetas), torch.tensor(rois), masks=m,
              train=masks is not None)


def l2_rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def grad_close(a, b, key, bulk=2e-4, l2_bar=5e-4):
    denom = max(np.abs(b).max(), 1e-3)
    d = np.abs(a - b) / denom
    assert (d > bulk).mean() <= 5e-3, f"{key}: {(d > bulk).mean():.2e} of elements over {bulk}"
    assert l2_rel(a, b) <= l2_bar, f"{key}: grad L2 rel err {l2_rel(a, b):.2e}"


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_plain_forward_f32_matches_jax_interpret(inputs, train):
    params, tp, x, thetas, rois, masks = inputs
    m = masks if train else None
    z1, z2g = jax_encode(params, x, thetas, rois, m, jnp.float32)
    lat = port_encode(tp, x, thetas, rois, m, torch.float32)
    np.testing.assert_allclose(lat.z1.numpy(), np.asarray(z1), rtol=1e-5, atol=3e-5)
    B_ = x.shape[0]
    from electrocardio_panorama_tpu.ops import roi_reverse_1d
    z2 = np.asarray(roi_reverse_1d(z2g, jnp.asarray(rois)))
    np.testing.assert_allclose(lat.z2.numpy(), z2, rtol=1e-5, atol=3e-5)
    assert lat.latent_all.shape == (B_, 256, 128)
    if not train:  # and the eager encoder of the port
        ref = encode_latents(tp, torch.tensor(x), torch.tensor(thetas), torch.tensor(rois), lead_num=L)
        np.testing.assert_allclose(lat.latent_all.numpy(), ref.latent_all.numpy(), rtol=1e-5, atol=3e-5)


def _loss_jax(params, x, thetas, rois, masks, dtype, t1):
    def f(p):
        z1, z2g = jax_encode(p, x, thetas, rois, masks, dtype)
        return (jnp.sum(jnp.abs(z1.astype(jnp.float32) * t1[0]))
                + jnp.sum(z2g.astype(jnp.float32) * t1[1]))
    return jax.grad(f)(params)


def _loss_port(tp, x, thetas, rois, masks, dtype, t1, float64=False):
    """The same loss through the port's pair (mlp1 gate and ramp as
    make_fused_encode_fn builds them); grads by parameter key. float64: the
    plain version's float64 pass, loss in float64."""
    from electrocardio_panorama_tpu_torch.ops import angular_encode, linear, roi_align_ramp

    p = {k: v.clone().requires_grad_(k.split(".")[0] in ENC_PREFIXES) for k, v in tp.items()}
    gate = linear(angular_encode(torch.tensor(thetas)), p["mlp1.weight"], p["mlp1.bias"]).to(dtype)
    ramp = roi_align_ramp(torch.tensor(rois)).to(dtype)
    m = tuple(torch.tensor(a).to(dtype) for a in masks_model_layout(*masks))
    w = {k: p[k].to(dtype) for k in TE.WEIGHT_KEYS.values()}
    if float64:
        z1, z2g = TE.encoder_plain(w, torch.tensor(x).to(dtype), gate, ramp, m, lead_num=L, float64=True)
    else:
        z1, z2g = TE.encode_fused(w, torch.tensor(x).to(dtype), gate, ramp, m, lead_num=L)
    cd = torch.float64 if float64 else torch.float32
    loss = (torch.sum(torch.abs(z1.to(cd) * torch.tensor(t1[0]).to(cd)))
            + torch.sum(z2g.to(cd).reshape(x.shape[0], 128 * L, 7, 32) * torch.tensor(t1[1]).to(cd)))
    loss.backward()
    return {k: v.grad for k, v in p.items() if v.grad is not None}


@pytest.fixture(scope="module")
def cotangents():
    rng = np.random.default_rng(11)
    return (rng.normal(0, 1, (B, 128 * L, 128)).astype(np.float32),
            rng.normal(0, 1, (B, 128 * L, 7, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_grads_f32(inputs, cotangents):
    params, _, x, thetas, rois, masks = inputs
    return _loss_jax(params, x, thetas, rois, masks, jnp.float32, cotangents)


def test_plain_grads_f32_match_jax_interpret(inputs, cotangents, jax_grads_f32):
    params, tp, x, thetas, rois, masks = inputs
    gj = jax_grads_f32
    gp = _loss_port(tp, x, thetas, rois, masks, torch.float32, cotangents)
    keys = [k for k in params if k.split(".")[0] in ENC_PREFIXES]
    assert keys
    for k in keys:
        b = np.asarray(gj[k])
        if k.startswith(("w_conv.0.residual", "z2_conv2.0.residual")):
            assert k not in gp and np.all(b == 0), k  # unused residual convs
            continue
        grad_close(gp[k].numpy(), b, k)


def test_plain_bf16_matches_jax_interpret(inputs, cotangents, jax_grads_f32):
    params, tp, x, thetas, rois, masks = inputs
    z1, z2g = jax_encode(params, x, thetas, rois, masks, jnp.bfloat16)
    lat = port_encode(tp, x, thetas, rois, masks, torch.bfloat16)
    ours, ref = lat.z1.float().numpy(), np.asarray(z1, np.float32)
    np.testing.assert_allclose(ours, ref, atol=0.02)
    assert np.corrcoef(ours.ravel(), ref.ravel())[0, 1] > 0.9999
    gj = _loss_jax(params, x, thetas, rois, masks, jnp.bfloat16, cotangents)
    gp = _loss_port(tp, x, thetas, rois, masks, torch.bfloat16, cotangents)
    for k in gp:
        if k.startswith(("w_conv.0.residual", "z2_conv2.0.residual")):
            continue
        a, b = gp[k].float().numpy(), np.asarray(gj[k], np.float32)
        own = l2_rel(b, np.asarray(jax_grads_f32[k]))
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.995, k
        assert l2_rel(a, b) <= max(2 * own, 1e-2), f"{k}: {l2_rel(a, b):.2e} vs JAX's own {own:.2e}"


def test_plain_float64_pass_matches_f32_and_jax_interpret(inputs, cotangents, jax_grads_f32):
    """The plain version's float64 pass computes the f32 function: its
    forward and gradients agree with the f32 pass and with the JAX pair in
    interpret mode at the f32 bars; the f32 and bf16 passes are untouched
    (float64 takes float32 inputs only)."""
    from electrocardio_panorama_tpu_torch.ops import angular_encode, linear, roi_align_ramp

    params, tp, x, thetas, rois, masks = inputs
    z1j, z2j = jax_encode(params, x, thetas, rois, masks, jnp.float32)
    gate = linear(angular_encode(torch.tensor(thetas)), tp["mlp1.weight"], tp["mlp1.bias"])
    ramp = roi_align_ramp(torch.tensor(rois))
    m = tuple(torch.tensor(a) for a in masks_model_layout(*masks))
    w = {k: tp[k] for k in TE.WEIGHT_KEYS.values()}
    xt = torch.tensor(x)
    out64 = TE.encoder_plain(w, xt, gate, ramp, m, lead_num=L, float64=True)
    out32 = TE.encoder_plain(w, xt, gate, ramp, m, lead_num=L)
    assert all(t.dtype == torch.float64 for t in out64) and all(t.dtype == torch.float32 for t in out32)
    for a64, a32, aj in zip(out64, out32, (z1j, z2j)):
        np.testing.assert_allclose(a64.numpy(), a32.double().numpy(), rtol=1e-5, atol=3e-5)
        np.testing.assert_allclose(a64.numpy(), np.asarray(aj, np.float64).reshape(a64.shape), rtol=1e-5,
                                   atol=3e-5)
    g64 = _loss_port(tp, x, thetas, rois, masks, torch.float32, cotangents, float64=True)
    g32 = _loss_port(tp, x, thetas, rois, masks, torch.float32, cotangents)
    assert set(g64) == set(g32) and g64
    for k in g64:
        if k.startswith(("w_conv.0.residual", "z2_conv2.0.residual")):
            continue
        grad_close(g64[k].double().numpy(), g32[k].double().numpy(), k)
        grad_close(g64[k].double().numpy(), np.asarray(jax_grads_f32[k], np.float64), k)
    with pytest.raises(ValueError, match="float64"):
        TE.encoder_plain({k: v.bfloat16() for k, v in w.items()}, xt.bfloat16(), gate.bfloat16(),
                         ramp.bfloat16(), lead_num=L, float64=True)


def test_encode_fused_cpu_dispatch_and_checks(inputs):
    _, tp, x, thetas, rois, masks = inputs
    w = {k: tp[k] for k in TE.WEIGHT_KEYS.values()}
    xt = torch.tensor(x)
    gate = torch.ones(B, L, 128)
    ramp = torch.ones(B, 7, 16)
    launches = sum(TE.LAUNCHES.values())
    z1, z2g = TE.encode_fused(w, xt, gate, ramp, lead_num=L)
    assert z1.shape == (B, 128 * L, 128) and z2g.shape == (B, 896 * L, 32)
    assert sum(TE.LAUNCHES.values()) == launches  # the CPU never counts a kernel launch
    with pytest.raises(ValueError, match="gate must be"):
        TE.encode_fused(w, xt, gate[:, :2], ramp, lead_num=L)
    with pytest.raises(ValueError, match="storage dtype"):
        TE.encode_fused(w, xt.half(), gate, ramp, lead_num=L)
    with pytest.raises(ValueError, match="encoder_ckpt"):
        TE.ckpt_mode("some")
    assert [TE.ckpt_mode(v) for v in (False, "off", True, "tower", "full")] == \
        ["off", "off", "tower", "tower", "full"]
    # the masks drawn by draw_masks are pre-scaled 0 or 1/0.8
    m6, mc20, mc22 = TE.draw_masks(torch.Generator().manual_seed(0), 2, L)
    assert m6.shape == (6, 2, 128 * L, 128) and mc20.shape == (2, 896 * L, 16) and mc22.shape == (2, 896 * L, 32)
    vals = torch.unique(torch.cat([m6.ravel(), mc20.ravel(), mc22.ravel()]))
    torch.testing.assert_close(vals, torch.tensor([0.0, 1.25]))


def cuda_case(dtype, batch, lead_num):
    """Weights, inputs, masks and cotangents of a kernel test on the card."""
    dev = torch.device("cuda")
    sd = getattr(torch, dtype)
    _, tp, x, thetas, rois, masks = make_inputs(1, batch, lead_num)
    w = {k: tp[k].to(dev, sd) for k in TE.WEIGHT_KEYS.values()}
    rng = np.random.default_rng(5)
    xt = torch.tensor(x, device=dev, dtype=sd)
    gate = torch.tensor(rng.normal(0, 1, (batch, lead_num, 128)), dtype=sd, device=dev)
    ramp = torch.tensor(rng.uniform(0, 1, (batch, 7, 16)), dtype=sd, device=dev)
    m = tuple(torch.tensor(a, device=dev).to(sd) for a in masks_model_layout(*masks, lead_num=lead_num))
    dz1 = torch.tensor(rng.normal(0, 1, (batch, 128 * lead_num, 128)), dtype=sd, device=dev)
    dz2 = torch.tensor(rng.normal(0, 1, (batch, 896 * lead_num, 32)), dtype=sd, device=dev)
    return w, xt, gate, ramp, m, dz1, dz2


def corr(a, b):
    return np.corrcoef(a.ravel(), b.ravel())[0, 1] if np.abs(b).max() > 0 else 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("batch,lead_num", [(8, 3), (3, 1), (3, 2), (32, 3), (5, 3)],
                         ids=["B8L3", "B3L1", "B3L2", "B32L3", "B5L3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype, batch, lead_num):
    """The kernels against the plain version at the bars of PERF.md section 2,
    bitwise across encoder_ckpt off/tower/full and a repeat launch. B=3 and
    B=5 leave a ragged edge in the position tiles at T=16 and T=32 (64
    positions per conv block) and in the weight gradients' 32-position
    chunks; B=32, L=3 is the main path's shape. float32 gradients: A3 on the
    plain version's forward planes at the f32 bars, and end to end at L2 5e-3
    and corr > 0.9999 (the module docstring says why)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    w, xt, gate, ramp, m, dz1, dz2 = cuda_case(dtype, batch, lead_num)
    plain_planes = {}

    def run(plain, ckpt="tower"):
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        g = gate.clone().requires_grad_(True)
        with full_f32():  # the plain backward runs cuDNN's backward convs: TF32 off around it too
            if plain:
                z1, z2g = TE.encoder_plain(ws, xt, g, ramp, m, lead_num=lead_num, planes=plain_planes)
            else:
                z1, z2g = TE.encode_fused(ws, xt, g, ramp, m, lead_num=lead_num, ckpt=ckpt)
            torch.autograd.backward([z1, z2g], [dz1, dz2])
        return (z1.detach(), z2g.detach()), {"gate": g.grad, **{k: v.grad for k, v in ws.items()}}

    (pz1, pz2), pg = run(True)
    if dtype == "float32":  # A3 on the plain version's forward planes
        kept = {n: v.detach() for n, v in plain_planes.items()}
        on_plain = dict(zip(pg, TE.backward_cuda(w, xt, gate, ramp, m, kept, dz1, dz2, lead_num=lead_num,
                                                 mode="full")))
    outs, grads = {}, {}
    for ckpt in ("off", "tower", "full", "repeat"):
        outs[ckpt], grads[ckpt] = run(False, "tower" if ckpt == "repeat" else ckpt)
        torch.cuda.synchronize()
        for got, ref in zip(outs[ckpt], (pz1, pz2)):
            got, ref = got.float(), ref.float()
            err = float((got - ref).abs().max())
            if dtype == "float32":
                assert err <= 2e-5
            else:
                assert err <= 0.05 and err <= 2.0 ** -5 * float(ref.abs().max())
                assert corr(got.cpu().numpy(), ref.cpu().numpy()) > 0.9999
    for k in pg:
        for ckpt in ("tower", "full", "repeat"):
            assert torch.equal(grads[ckpt][k], grads["off"][k]), (ckpt, k)
        for i in range(2):
            assert torch.equal(outs["repeat"][i], outs["off"][i])
        if k.startswith(("w_conv.0.residual", "z2_conv2.0.residual")):
            continue
        a, b = grads["off"][k].float().cpu().numpy(), pg[k].float().cpu().numpy()
        if dtype == "float32":
            grad_close(on_plain[k].cpu().numpy(), b, k)
            assert corr(a, b) > 0.9999, k
            assert l2_rel(a, b) <= 5e-3, f"{k}: end-to-end grad L2 rel err {l2_rel(a, b):.2e}"
        else:
            assert corr(a, b) > 0.995, k
            assert l2_rel(a, b) <= 5e-2, f"{k}: grad L2 rel err {l2_rel(a, b):.2e}"


@pytest.mark.cuda
def test_cuda_f32_launches_repeat_bitwise():
    """The float32 instantiation (the FMA engine, conv1 on SIMT kernels):
    every forward plane and every gradient of a second launch on the same
    inputs is bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    w, xt, gate, ramp, m, dz1, dz2 = cuda_case("float32", B, L)
    planes = [TE.forward_cuda(w, xt, gate, ramp, m, lead_num=L) for _ in range(2)]
    for name in TE.PLANES:
        assert torch.equal(planes[0][name], planes[1][name]), name
    kept = {n: planes[0][n] for n in TE.PLANES}
    grads = [TE.backward_cuda(w, xt, gate, ramp, m, kept, dz1, dz2, lead_num=L, mode="full") for _ in range(2)]
    for name, a, b in zip(["gate", *TE.WEIGHT_KEYS.values()], *grads):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_f32_fused_render_encodes_through_a2():
    """A float32 Nef-Net render under use_fused at B=32 and 12 views launches
    A2 once (its eval form), and its views match the eager encode's latents
    decoded by A1 on the same inputs within the render cell's view_gap limit
    (max |difference| 1.3e-6, portbench/cells/nefnet.render.f32.v336.json)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from electrocardio_panorama_tpu_torch.models import NefNetDef, init_nefnet
    from electrocardio_panorama_tpu_torch.ops import angular_encode
    from electrocardio_panorama_tpu_torch.ops.kernels.decoder_fused import fused_decode_views
    from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator, theta_grid

    dev, batch = torch.device("cuda"), 32
    params, state = init_nefnet(torch.Generator().manual_seed(2), lead_num=L, device=dev)
    rng = np.random.default_rng(2)
    for k in state:  # non-trivial BatchNorm running statistics for A1's fold
        if k.endswith("running_mean"):
            state[k] = torch.tensor(rng.normal(0, 0.1, state[k].shape), dtype=torch.float32, device=dev)
        elif k.endswith("running_var"):
            state[k] = torch.tensor(rng.uniform(0.5, 2.0, state[k].shape), dtype=torch.float32, device=dev)
    _, _, x, thetas, rois, _ = make_inputs(2, batch, L)
    inputs = [torch.tensor(a, device=dev) for a in (x, thetas, rois)]
    views = torch.tensor(theta_grid(3, 4), device=dev)
    model = NefNetDef(L)
    gen = PanoramaGenerator(model, params, state, use_fused=True, device=dev)
    before = TE.LAUNCHES["fwd_float32"]
    out = gen.render(*inputs, views)
    torch.cuda.synchronize()
    assert TE.LAUNCHES["fwd_float32"] - before == 1
    with torch.no_grad():
        latent = model.encode(params, *inputs).latent_all
        enc = angular_encode(views[None].expand(batch, -1, -1), model.theta_encoder_len)
        want = fused_decode_views(gen._folded, latent, enc=enc, v_tile=gen.v_tile)
    assert out.shape == want.shape == (batch, 12, 512)
    gap = float((out.double() - want.double()).abs().max())
    assert gap <= 1.3e-6, f"view gap {gap:.3e}"


def test_backward_sections_name_the_chain():
    """The section timer's names, in the order the A3 chain marks them."""
    assert TE.SECTIONS == ["recompute", "z2_conv2", "roi + z-blocks", "w_conv + gate", "tower",
                           "maxpool + conv1"]
    import os
    src = open(os.path.join(os.path.dirname(TE.__file__), "csrc", "encoder_bwd.cu")).read()
    body = src[src.index("int backward("):src.index("long long encoder_bwd_workspace_floats")]
    assert body.count("timer.mark();") == len(TE.SECTIONS)


def test_backward_section_ms_needs_cuda_tensors(inputs):
    _, tp, x, *_ = inputs
    w = {k: tp[k] for k in TE.WEIGHT_KEYS.values()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        TE.backward_section_ms(w, torch.tensor(x), torch.ones(B, L, 128), torch.ones(B, 7, 16),
                               TE.draw_masks(torch.Generator().manual_seed(0), B, L), {}, None, None,
                               lead_num=L, mode="tower")


def test_profile_encoder_inputs_and_device_check():
    """The encoder profiler's inputs have the kernels' shapes; it refuses the
    CPU (the kernels have no CPU mode)."""
    from electrocardio_panorama_tpu_torch import profile_encoder as PE

    t = PE.inputs(2, torch.float32, torch.device("cpu"))
    TE._check(t["w"], t["x"], t["gate"], t["ramp"], t["masks"], PE.LEADS)
    assert t["dz1"].shape == (2, 128 * PE.LEADS, 128) and t["dz2"].shape == (2, 896 * PE.LEADS, 32)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        PE.main(["--device", "cpu"])


def test_wrapper_entry_points_are_exported():
    """Every C entry point the wrapper loads, per kind and storage type (the
    launch, its workspace size in floats), is exported by its source."""
    import os
    import re

    for kind in ("fwd", "bwd"):
        src = open(os.path.join(os.path.dirname(TE.__file__), "csrc", f"encoder_{kind}.cu")).read()
        exported = set(re.findall(r'extern "C" [\w\s\*]*?\b(encoder_\w+)\(', src))
        for suffix in ("f32", "bf16"):
            assert {f"encoder_{kind}_{suffix}", f"encoder_{kind}_workspace_floats_{suffix}"} <= exported, kind
        assert {f"encoder_{kind}_nptr", f"encoder_{kind}_error_string", f"encoder_{kind}_error_file",
                f"encoder_{kind}_error_line"} <= exported, kind


def test_compare_builds_counts_bitwise_equal_tensors():
    """compare_builds holds two dumps tensor by tensor; it needs a card."""
    from electrocardio_panorama_tpu_torch import compare_builds as CB

    a = {"plane P_C": torch.ones(2, 3), "grad gate": torch.zeros(4)}
    b = {"plane P_C": torch.ones(2, 3), "grad gate": torch.tensor([0.0, 0.5, 0.0, -1.0])}
    assert CB.compare(a, a) == {"tensors": 2, "bitwise_equal": 2, "differ": [], "max_abs_diff": 0.0}
    assert CB.compare(a, b) == {"tensors": 2, "bitwise_equal": 1, "differ": ["grad gate"], "max_abs_diff": 1.0}
    with pytest.raises(ValueError, match="other tensors"):
        CB.compare(a, {"plane P_C": a["plane P_C"]})
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            CB.main(["."])
