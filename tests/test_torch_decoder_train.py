"""Fused train decoder (kernels A4f/A4b): the port's plain version against the
JAX package's Pallas kernel pair in interpret mode, on the CPU, at a
per-group batch of 2 (3 groups, full width).

Tolerances:
  * float32 forward: out atol 3e-6, the running-stat updates rtol 1e-5 /
    atol 1e-6 (the bars of tests/test_pallas_train_decoder.py:40-44);
  * float32 gradients of sum|out - 0.4| with respect to x and every decoder
    parameter, against the JAX kernel pair's custom VJP: rtol 2e-4 / atol 2e-5
    (test_pallas_train_decoder.py:63-67). The conv biases that sit right
    before a train-mode BN get rounding noise on both sides (the batch mean
    cancels them) and are held to be tiny instead;
  * bfloat16: corr > 0.999 against the float32 reference, as the JAX
    package's own test has it, and atol 2e-3 on the output (running-stat
    updates rtol 1e-3 / atol 1e-4) against the JAX bfloat16 interpret
    result. The two round at the same points except the TPU kernel's
    upsample matmuls, which round one more intermediate, so they sit about
    as far from each other (9.5e-4 here) as each sits from float32 (1.2e-3,
    1.0e-3): a bf16 ulp of a pre-sigmoid value near 1 is 2^-8, and up to a
    twelfth of it reaches the output;
  * the plain version against the port's eager grouped decode
    (`decoder_apply(train=True, bn_groups=3)`): out atol 1e-6, updates atol
    1e-6, gradients rtol 1e-4 / atol 1e-5 (same arithmetic, other order);
  * the plain version's float64 pass (the third point the card's float32
    kernels are measured against) against its float32 pass and the JAX
    kernel pair: the float32 bars above;
  * the CUDA kernels against the plain version (card only): float32 out
    2e-5, moments 1e-5, gradients L2 relative 5e-3 and corr > 0.9999 with
    the model's BN offsets and L2 2e-4 with every relu open, the conv
    biases before a BN at their noise level (PERF.md section 2);
  * bfloat16 moments: the plain version and (card only) the kernel each
    within `BF16_MOMENTS_BAR` (allclose form, `moments_distance`) of the
    float64 pass on 16 input sets, and the kernel within 1e-3 of the plain
    version; the bar is derived from the plain version alone (its comment in
    ops/kernels/decoder_train.py);
  * bfloat16 A4f on the tensor-core engine against the plain version (card
    only): out 2e-3 and corr > 0.9999, the moments bar above, bitwise
    repeats;
  * the input-resolution form of an upsampled conv (`upconv_taps_plain`, the
    bfloat16 forward's identity) against conv1d(upsample_linear_x2(x)):
    rtol = atol = 1e-6 in float32 (the same products summed in another
    order, values of order 1) and 1e-12 in float64; against the JAX
    package's `_upconv_fwd` with float32 weights: rtol = atol = 2e-6 (its
    products run as two float32 matmuls, W_k x then the upsample matrix).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.models.nefnet import init_nefnet as jax_init_nefnet
from electrocardio_panorama_tpu.ops.pallas import decoder_train as jt
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models import decoder_apply
from electrocardio_panorama_tpu_torch.ops.convs import group_batch_norm1d
from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as dt

NB = 2  # per-group batch
# conv biases right before a train-mode BN: their gradient is rounding noise
BN_CANCELLED = tuple(f"decoder.{i}.double_conv.{j}.bias" for i in (1, 3) for j in (0, 3))


@pytest.fixture(scope="module")
def setup():
    params, state = jax_init_nefnet(jax.random.PRNGKey(0), lead_num=3)
    rng = np.random.default_rng(5)
    # non-trivial BN affines and running statistics
    params = {k: (v + jnp.asarray(rng.normal(0, 0.2, v.shape).astype(np.float32))
                  if ".double_conv.1." in k or ".double_conv.4." in k else v) for k, v in params.items()}
    state = {k: (v + 0.3 if v.dtype != np.int32 else v) for k, v in state.items()}
    stacked = rng.normal(0, 0.5, (3 * NB, 256, 128)).astype(np.float32)
    tp, ts = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                             {k: np.asarray(v) for k, v in state.items()})
    return params, state, stacked, tp, ts


def decoder_keys(params):
    return [k for k in params if k.startswith("decoder.")]


def port_loss_and_grads(fn, tp, ts, stacked):
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x = torch.tensor(stacked, requires_grad=True)
    out, updates = fn(p, ts, x)
    (out - 0.4).abs().sum().backward()
    return out.detach(), updates, x.grad, {k: p[k].grad for k in decoder_keys(p)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_train_weights_matches_jax(setup, dtype):
    params, _, _, tp, _ = setup
    ref = jt.pack_train_weights(params, dtype=jnp.dtype(dtype))
    ours = dt.pack_train_weights(tp, dtype=getattr(torch, dtype))
    assert list(ours) != [] and set(ours) == set(ref) == set(dt.WNAMES)
    for k in ref:
        assert str(ours[k].dtype).removeprefix("torch.") == str(ref[k].dtype), k
        np.testing.assert_array_equal(ours[k].float().numpy(), np.asarray(ref[k], np.float32), err_msg=k)


def test_chain_running_stats_matches_jax_and_group_bn(setup):
    _, state, _, _, ts = setup
    rng = np.random.default_rng(7)
    mean = rng.normal(0, 1, (3, 4, 128)).astype(np.float32)
    var = rng.uniform(0.5, 2, (3, 4, 128)).astype(np.float32)
    ref = jt.chain_running_stats(state, jnp.asarray(mean), jnp.asarray(var), NB)
    ours = dt.chain_running_stats(ts, torch.tensor(mean), torch.tensor(var), NB)
    assert set(ours) == set(ref) and len(ours) == 12
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    # and the port's grouped BN on a plane with exactly these group moments
    key, (c, t) = dt.BN_KEYS[2], dt.BN_SHAPES[2]
    x = torch.tensor(rng.normal(0, 1, (3 * NB, c, t)).astype(np.float32))
    xg = x.reshape(3, NB, c, t)
    m, v = xg.mean(dim=(1, 3)), xg.var(dim=(1, 3), unbiased=False)
    pad = torch.zeros(3, 4, 128)
    mean_t, var_t = pad.clone(), pad.clone()
    mean_t[:, 2, :c], var_t[:, 2, :c] = m, v
    _, new_mean, new_var = group_batch_norm1d(x, torch.ones(c), torch.zeros(c), ts[f"{key}.running_mean"],
                                              ts[f"{key}.running_var"], groups=3)
    ours = dt.chain_running_stats(ts, mean_t, var_t, NB)
    torch.testing.assert_close(ours[f"{key}.running_mean"], new_mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ours[f"{key}.running_var"], new_var, rtol=1e-6, atol=1e-7)


def test_forward_and_stats_match_jax_kernel(setup):
    params, state, stacked, tp, ts = setup
    ref_out, ref_u = jt.make_train_decode_fn(interpret=True)(params, state, jnp.asarray(stacked))
    with torch.no_grad():
        out, u = dt.make_train_decode_fn()(tp, ts, torch.tensor(stacked))
    assert out.shape == (3, NB, 1, 512) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-6)
    assert set(u) == set(ref_u)
    for k in ref_u:
        np.testing.assert_allclose(u[k].numpy(), np.asarray(ref_u[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(u[k]) == int(np.asarray(state[k])) + 3


@pytest.fixture(scope="module")
def jax_pair_grads(setup):
    """Gradients of sum|out - 0.4| through the JAX custom VJP (the
    recomputing backward kernel in interpret mode), not the XLA grouped
    decode: (d stacked, {param: grad})."""
    params, state, stacked, _, _ = setup
    fn = jt.make_train_decode_fn(interpret=True)

    def loss(p, x):
        out, _ = fn(p, state, x)
        return jnp.sum(jnp.abs(out - 0.4))

    return jax.grad(loss, argnums=(1, 0))(params, jnp.asarray(stacked))


def test_gradients_match_jax_kernel_pair(setup, jax_pair_grads):
    """Against the JAX custom VJP (the recomputing backward kernel in
    interpret mode), not the XLA grouped decode."""
    _, _, stacked, tp, ts = setup
    gx_ref, gp_ref = jax_pair_grads
    _, _, gx, gp = port_loss_and_grads(dt.make_train_decode_fn(), tp, ts, stacked)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_ref), rtol=2e-4, atol=2e-5)
    assert len(gp) == 18
    for k, g in gp.items():
        if k in BN_CANCELLED:
            assert float(g.abs().max()) < 1e-4 and float(np.abs(np.asarray(gp_ref[k])).max()) < 1e-4, k
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(gp_ref[k]), rtol=2e-4, atol=2e-5, err_msg=k)


def test_plain_float64_pass_matches_f32_and_jax_kernel_pair(setup, jax_pair_grads):
    """The plain version's float64 pass computes the float32 function: its
    out, moments and 18 gradients agree with the float32 pass and with the
    JAX kernel pair in interpret mode at the float32 bars; it takes float32
    inputs only."""
    params, _, stacked, tp, ts = setup
    gx_ref, gp_ref = jax_pair_grads

    def plain64(p, s, st):
        x = st.reshape(3, NB, 256, 128).permute(0, 2, 1, 3).reshape(3, 256, NB * 128)
        out, mean, var = dt.train_decode_groups_plain(dt.pack_train_weights(p), x, float64=True)
        return out.reshape(3, NB, 1, 512), (mean, var)

    out64, (mean64, var64), gx64, gp64 = port_loss_and_grads(plain64, tp, ts, stacked)
    out32, _, gx32, gp32 = port_loss_and_grads(dt.make_train_decode_fn(), tp, ts, stacked)
    assert out64.dtype == mean64.dtype == var64.dtype == torch.float64 and out32.dtype == torch.float32
    xj = jnp.asarray(stacked).reshape(3, NB, 256, 128).transpose(0, 2, 1, 3).reshape(3, 256, NB * 128)
    out_j, mean_j, var_j = jt.train_decode_groups(jt.pack_train_weights(params), xj, True)
    w32 = dt.pack_train_weights(tp)
    x32 = torch.tensor(stacked).reshape(3, NB, 256, 128).permute(0, 2, 1, 3).reshape(3, 256, NB * 128)
    with torch.no_grad():
        _, mean32, var32 = dt.train_decode_groups_plain(w32, x32)
    for ref in (out32.double().numpy(), np.asarray(out_j, np.float64).reshape(3, NB, 1, 512)):
        np.testing.assert_allclose(out64.numpy(), ref, atol=3e-6)
    for m64, refs in ((mean64, (mean32, mean_j)), (var64, (var32, var_j))):
        for ref in refs:
            np.testing.assert_allclose(m64.numpy(), np.asarray(ref, np.float64), rtol=1e-5, atol=1e-6)
    for ref in (gx32.numpy(), np.asarray(gx_ref)):
        np.testing.assert_allclose(gx64.numpy(), ref, rtol=2e-4, atol=2e-5)
    assert len(gp64) == 18 and set(gp64) == set(gp32)
    for k, g in gp64.items():
        if k in BN_CANCELLED:
            assert float(g.abs().max()) < 1e-4, k
            continue
        for ref in (gp32[k].numpy(), np.asarray(gp_ref[k])):
            np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=2e-5, err_msg=k)
    with pytest.raises(ValueError, match="float64"):
        dt.train_decode_groups_plain({k: v.double() for k, v in w32.items()}, x32.double(), float64=True)


def test_plain_float64_pass_takes_bf16_storage(setup):
    """From bfloat16 storage the float64 pass upcasts w and x exactly and
    rounds nothing after: it equals the float64 pass of the same values
    stored in float32, bit for bit. Mixed storage types raise."""
    _, _, stacked, tp, _ = setup
    w16 = dt.pack_train_weights(tp, dtype=torch.bfloat16)
    x16 = torch.tensor(stacked).reshape(3, NB, 256, 128).permute(0, 2, 1, 3).reshape(3, 256, NB * 128).bfloat16()
    with torch.no_grad():
        got = dt.train_decode_groups_plain(w16, x16, float64=True)
        want = dt.train_decode_groups_plain({k: v.float() for k, v in w16.items()}, x16.float(), float64=True)
    assert all(t.dtype == torch.float64 for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="float64"):
        dt.train_decode_groups_plain(w16, x16.float(), float64=True)


def bar_sets(setup):
    """The 16 input sets of dt.BF16_MOMENTS_BAR: (name, x float32 [3, 256,
    nb*128]) for the test's own set at nb 2 and, at 3 groups of 32, x as
    _cuda_inputs draws it from each seed of dt.BF16_BAR_SEEDS."""
    stacked = setup[2]
    yield "setup nb 2", torch.tensor(stacked).reshape(3, NB, 256, 128).permute(0, 2, 1, 3).reshape(3, 256, NB * 128)
    for seed in dt.BF16_BAR_SEEDS:
        x = np.random.default_rng(seed).normal(0, 0.5, (3, 256, 32 * 128)).astype(np.float32)
        yield f"seed {seed} nb 32", torch.tensor(x)


def test_plain_bf16_moments_within_the_float64_bar(setup):
    """On each of the 16 sets the plain version's bfloat16 moments lie within
    BF16_MOMENTS_BAR of the float64 pass, and the bar is at most 2.5 times
    the largest distance, so it cannot drift loose unnoticed."""
    w16 = dt.pack_train_weights(setup[3], dtype=torch.bfloat16)
    cs = {}
    with torch.no_grad():
        for name, x in bar_sets(setup):
            x16 = x.bfloat16()
            _, mean, var = dt.train_decode_groups_plain(w16, x16)
            _, mean64, var64 = dt.train_decode_groups_plain(w16, x16, float64=True)
            cs[name] = dt.moments_distance((mean, var), (mean64, var64))
    assert len(cs) == 16
    assert max(cs.values()) <= dt.BF16_MOMENTS_BAR, cs
    assert dt.BF16_MOMENTS_BAR <= 2.5 * max(cs.values()), cs
    # the distance is the allclose form: a moment moved by the bar's excess fails
    _, mean, var = dt.train_decode_groups_plain(w16, next(bar_sets(setup))[1].bfloat16())
    assert dt.moments_distance((mean + 2 * dt.BF16_MOMENTS_BAR, var), (mean, var)) > dt.BF16_MOMENTS_BAR


def test_bf16_storage_matches_jax_bf16_and_correlates(setup):
    params, state, stacked, tp, ts = setup
    ref32, _ = jt.make_train_decode_fn(interpret=True)(params, state, jnp.asarray(stacked))
    p16 = {k: v.astype(jnp.bfloat16) for k, v in params.items()}
    ref16, ref_u = jt.make_train_decode_fn(compute_dtype=jnp.bfloat16, interpret=True)(
        p16, state, jnp.asarray(stacked).astype(jnp.bfloat16))
    t16 = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    with torch.no_grad():
        out, u = dt.make_train_decode_fn(torch.bfloat16)(t16, ts, torch.tensor(stacked).to(torch.bfloat16))
    assert out.dtype == torch.float32
    a = out.numpy().astype(np.float64).ravel()
    corr = np.corrcoef(a, np.asarray(ref32, np.float64).ravel())[0, 1]
    assert corr > 0.999, corr
    np.testing.assert_allclose(out.numpy(), np.asarray(ref16, np.float32), atol=2e-3)
    for k in ref_u:  # float32 state in, float32 updates out
        assert u[k].dtype in (torch.float32, torch.int64), k
        np.testing.assert_allclose(u[k].numpy(), np.asarray(ref_u[k], np.float32), rtol=1e-3, atol=1e-4, err_msg=k)


def test_plain_matches_port_eager_grouped_decode(setup):
    _, _, stacked, tp, ts = setup

    def eager(p, s, x):
        o, u = decoder_apply(p, s, x, train=True, bn_groups=3)
        return torch.sigmoid(o / 3.0).reshape(3, NB, 1, 512), u

    ref_out, ref_u, ref_gx, ref_gp = port_loss_and_grads(eager, tp, ts, stacked)
    out, u, gx, gp = port_loss_and_grads(dt.make_train_decode_fn(), tp, ts, stacked)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-6)
    assert set(u) == set(ref_u)
    for k in ref_u:
        torch.testing.assert_close(u[k].float(), ref_u[k].float(), rtol=1e-6, atol=1e-6, msg=k)
    torch.testing.assert_close(gx, ref_gx, rtol=1e-4, atol=1e-5)
    for k in ref_gp:
        if k in BN_CANCELLED:
            assert float(gp[k].abs().max()) < 1e-4, k
            continue
        torch.testing.assert_close(gp[k], ref_gp[k], rtol=1e-4, atol=1e-5, msg=k)


def test_cpu_dispatch_and_checks(setup):
    _, _, stacked, tp, _ = setup
    w = dt.pack_train_weights(tp)
    x = torch.tensor(stacked).reshape(3, NB, 256, 128).permute(0, 2, 1, 3).reshape(3, 256, NB * 128)
    launches = sum(dt.LAUNCHES.values())
    out, mean, var = dt.train_decode_groups(w, x)
    assert sum(dt.LAUNCHES.values()) == launches  # the CPU never counts a kernel launch
    assert out.shape == (3, NB, 512) and mean.shape == var.shape == (3, 4, 128)
    assert not mean.requires_grad and not var.requires_grad
    assert float(mean[:, 2:, 64:].abs().max()) == 0 and float(var[:, 2:, 64:].abs().max()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        dt.forward_cuda(w, x)
    with pytest.raises(ValueError, match="CUDA"):
        dt.backward_cuda(w, x, torch.zeros(3, NB, 512))
    with pytest.raises(ValueError, match="x must be"):
        dt.train_decode_groups(w, x[:, :, :100])
    with pytest.raises(ValueError, match="w\\['w1'\\]"):
        dt.train_decode_groups(w, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="storage dtype"):
        dt.train_decode_groups(w, x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(setup, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from electrocardio_panorama_tpu_torch.ops import full_f32

    _, _, stacked, tp, _ = setup
    dev, sd = torch.device("cuda"), getattr(torch, dtype)
    w = {k: v.to(dev) for k, v in dt.pack_train_weights(tp, dtype=sd).items()}
    x0 = (torch.tensor(stacked).reshape(3, NB, 256, 128).permute(0, 2, 1, 3).reshape(3, 256, NB * 128)
          .to(dev, sd))
    dout = torch.tensor(np.random.default_rng(1).normal(0, 1, (3, NB, 512)).astype(np.float32), device=dev)

    def run(plain):
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        x = x0.clone().requires_grad_(True)
        with full_f32():
            out, mean, var = dt.train_decode_groups(ws, x, plain=plain)
            out.backward(dout)
        return out.detach(), mean, var, {"x": x.grad, **{k: v.grad for k, v in ws.items()}}

    before = dict(dt.LAUNCHES)
    ref, got = run(True), run(False)
    torch.cuda.synchronize()
    assert dt.LAUNCHES[f"fwd_{dtype}"] == before.get(f"fwd_{dtype}", 0) + 1
    assert dt.LAUNCHES[f"bwd_{dtype}"] == before.get(f"bwd_{dtype}", 0) + 1
    f32 = dtype == "float32"
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=2e-5 if f32 else 2e-3)
    if f32:
        for a, b in ((got[1], ref[1]), (got[2], ref[2])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert_bf16_moments_bar(w, x0, got[1:3], ref[1:3])
    for k, b in ref[3].items():
        a, b = got[3][k].float(), b.float()
        if k in ("b1", "b2", "b3", "b4"):
            assert float(a.abs().max()) < 1e-3, k
            continue
        # a relu mask that flips at a pre-activation within rounding of 0 moves
        # a whole term of a per-channel sum, so the bar is on the energy
        l2 = float((a - b).norm() / b.norm().clamp_min(1e-12))
        assert l2 <= (5e-3 if f32 else 5e-2), f"{k}: L2 relative {l2:.2e}"


def test_backward_cuda_checks_planes(setup):
    """The planes argument of backward_cuda is checked before any launch: a
    missing plane, a wrong shape, dtype or device, or a non-contiguous plane
    raises ValueError; right planes reach the CUDA check."""
    _, _, stacked, tp, _ = setup
    w = dt.pack_train_weights(tp)
    x = torch.tensor(stacked).reshape(3, NB, 256, 128).permute(0, 2, 1, 3).reshape(3, 256, NB * 128)
    dout = torch.zeros(3, NB, 512)
    planes = dt._planes(3, NB, torch.float32, x.device)
    assert list(planes) == dt.PLANES
    launches = sum(dt.LAUNCHES.values())
    bad = {
        "missing": {k: v for k, v in planes.items() if k != "P_H4"},
        "shape": {**planes, "P_A3": torch.zeros(3 * NB, 64, 256)},
        "dtype": {**planes, "P_H1": planes["P_H1"].to(torch.bfloat16)},
        "device": {**planes, "OUT": torch.empty(3, NB, 512, device="meta")},
        "contiguous": {**planes, "P_A1": planes["P_A1"].transpose(1, 2).contiguous().transpose(1, 2)},
    }
    for p in bad.values():
        with pytest.raises(ValueError, match="planes"):
            dt.backward_cuda(w, x, dout, p)
    # bfloat16 storage wants h1..h3 in bfloat16
    w16, x16 = dt.pack_train_weights(tp, dtype=torch.bfloat16), x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="planes\\['P_H1'\\]"):
        dt.backward_cuda(w16, x16, dout, planes)
    with pytest.raises(ValueError, match="CUDA"):
        dt.backward_cuda(w, x, dout, planes)
    with pytest.raises(ValueError, match="CUDA"):
        dt.backward_cuda(w16, x16, dout, dt._planes(3, NB, torch.bfloat16, x.device))
    assert sum(dt.LAUNCHES.values()) == launches


def test_compare_builds_a4_dump_keys():
    """compare_builds' A4 dump holds out, mean, var, dx and the 18 parameter
    gradients; on the CPU the same autograd path runs the plain version."""
    from electrocardio_panorama_tpu_torch import compare_builds as CB

    d = CB.a4_dump(dt, "float32", torch.device("cpu"), nb=2)
    assert set(d) == {"A4 out", "A4 mean", "A4 var", "A4 grad dx", *(f"A4 grad {k}" for k in dt.WNAMES)}
    assert len(d) == 22 and all(k.startswith(CB.FAMILIES["A4"]) for k in d)
    assert not any(k.startswith(CB.FAMILIES["A2/A3"]) for k in d)
    assert d["A4 out"].shape == (3, 2, 512) and d["A4 grad dx"].shape == (3, 256, 256)
    assert all(bool(torch.isfinite(v.float()).all()) for v in d.values())
    # the inputs come from a seed: a second dump is the same
    d2 = CB.a4_dump(dt, "float32", torch.device("cpu"), nb=2)
    assert all(torch.equal(d[k], d2[k]) for k in d)


def assert_bf16_moments_bar(w, x, got, ref) -> tuple[float, float, float]:
    """bfloat16 moments: the kernel's (got) and the plain version's (ref)
    each within BF16_MOMENTS_BAR of the float64 pass, and the kernel within
    1e-3 of the plain version (chip_smoke.py DEC_BF16_STAT). Returns
    (c kernel, c plain, c kernel vs plain)."""
    with torch.no_grad():
        _, mean64, var64 = dt.train_decode_groups_plain(w, x, float64=True)
    c_kernel = dt.moments_distance(got, (mean64, var64))
    c_plain = dt.moments_distance(ref, (mean64, var64))
    gap = dt.moments_distance(got, ref)
    assert c_kernel <= dt.BF16_MOMENTS_BAR and c_plain <= dt.BF16_MOMENTS_BAR and gap <= 1e-3, (c_kernel, c_plain, gap)
    return c_kernel, c_plain, gap


@pytest.mark.cuda
def test_cuda_bf16_moments_within_the_float64_bar(setup):
    """bfloat16 A4f on the 16 sets of BF16_MOMENTS_BAR: its moments and the
    plain version's each within the bar of the float64 pass, and within 1e-3
    of each other. Prints, per set, both distances and the kernel-vs-plain
    gap over the former 1e-5 bar (run with -s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    w = {k: v.to(dev) for k, v in dt.pack_train_weights(setup[3], dtype=torch.bfloat16).items()}
    for name, x in bar_sets(setup):
        x = x.to(dev, torch.bfloat16)
        with torch.no_grad():
            ref = dt.train_decode_groups(w, x, plain=True)
            got = dt.train_decode_groups(w, x)
        torch.cuda.synchronize()
        c_kernel, c_plain, gap = assert_bf16_moments_bar(w, x, got[1:], ref[1:])
        print(f"bf16 moments bar {dt.BF16_MOMENTS_BAR:.1e}, {name}: c(kernel) {c_kernel:.4e}, c(plain) "
              f"{c_plain:.4e}, kernel vs plain / 1e-5 {gap / 1e-5:.3f} on {torch.cuda.get_device_name(0)}")


def _cuda_inputs(tp, dtype, nb, seed=11):
    dev, sd = torch.device("cuda"), getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    w = {k: v.to(dev) for k, v in dt.pack_train_weights(tp, dtype=sd).items()}
    x = torch.tensor(rng.normal(0, 0.5, (3, 256, nb * 128)).astype(np.float32), device=dev).to(sd)
    dout = torch.tensor(rng.normal(0, 1, (3, nb, 512)).astype(np.float32), device=dev)
    return w, x, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_on_kept_planes_is_bitwise(setup, dtype):
    """A4b on A4f's kept planes equals backward_cuda(w, x, dout) with its own
    A4f launch, and a repeat launch, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    w, x, dout = _cuda_inputs(setup[3], dtype, nb=32)
    planes = dt.forward_cuda(w, x)
    kept = dt.backward_cuda(w, x, dout, planes)
    again = dt.backward_cuda(w, x, dout, planes)
    own = dt.backward_cuda(w, x, dout)
    torch.cuda.synchronize()
    assert len(kept) == 19
    for i, name in enumerate(["x", *dt.WNAMES]):
        assert torch.equal(kept[i], own[i]), name
        assert torch.equal(kept[i], again[i]), name
        assert bool(torch.isfinite(kept[i]).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [32, 5])
def test_cuda_bf16_backward_matches_plain(setup, nb):
    """bfloat16 A4b (tensor cores) against the plain version at the PERF.md
    section 2 bars: output max abs error 2e-3; gradients corr > 0.995 and L2
    relative 5e-2 (the conv biases before a BN: rounding noise, |g| < 1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from electrocardio_panorama_tpu_torch.ops import full_f32

    w, x0, dout = _cuda_inputs(setup[3], "bfloat16", nb)

    def run(plain):
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        x = x0.clone().requires_grad_(True)
        with full_f32():
            out, _, _ = dt.train_decode_groups(ws, x, plain=plain)
            out.backward(dout)
        return out.detach(), {"x": x.grad, **{k: v.grad for k, v in ws.items()}}

    (ref_out, ref), (out, got) = run(True), run(False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, rtol=0, atol=2e-3)
    for k, b in ref.items():
        a, b = got[k].float(), b.float()
        assert bool(torch.isfinite(a).all()), k
        if k in ("b1", "b2", "b3", "b4"):
            assert float(a.abs().max()) < 1e-3, k
            continue
        l2 = float((a - b).norm() / b.norm().clamp_min(1e-12))
        corr = float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1]) if a.numel() > 1 else 1.0
        assert l2 <= 5e-2 and corr > 0.995, f"{k}: L2 relative {l2:.2e}, corr {corr:.6f}"


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [32, 5])
def test_cuda_f32_backward_matches_plain(setup, nb):
    """float32 A4b (the FMA engine) against the plain version at the PERF.md
    section 2 bars: output max abs error 2e-5, moments 1e-5; gradients L2
    relative 5e-3 and corr > 0.9999 with the model's BN offsets, and L2
    relative 2e-4 with the offsets at +8 (every relu open: summation order
    alone); the conv biases before a BN at their noise level (|g| <= 1e-3).
    nb = 5 leaves the weight gradients' position ranges uneven."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from electrocardio_panorama_tpu_torch.ops import full_f32

    w, x0, dout = _cuda_inputs(setup[3], "float32", nb)

    def run(ws0, plain):
        ws = {k: v.clone().requires_grad_(True) for k, v in ws0.items()}
        x = x0.clone().requires_grad_(True)
        with full_f32():
            out, mean, var = dt.train_decode_groups(ws, x, plain=plain)
            out.backward(dout)
        return out.detach(), mean, var, {"x": x.grad, **{k: v.grad for k, v in ws.items()}}

    before = dt.LAUNCHES["bwd_float32"]
    w_open = {k: (v + 8.0 if k[0] == "o" else v) for k, v in w.items()}
    for ws0, l2_bar in ((w, 5e-3), (w_open, 2e-4)):
        ref, got = run(ws0, True), run(ws0, False)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=2e-5)
        for a, b in ((got[1], ref[1]), (got[2], ref[2])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        for k, b in ref[3].items():
            a = got[3][k]
            assert bool(torch.isfinite(a).all()), k
            if k in ("b1", "b2", "b3", "b4"):
                assert float(a.abs().max()) <= 1e-3 and float(b.abs().max()) <= 1e-3, k
                continue
            l2 = float((a - b).norm() / b.norm().clamp_min(1e-12))
            corr = float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1]) if a.numel() > 1 else 1.0
            assert l2 <= l2_bar and corr > 0.9999, f"{k}: L2 relative {l2:.2e}, corr {corr:.7f}"
    assert dt.LAUNCHES["bwd_float32"] == before + 2


def test_wrapper_entry_points_are_exported(monkeypatch):
    """Every C entry point the wrapper loads, per kind and storage type (the
    launch, the pointer count, the workspace size in floats of A4f and of
    A4b), is exported by its source; and every entry a source exports is
    loaded by the wrapper or called by chip_smoke.py (the engines'
    resources)."""
    import os
    import re

    class Fn:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            return b"failed" if self.name.endswith("error_string") else len(dt.PTR_NAMES)

    class Lib:
        def __init__(self):
            self.names = set()

        def __getattr__(self, name):
            self.names.add(name)
            return Fn(name)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for kind in ("fwd", "bwd"):
        src = open(os.path.join(os.path.dirname(dt.__file__), "csrc", f"decoder_train_{kind}.cu")).read()
        exported = set(re.findall(r'extern "C" [\w\s\*]*?\b(decoder_train_\w+)\(', src))
        loaded = set()
        for sd in (torch.float32, torch.bfloat16):
            lib = Lib()
            monkeypatch.setattr(dt.build, "load", lambda name, lib=lib: lib)
            dt._lib(kind, sd)
            with pytest.raises(RuntimeError, match="launch failed: failed"):
                dt._raise(lib, kind, 1)
            assert len(lib.names) == 4 and lib.names <= exported, (kind, sd, lib.names)
            assert f"decoder_train_{kind}_workspace_floats_{dt._suffix(sd)}" in lib.names
            loaded |= lib.names
        used = set(re.findall(r"\blib\.(decoder_train_\w+)", open(os.path.join(root, "chip_smoke.py")).read()))
        assert exported <= loaded | used, (kind, exported - loaded - used)


def test_compare_builds_names_the_a4_tensors_expected_to_differ():
    """compare_builds names the A4 tensors this checkout's kernels move
    against the parent's: in bfloat16 all 22 of the A4 family (A4f's convs
    moved to tensor cores, and A4b reads A4f's planes), none in float32 or
    in any other family. A bfloat16 A4 comparison is as expected exactly
    when every one of the 22 differs; every other one exactly when all are
    bitwise equal."""
    from electrocardio_panorama_tpu_torch import compare_builds as CB

    d = CB.a4_dump(dt, "float32", torch.device("cpu"), nb=2)
    assert len(d) == 22 and set(CB.EXPECTED_TO_DIFFER) == {("bfloat16", "A4")}
    assert sorted(CB.EXPECTED_TO_DIFFER["bfloat16", "A4"]) == sorted(d)
    same = CB.compare(d, d)
    other = {k: v + 1 for k, v in d.items()}
    one_moved = {**d, "A4 grad w5": d["A4 grad w5"] + 1}
    one_kept = {**other, "A4 grad w5": d["A4 grad w5"]}
    f32 = "float32"
    assert CB.against_expectation(same, f32, "A4")["as_expected"]
    r = CB.against_expectation(CB.compare(d, other), f32, "A4")
    assert not r["as_expected"] and r["expected_to_differ"] == [] and r["bitwise_equal"] == 0
    assert not CB.against_expectation(CB.compare(d, one_moved), f32, "A4")["as_expected"]
    bf16 = "bfloat16"
    r = CB.against_expectation(CB.compare(d, other), bf16, "A4")
    assert r["as_expected"] and len(r["expected_to_differ"]) == 22 and r["bitwise_equal"] == 0
    for moved in (same, CB.compare(d, one_moved), CB.compare(d, one_kept)):
        assert not CB.against_expectation(moved, bf16, "A4")["as_expected"]
    for dtype in (f32, bf16):
        for family in ("A2/A3", "A4b on shared planes"):
            assert CB.EXPECTED_TO_DIFFER.get((dtype, family), []) == []
    assert {"conv3_kernel", "conv_fwd_kernel_fma", "conv_fwd_kernel_tc"} == set(CB.A4F_CONV_KERNELS)


def test_compare_builds_a4_float64_distance():
    """compare_builds measures an A4 dump against a float64 pass of the plain
    version on the same seeded inputs: on the CPU the float32 plain version
    lies within float32 rounding of it (out 1e-6, moments 1e-5, gradients L2
    1e-4), and a perturbed gradient or variance is found."""
    from electrocardio_panorama_tpu_torch import compare_builds as CB

    dev = torch.device("cpu")
    d, truth = CB.a4_dump(dt, "float32", dev, nb=2), CB.a4_float64_truth(dev, nb=2)
    assert set(truth) == set(d) and truth["A4 out"].dtype == truth["A4 mean"].dtype == torch.float64
    r = CB.float64_distance(d, truth)
    assert r["out_max_abs"] < 1e-6 and r["worst_grad_l2"] < 1e-4, r
    assert r["moments_within_1e-5"] and r["moments_max_abs"] < 1e-5, r
    off = CB.float64_distance({**d, "A4 var": d["A4 var"] * (1 + 1e-3)}, truth)
    assert not off["moments_within_1e-5"] and off["moments_max_abs"] > 1e-5, off
    bad = CB.float64_distance({**d, "A4 grad w3": d["A4 grad w3"] * 1.01}, truth)
    assert bad["worst_grad"] == "A4 grad w3" and abs(bad["worst_grad_l2"] - 1e-2) < 1e-3, bad


def test_compare_builds_a4b_shared_planes_family():
    """The family "A4b on shared planes" holds the 19 A4b tensors (prefix
    "A4b "), apart from the A4 and A2/A3 families, and expects them bitwise
    equal in both dtypes: one moved gradient breaks `as_expected`."""
    from electrocardio_panorama_tpu_torch import compare_builds as CB

    fam = "A4b on shared planes"
    names = [f"A4b grad {k}" for k in CB.A4_GRADS]
    assert CB.A4_GRADS == ["dx", *dt.WNAMES] and len(names) == 19
    others = [p for f, ps in CB.FAMILIES.items() if f != fam for p in ps]
    assert all(n.startswith(CB.FAMILIES[fam]) and not n.startswith(tuple(others)) for n in names)
    d = {n: torch.full((3,), float(i)) for i, n in enumerate(names)}
    for dtype in ("float32", "bfloat16"):
        r = CB.against_expectation(CB.compare(d, dict(d)), dtype, fam)
        assert r["as_expected"] and r["bitwise_equal"] == 19
        moved = {**d, "A4b grad w3": torch.nextafter(d["A4b grad w3"], torch.tensor(100.0))}
        assert not CB.against_expectation(CB.compare(d, moved), dtype, fam)["as_expected"]


def test_chip_smoke_forward_entry_points_are_exported():
    """Every decoder_train_fwd C entry that chip_smoke.py calls (the float32
    FMA and the bfloat16 tensor-core forward engines' resources and
    workspace sizes) is exported by csrc/decoder_train_fwd.cu."""
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(os.path.dirname(dt.__file__), "csrc", "decoder_train_fwd.cu")).read()
    exported = set(re.findall(r'extern "C" [\w\s\*]*?\b(decoder_train_fwd_\w+)\(', src))
    used = set(re.findall(r"\blib\.(decoder_train_fwd_\w+)", open(os.path.join(root, "chip_smoke.py")).read()))
    assert {"decoder_train_fwd_fma_resources", "decoder_train_fwd_workspace_floats_f32",
            "decoder_train_fwd_tc_resources", "decoder_train_fwd_workspace_floats_bf16"} <= used
    assert used <= exported, used - exported


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [32, 5])
def test_cuda_f32_forward_fma_matches_plain_and_repeats(setup, nb):
    """float32 A4f (its convs on the FMA engine) against the plain version at
    the PERF.md section 2 bars: out max abs error 2e-5, moments within 1e-5
    (relative and absolute), with the model's BN offsets and with every relu
    open; every plane bitwise equal across a repeat launch; and A4b on these
    kept planes bitwise equal to backward_cuda without planes (its own A4f
    launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from electrocardio_panorama_tpu_torch.ops import full_f32

    w, x, dout = _cuda_inputs(setup[3], "float32", nb)
    w_open = {k: (v + 8.0 if k[0] == "o" else v) for k, v in w.items()}
    before = dt.LAUNCHES["fwd_float32"]
    for ws in (w, w_open):
        with torch.no_grad(), full_f32():
            ref_out, ref_mean, ref_var = dt.train_decode_groups_plain(ws, x)
        planes = dt.forward_cuda(ws, x)
        again = dt.forward_cuda(ws, x)
        torch.cuda.synchronize()
        assert list(planes) == dt.PLANES
        for k in dt.PLANES:
            assert torch.equal(planes[k], again[k]), k
            assert bool(torch.isfinite(planes[k]).all()), k
        torch.testing.assert_close(planes["OUT"], ref_out, rtol=0, atol=2e-5)
        torch.testing.assert_close(planes["MEAN"], ref_mean, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(planes["VAR"], ref_var, rtol=1e-5, atol=1e-5)
    assert dt.LAUNCHES["fwd_float32"] == before + 4
    kept = dt.backward_cuda(w_open, x, dout, planes)
    own = dt.backward_cuda(w_open, x, dout)
    torch.cuda.synchronize()
    for i, name in enumerate(["x", *dt.WNAMES]):
        assert torch.equal(kept[i], own[i]), name


@pytest.mark.parametrize("T", [2, 4, 128])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_upconv_taps_plain_matches_conv_of_upsample(T, dtype):
    """The input-resolution form of an upsampled conv equals the conv over
    up2(x): at T = 2 and 4 every step is near a clamped edge or the zero
    padding, at 128 most are inside."""
    from electrocardio_panorama_tpu_torch.ops.convs import conv1d
    from electrocardio_panorama_tpu_torch.ops.resample import upsample_linear_x2

    sd = getattr(torch, dtype)
    rng = np.random.default_rng(T)
    x = torch.tensor(rng.normal(0, 1, (3, 32, T)), dtype=sd)
    w = torch.tensor(rng.normal(0, (3 * 32) ** -0.5, (3, 16, 32)), dtype=sd)
    b = torch.tensor(rng.normal(0, 0.1, 16), dtype=sd)
    ref = conv1d(upsample_linear_x2(x), w.permute(1, 2, 0), padding=1) + b[:, None]
    got = dt.upconv_taps_plain(x, w, b)
    tol = 1e-6 if dtype == "float32" else 1e-12
    assert got.shape == (3, 16, 2 * T) and got.dtype == sd
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("T", [2, 4, 128])
def test_upconv_taps_plain_matches_jax_upconv_fwd(T):
    """The same form against the JAX package's `_upconv_fwd` (sum over taps
    of W_k h times the tap's shifted upsample matrix) with float32 weights,
    on the CPU, over 2 samples laid out as the JAX kernel takes them."""
    from electrocardio_panorama_tpu.ops.pallas.decoder_fused import upsample_shift_matrices

    rng = np.random.default_rng(100 + T)
    nb = 2
    x = rng.normal(0, 1, (nb, 64, T)).astype(np.float32)
    w = rng.normal(0, (3 * 64) ** -0.5, (3, 32, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, 32).astype(np.float32)
    h = jnp.asarray(x.transpose(1, 0, 2).reshape(64, nb * T))
    ref = jt._upconv_fwd(h, jnp.asarray(w), jnp.asarray(b), upsample_shift_matrices(T, jnp.float32), nb, T)
    ref = torch.tensor(np.asarray(ref)).reshape(32, nb, 2 * T).permute(1, 0, 2)
    got = dt.upconv_taps_plain(torch.tensor(x), torch.tensor(w), torch.tensor(b))
    torch.testing.assert_close(got, ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shape", [(3, 16, 16), (3, 64, 64), (3, 128, 256)])
def test_pack_fwd_tc_index_formula(shape):
    """bfloat16 A4f's weight packing (csrc/decoder_train_tc.cuh
    `pack_fwd_tc_kernel`, whose index arithmetic is repeated here line for
    line) writes w [3, Cout, Cin] in the layout [Cin/8, 3, Cout, 8]; read
    back as the kernel's A rows (chunk c, tap k, output channel o: 8 input
    channels), it gives each tap's 1x1 product."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(dt.__file__), "csrc", "decoder_train_tc.cuh")).read()
    body = re.search(r"pack_fwd_tc_kernel\(.*?\n}", src, re.S).group(0)
    assert "wp[e] = w[((long long)k * Cout + o) * Cin + c * 8 + j];" in body
    assert "const int o = r % Cout;" in body and "const int k = r % 3, c = r / 3;" in body
    K, Cout, Cin = shape
    w = torch.arange(K * Cout * Cin, dtype=torch.float64).reshape(shape)
    flat = w.reshape(-1)
    e = torch.arange(K * Cout * Cin)
    j, r = e & 7, e >> 3
    o, r = r % Cout, r // Cout
    k, c = r % 3, r // 3
    packed = flat[(k * Cout + o) * Cin + c * 8 + j]
    rows = w.reshape(K, Cout, Cin // 8, 8).permute(2, 0, 1, 3)
    assert torch.equal(packed, rows.reshape(-1))
    x = torch.tensor(np.random.default_rng(0).normal(0, 1, (Cin, 5)))
    for tap in range(3):
        y = sum(rows[ch, tap] @ x[8 * ch:8 * ch + 8] for ch in range(Cin // 8))
        torch.testing.assert_close(y, w[tap] @ x, rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [32, 2])
def test_cuda_bf16_forward_tc_matches_plain_and_repeats(setup, nb):
    """bfloat16 A4f (its convs on the tensor-core engine, the upsampled ones
    at input resolution) against the plain version at the PERF.md section 2
    bars: out max abs error 2e-3 and corr > 0.9999, the moments within
    BF16_MOMENTS_BAR of the float64 pass and within 1e-3 of the plain
    version; every plane bitwise equal across a repeat launch; and A4b on
    these kept planes bitwise equal to backward_cuda without planes (its own
    A4f launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    w, x, dout = _cuda_inputs(setup[3], "bfloat16", nb)
    before = dt.LAUNCHES["fwd_bfloat16"]
    with torch.no_grad():
        ref = dt.train_decode_groups_plain(w, x)
    planes = dt.forward_cuda(w, x)
    again = dt.forward_cuda(w, x)
    torch.cuda.synchronize()
    assert dt.LAUNCHES["fwd_bfloat16"] == before + 2
    assert list(planes) == dt.PLANES
    for k in dt.PLANES:
        assert torch.equal(planes[k], again[k]), k
        assert bool(torch.isfinite(planes[k].float()).all()), k
    torch.testing.assert_close(planes["OUT"], ref[0], rtol=0, atol=2e-3)
    corr = float(torch.corrcoef(torch.stack([planes["OUT"].flatten(), ref[0].flatten()]))[0, 1])
    assert corr > 0.9999, corr
    assert_bf16_moments_bar(w, x, (planes["MEAN"], planes["VAR"]), ref[1:])
    kept = dt.backward_cuda(w, x, dout, planes)
    own = dt.backward_cuda(w, x, dout)
    torch.cuda.synchronize()
    for i, name in enumerate(["x", *dt.WNAMES]):
        assert torch.equal(kept[i], own[i]), name
