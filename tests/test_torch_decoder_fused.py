"""Fused eval decoder (kernel A1, the streamed-basis form, and the gate-input
and y1 forms A5/A7 and A6): the port's plain versions against the JAX
package's Pallas kernels in interpret mode, on the CPU.

Tolerances:
  * f32, head 'stream_scalar': atol 2e-5, the JAX package's own bar for the
    basis path against its XLA decoder (tests/test_pallas_decoder.py);
  * bf16, head 'stream': atol 5e-5 against the JAX bf16 result (both round
    at the same places; they differ by summation order and by the TPU
    kernel's polyphase weight combinations, rounded to bf16 once), and
    corr > 0.999 / atol 1e-4 against the f32 decode_views, the bar of
    tests/test_pallas_decoder.py:111-133;
  * the gate form (`gates=`): f32 atol 2e-5 against the JAX polyphase kernel
    A5 and, separately, against the JAX float32 layout-A kernel A7 (reached
    by setting the module global `_F32_LAYOUT_A` and calling the function
    un-jitted, so that the jit cache cannot hand back A5's trace); bf16 atol
    1e-4 against the JAX bf16 A5 result (the TPU kernel's polyphase conv1
    rounds one more intermediate, so the two are about as far apart as each
    is from float32) and corr > 0.999 / atol 1e-4 against the f32
    decode_views, the bar of tests/test_pallas_decoder.py:38-60;
  * the y1 form (`enc=`, head 'y1'): f32 atol 2e-5 and bf16 atol 5e-5 against
    the JAX kernel A6, as for A1;
  * every form of the port against its eager `decode_views`: f32 atol 2e-5;
  * the CUDA kernels against the plain versions (card only): the same bars.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.models import NefNetDef as JaxNefNetDef
from electrocardio_panorama_tpu.models.nefnet import decode_views as jax_decode_views
from electrocardio_panorama_tpu.models.nefnet import query_gates as jax_query_gates
from electrocardio_panorama_tpu.ops.pallas import decoder_fused as jf
from electrocardio_panorama_tpu.ops.theta import angular_encode as jax_angular_encode
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models import decode_views, query_gates
from electrocardio_panorama_tpu_torch.ops import angular_encode
from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as tf


def weights(seed, rng=None):
    """JAX init (optionally with non-trivial BN running stats) and its port copy."""
    params, state = JaxNefNetDef(3).init(jax.random.PRNGKey(seed))
    if rng is not None:
        state = {k: (jnp.asarray(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
                     if k.endswith("running_var")
                     else jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)) * 0.1
                     if k.endswith("running_mean") else v)
                 for k, v in state.items()}
    tp, ts = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                             {k: np.asarray(v) for k, v in state.items()})
    return params, state, tp, ts


def realistic_latent(rng, params):
    """Encoder output (random latents understate the bf16 error)."""
    data = jnp.asarray(rng.uniform(0, 1, (2, 3, 512)).astype(np.float32))
    it = jnp.asarray(rng.uniform(-np.pi, np.pi, (2, 3, 2)).astype(np.float32))
    cuts = np.sort(rng.choice(np.arange(8, 504, 4), size=6, replace=False))
    pts = np.concatenate([[0], cuts, [512]])
    rois = jnp.asarray(np.broadcast_to(np.stack([pts[:-1], pts[1:]], 1), (2, 7, 2)))
    return np.asarray(JaxNefNetDef(3).encode(params, data, it, rois).latent_all)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_decoder_bn_matches_jax(rng, dtype):
    params, state, tp, ts = weights(1, rng)
    ref = jf.fold_decoder_bn(params, state, dtype=jnp.dtype(dtype))
    ours = tf.fold_decoder_bn(tp, ts, dtype=getattr(torch, dtype))
    assert set(ours) == set(ref)
    for k in ref:
        assert str(ours[k].dtype).removeprefix("torch.") == str(ref[k].dtype), k
        # f32: 1e-6; a bf16 weight may round one ulp (2^-7 relative) the other
        # way when rsqrt differs in the last f32 bit
        rtol = 2.0 ** -7 if ours[k].dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(ours[k].float().numpy(), np.asarray(ref[k], np.float32),
                                   atol=1e-6, rtol=rtol, err_msg=k)


def test_plain_a1_f32_matches_jax_stream_scalar(rng):
    """Non-trivial BN stats; V=11 is not a multiple of the tile, so the
    padding path runs on both sides."""
    params, state, tp, ts = weights(0, rng)
    latent = (rng.standard_normal((2, 256, 128)) * 0.3).astype(np.float32)
    views = rng.uniform(-np.pi, np.pi, (2, 11, 2)).astype(np.float32)
    ref = np.asarray(jf.fused_decode_views(
        jf.fold_decoder_bn(params, state), jnp.asarray(latent),
        enc=jax_angular_encode(jnp.asarray(views), 1), v_tile=8, interpret=True, head="stream_scalar"))
    ours = tf.fused_decode_views(tf.fold_decoder_bn(tp, ts), torch.tensor(latent),
                                 enc=angular_encode(torch.tensor(views)), v_tile=8)
    assert ours.shape == (2, 11, 512) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)
    # and the port's own XLA-analog decoder
    xla = decode_views(tp, ts, torch.tensor(latent), torch.tensor(views))
    np.testing.assert_allclose(ours.numpy(), xla.numpy(), atol=2e-5)


def test_plain_a1_bf16_matches_jax_stream(rng):
    params, state, tp, ts = weights(2)
    latent = realistic_latent(rng, params)
    views = rng.uniform(-np.pi, np.pi, (2, 16, 2)).astype(np.float32)
    enc = jax_angular_encode(jnp.asarray(views), 1)
    jax_bf16 = np.asarray(jf.fused_decode_views(
        jf.fold_decoder_bn(params, state, dtype=jnp.bfloat16), jnp.asarray(latent), enc=enc,
        v_tile=16, interpret=True, head="stream"))
    f32 = np.asarray(jax_decode_views(params, state, jnp.asarray(latent), jnp.asarray(views)))
    ours = tf.fused_decode_views(tf.fold_decoder_bn(tp, ts, dtype=torch.bfloat16), torch.tensor(latent),
                                 enc=angular_encode(torch.tensor(views)), v_tile=16).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, jax_bf16, atol=5e-5)
    corr = np.corrcoef(ours.ravel(), f32.ravel())[0, 1]
    assert corr > 0.999, f"bf16/f32 correlation {corr}"
    np.testing.assert_allclose(ours, f32, atol=1e-4)


def test_decode_basis_cpu_dispatch_and_checks(rng):
    _, _, tp, ts = weights(3)
    folded = tf.fold_decoder_bn(tp, ts)
    latent = torch.tensor((rng.standard_normal((1, 256, 128)) * 0.3).astype(np.float32))
    enc = angular_encode(torch.tensor(rng.uniform(-np.pi, np.pi, (1, 8, 2)).astype(np.float32)))
    U = tf.basis_planes(folded, latent)
    ep = tf.basis_coeffs(enc)
    assert U.shape == (1, 13, 128, 256) and ep.shape == (1, 8, 13)
    launches = sum(tf.LAUNCHES.values())
    torch.testing.assert_close(tf.decode_basis(U, ep, folded), tf.decode_basis_plain(U, ep, folded),
                               rtol=0, atol=0)
    assert sum(tf.LAUNCHES.values()) == launches  # the CPU never counts a kernel launch
    with pytest.raises(ValueError, match="CUDA"):
        tf.decode_basis_cuda(U, ep, folded)
    with pytest.raises(ValueError, match="U must be"):
        tf.decode_basis(U.to(torch.bfloat16), ep, folded)
    with pytest.raises(ValueError, match="v_tile"):
        tf.fused_decode_views(folded, latent, enc=enc, v_tile=0)


@pytest.fixture(scope="module")
def gate_case():
    """Non-trivial BN stats; V=11 is not a multiple of the tile."""
    rng = np.random.default_rng(11)
    params, state, tp, ts = weights(0, rng)
    latent = (rng.standard_normal((2, 256, 128)) * 0.3).astype(np.float32)
    views = rng.uniform(-np.pi, np.pi, (2, 11, 2)).astype(np.float32)
    return params, state, tp, ts, latent, views


def test_plain_gates_f32_matches_jax_a5(gate_case):
    params, state, tp, ts, latent, views = gate_case
    gates = jax_query_gates(params, jnp.asarray(views))
    ref = np.asarray(jf.fused_decode_views(jf.fold_decoder_bn(params, state), jnp.asarray(latent), gates,
                                           v_tile=8, interpret=True))
    ours = tf.fused_decode_views(tf.fold_decoder_bn(tp, ts), torch.tensor(latent),
                                 query_gates(tp, torch.tensor(views)), v_tile=8)
    assert ours.shape == (2, 11, 512) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


def test_plain_gates_f32_matches_jax_a7(gate_case, monkeypatch):
    """The float32 instantiation of the port's gate path is also the
    counterpart of the JAX package's float32 layout-A kernel."""
    params, state, tp, ts, latent, views = gate_case
    monkeypatch.setattr(jf, "_F32_LAYOUT_A", True)
    gates = jax_query_gates(params, jnp.asarray(views))
    ref = np.asarray(jf.fused_decode_views.__wrapped__(
        jf.fold_decoder_bn(params, state), jnp.asarray(latent), gates, v_tile=8, interpret=True))
    monkeypatch.undo()
    other = np.asarray(jf.fused_decode_views(jf.fold_decoder_bn(params, state), jnp.asarray(latent), gates,
                                             v_tile=8, interpret=True))
    assert not np.array_equal(ref, other)  # two kernels, not one trace twice
    ours = tf.fused_decode_views(tf.fold_decoder_bn(tp, ts), torch.tensor(latent),
                                 query_gates(tp, torch.tensor(views)), v_tile=8)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


def test_plain_gates_bf16_matches_jax_a5(rng):
    params, state, tp, ts = weights(2)
    latent = realistic_latent(rng, params)
    views = rng.uniform(-np.pi, np.pi, (2, 16, 2)).astype(np.float32)
    jax_bf16 = np.asarray(jf.fused_decode_views(
        jf.fold_decoder_bn(params, state, dtype=jnp.bfloat16), jnp.asarray(latent),
        jax_query_gates(params, jnp.asarray(views)), v_tile=16, interpret=True))
    f32 = np.asarray(jax_decode_views(params, state, jnp.asarray(latent), jnp.asarray(views)))
    ours = tf.fused_decode_views(tf.fold_decoder_bn(tp, ts, dtype=torch.bfloat16), torch.tensor(latent),
                                 query_gates(tp, torch.tensor(views)), v_tile=16).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, jax_bf16, atol=1e-4)
    corr = np.corrcoef(ours.ravel(), f32.ravel())[0, 1]
    assert corr > 0.999, f"bf16/f32 correlation {corr}"
    np.testing.assert_allclose(ours, f32, atol=1e-4)


@pytest.mark.parametrize("dtype,v_tile,atol", [("float32", 8, 2e-5), ("bfloat16", 16, 5e-5)])
def test_plain_y1_matches_jax_a6(gate_case, dtype, v_tile, atol):
    params, state, tp, ts, latent, views = gate_case
    ref = np.asarray(jf.fused_decode_views(
        jf.fold_decoder_bn(params, state, dtype=jnp.dtype(dtype)), jnp.asarray(latent),
        enc=jax_angular_encode(jnp.asarray(views), 1), v_tile=v_tile, interpret=True, head="y1"))
    folded = tf.fold_decoder_bn(tp, ts, dtype=getattr(torch, dtype))
    enc = angular_encode(torch.tensor(views))
    ours = tf.fused_decode_views(folded, torch.tensor(latent), enc=enc, v_tile=v_tile, head="y1")
    assert ours.shape == (2, 11, 512) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=atol)
    y1 = tf.basis_y1(folded, torch.tensor(latent), enc)
    assert y1.shape == (2, 11, 128, 256) and y1.dtype == getattr(torch, dtype) and float(y1.min()) >= 0


def test_all_forms_agree_with_decode_views(gate_case):
    _, _, tp, ts, latent, views = gate_case
    lat, v = torch.tensor(latent), torch.tensor(views)
    ref = decode_views(tp, ts, lat, v)
    folded = tf.fold_decoder_bn(tp, ts)
    enc, gates = angular_encode(v), query_gates(tp, v)
    launches = sum(tf.LAUNCHES.values())
    outs = {"gates": tf.fused_decode_views(folded, lat, gates, v_tile=8),
            "gates_plain": tf.fused_decode_views(folded, lat, gates, v_tile=8, plain=True),
            **{h: tf.fused_decode_views(folded, lat, enc=enc, v_tile=8, head=h)
               for h in ("auto", "stream", "stream_scalar", "y1")}}
    assert sum(tf.LAUNCHES.values()) == launches  # the CPU never counts a kernel launch
    for name, out in outs.items():
        assert out.shape == (2, 11, 512), name
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, err_msg=name)
    torch.testing.assert_close(outs["stream"], outs["auto"], rtol=0, atol=0)
    torch.testing.assert_close(outs["stream_scalar"], outs["auto"], rtol=0, atol=0)
    # V a multiple of the tile and V not: the padded views change nothing
    whole = tf.fused_decode_views(folded, lat, gates[:, :8], v_tile=8)
    np.testing.assert_allclose(whole.numpy(), outs["gates"][:, :8].numpy(), atol=1e-6)
    whole = tf.fused_decode_views(folded, lat, enc=enc[:, :8], v_tile=8, head="y1")
    np.testing.assert_allclose(whole.numpy(), outs["y1"][:, :8].numpy(), atol=1e-6)


def test_fused_decode_views_argument_errors(gate_case):
    """The argument rules of the JAX function (tests/test_pallas_decoder.py:136-154)."""
    _, _, tp, ts, latent, views = gate_case
    lat, v = torch.tensor(latent), torch.tensor(views)
    folded = tf.fold_decoder_bn(tp, ts)
    enc, gates = angular_encode(v), query_gates(tp, v)
    with pytest.raises(ValueError, match="exactly one"):
        tf.fused_decode_views(folded, lat, gates, enc=enc)
    with pytest.raises(ValueError, match="exactly one"):
        tf.fused_decode_views(folded, lat)
    stripped = {k: t for k, t in folded.items() if k != "A"}
    with pytest.raises(ValueError, match="mlp2"):
        tf.fused_decode_views(stripped, lat, enc=enc, v_tile=8)
    assert tf.fused_decode_views(stripped, lat, gates, v_tile=8).shape == (2, 11, 512)  # gates need no A
    with pytest.raises(ValueError, match="unknown basis head"):
        tf.fused_decode_views(folded, lat, enc=enc, head="dense")
    with pytest.raises(ValueError, match="v_tile"):
        tf.fused_decode_views(folded, lat, gates, v_tile=-8)
    with pytest.raises(ValueError, match="CUDA"):
        tf.decode_gates_cuda(lat, gates, folded)
    with pytest.raises(ValueError, match="CUDA"):
        tf.decode_y1_cuda(tf.basis_y1(folded, lat, enc), folded)
    with pytest.raises(ValueError, match="latent must be"):
        tf.decode_gates(lat.to(torch.bfloat16), gates, folded)
    with pytest.raises(ValueError, match="gates must be"):
        tf.decode_gates(lat, gates[..., :100], folded)
    with pytest.raises(ValueError, match="y1 must be"):
        tf.decode_y1(tf.basis_y1(folded, lat, enc).to(torch.bfloat16), folded)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["gates", "y1"])
def test_cuda_forms_match_plain(rng, dtype, form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    _, _, tp, ts = weights(0, rng)
    tp = {k: v.to(dev) for k, v in tp.items()}
    ts = {k: v.to(dev) for k, v in ts.items()}
    latent = torch.tensor((rng.standard_normal((4, 256, 128)) * 0.3).astype(np.float32), device=dev)
    views = torch.tensor(rng.uniform(-np.pi, np.pi, (4, 11, 2)).astype(np.float32), device=dev)
    kw = {"gates": query_gates(tp, views)} if form == "gates" else {"enc": angular_encode(views), "head": "y1"}
    ref = tf.fused_decode_views(tf.fold_decoder_bn(tp, ts), latent, plain=True, **kw)
    folded = tf.fold_decoder_bn(tp, ts, dtype=getattr(torch, dtype))
    before = tf.LAUNCHES[f"{form}_{dtype}"]
    out = tf.fused_decode_views(folded, latent, **kw)
    torch.cuda.synchronize()
    assert tf.LAUNCHES[f"{form}_{dtype}"] == before + 1
    assert out.shape == (4, 11, 512)
    err = float((out - ref).abs().max())
    if dtype == "float32":
        assert err <= 2e-5
    else:
        corr = np.corrcoef(out.cpu().numpy().ravel(), ref.cpu().numpy().ravel())[0, 1]
        assert err <= 1e-4 and corr > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_views", [11, 336])
def test_cuda_kernel_matches_plain(rng, dtype, n_views):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    _, _, tp, ts = weights(0, rng)
    tp = {k: v.to(dev) for k, v in tp.items()}
    ts = {k: v.to(dev) for k, v in ts.items()}
    latent = torch.tensor((rng.standard_normal((4, 256, 128)) * 0.3).astype(np.float32), device=dev)
    enc = angular_encode(torch.tensor(rng.uniform(-np.pi, np.pi, (4, n_views, 2)).astype(np.float32),
                                      device=dev))
    ref = tf.fused_decode_views(tf.fold_decoder_bn(tp, ts), latent, enc=enc, plain=True)
    folded = tf.fold_decoder_bn(tp, ts, dtype=getattr(torch, dtype))
    before = tf.LAUNCHES[dtype]
    out = tf.fused_decode_views(folded, latent, enc=enc)
    torch.cuda.synchronize()
    assert tf.LAUNCHES[dtype] == before + 1
    assert out.shape == (4, n_views, 512)
    err = float((out - ref).abs().max())
    if dtype == "float32":
        assert err <= 2e-5
    else:
        corr = np.corrcoef(out.cpu().numpy().ravel(), ref.cpu().numpy().ravel())[0, 1]
        assert err <= 1e-4 and corr > 0.999


# ---------------------------------------------------------------------------
# The layouts the CUDA kernels read, made in Python: chunked planes, packed
# weights, the polyphase conv3 and its packed order, conv1 before its upsample.


@pytest.mark.parametrize("shape", [(16, 5), (2, 3, 24, 7), (1, 128, 256)])
def test_pack_chunked_round_trip_and_index(rng, shape):
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    p = tf.pack_chunked(x)
    assert p.shape == (*shape[:-2], shape[-2] // 8, shape[-1], 8) and p.is_contiguous()
    torch.testing.assert_close(tf.unpack_chunked(p), x, rtol=0, atol=0)
    C, T = shape[-2:]
    for c, t in ((0, 0), (C - 1, T - 1), (C // 2 + 3, T // 2)):
        torch.testing.assert_close(p[..., c // 8, t, c % 8], x[..., c, t], rtol=0, atol=0)


def test_pack_weights_index_formulas(rng):
    w = torch.tensor(rng.standard_normal((3, 24, 32)).astype(np.float32))
    tc, fma = tf.pack_weights_tc(w), tf.pack_weights_fma(w)
    assert tc.shape == (3, 4, 24, 8) and tc.is_contiguous() and fma.shape == (3, 32, 24) and fma.is_contiguous()
    for k, n, c in ((0, 0, 0), (2, 23, 31), (1, 7, 13)):
        assert tc[k, c // 8, n, c % 8] == w[k, n, c] and fma[k, c, n] == w[k, n, c]
    # flat offsets, as the kernels address them
    assert tc.flatten()[((1 * 4 + 13 // 8) * 24 + 7) * 8 + 13 % 8] == w[1, 7, 13]
    assert fma.flatten()[(1 * 32 + 13) * 24 + 7] == w[1, 7, 13]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_polyphase_matrices_match_jax(rng, dtype):
    params, state, tp, ts = weights(1, rng)
    _, _, ab3_ref, c3_ref = jf.polyphase_matrices(jf.fold_decoder_bn(params, state, dtype=jnp.dtype(dtype)))
    ab3, c3 = tf.polyphase_matrices(tf.fold_decoder_bn(tp, ts, dtype=getattr(torch, dtype)))
    # the fold's tolerances (test_fold_decoder_bn_matches_jax): a bf16 value may
    # round one ulp the other way
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    for ours, ref in ((ab3, ab3_ref), (c3, c3_ref)):
        assert ours.shape == ref.shape and str(ours.dtype).removeprefix("torch.") == str(ref.dtype)
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), atol=1e-6, rtol=rtol)


def test_polyphase_conv3_is_conv3_of_the_upsample(rng):
    """In float32 the polyphase form with its edge corrections is the
    time-order conv3(up2(h2)) up to summation order."""
    from electrocardio_panorama_tpu_torch.ops.resample import upsample_linear_x2

    _, _, tp, ts = weights(0, rng)
    folded = tf.fold_decoder_bn(tp, ts)
    h2 = torch.tensor(rng.standard_normal((3, 128, 256)).astype(np.float32)).relu()
    ref = torch.nn.functional.conv1d(upsample_linear_x2(h2), folded["w3"].permute(1, 2, 0), padding=1)
    torch.testing.assert_close(tf._upconv3_plain(h2, folded), ref, rtol=0, atol=2e-5)


def test_conv1_before_its_upsample(rng):
    """sum_k up2(W1_k x)[t + k - 1] is conv1(up2(x)) up to summation order."""
    from electrocardio_panorama_tpu_torch.ops.resample import upsample_linear_x2

    x = torch.tensor(rng.standard_normal((2, 256, 128)).astype(np.float32))
    w1 = torch.tensor((rng.standard_normal((3, 128, 256)) * 0.05).astype(np.float32))
    g = torch.einsum("kfc,nct->nkft", w1, x)
    ref = torch.nn.functional.conv1d(upsample_linear_x2(x), w1.permute(1, 2, 0), padding=1)
    torch.testing.assert_close(tf._shift_sum_up2(g), ref, rtol=0, atol=2e-5)


def _packed_tail_reference(y1, folded):
    """conv2 .. conv5 computed from `pack_tail`'s arrays by the kernels' index
    formulas: what the CUDA stages read, in eager PyTorch."""
    sd = folded["w2"].dtype
    w2, b2, w3, b3, cedge, w4, b4, w5, b5 = tf.pack_tail(folded)
    phase, co = tf.polyphase_order(sd)

    def r(x):
        return x.to(sd).float()

    def taps(w):  # packed -> [taps, N, Cin]
        w = w.float()
        return w.permute(0, 2, 1, 3).reshape(w.shape[0], w.shape[2], -1) if sd == torch.bfloat16 else w.permute(0, 2, 1)

    def conv(x, w, b):
        return torch.nn.functional.conv1d(x, taps(w).permute(1, 2, 0), b, padding=1)

    h2 = r(torch.relu(conv(y1, w2, b2)))
    d = conv(h2, w3, None)                                      # [N, 128 packed, 256]
    d[:, :, 0] += h2[:, :, 0] @ cedge[0].float().t()
    d[:, :, -1] += h2[:, :, -1] @ cedge[1].float().t()
    d = r(torch.relu(d + b3[:, None]))
    h3 = torch.zeros(y1.shape[0], 64, 512)
    for n in range(128):                                        # packed channel n -> step 2t + phase of co
        h3[:, co[n], phase[n]::2] = d[:, n]
    h4 = r(torch.relu(conv(h3, w4, b4)))
    p = torch.einsum("kc,nct->nkt", w5.float(), h4)
    p = torch.nn.functional.pad(p, (1, 1))
    return torch.sigmoid((p[:, 0, :-2] + p[:, 1, 1:-1] + p[:, 2, 2:] + b5) / 3.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_tail_reproduces_plain(rng, dtype):
    from electrocardio_panorama_tpu_torch.ops.convs import full_f32

    _, _, tp, ts = weights(0, rng)
    folded = tf.fold_decoder_bn(tp, ts, dtype=getattr(torch, dtype))
    y1 = torch.tensor(rng.standard_normal((2, 128, 256)).astype(np.float32)).relu().to(folded["w2"].dtype).float()
    tail = tf.pack_tail(folded)
    assert [tuple(t.shape) for t in tail] == (
        [(3, 16, 128, 8), (128,), (3, 16, 128, 8), (128,), (2, 128, 128), (3, 8, 64, 8), (64,), (3, 64), (1,)]
        if dtype == "bfloat16" else
        [(3, 128, 128), (128,), (3, 128, 128), (128,), (2, 128, 128), (3, 64, 64), (64,), (3, 64), (1,)])
    assert all(t.is_contiguous() for t in tail)
    phase, co = tf.polyphase_order(folded["w2"].dtype)
    assert sorted(zip(phase.tolist(), co.tolist())) == [(p, c) for p in range(2) for c in range(64)]
    with full_f32():
        ours, ref = _packed_tail_reference(y1, folded), tf._tail_plain(y1, folded)
    # same values at the same rounding points; only the summation order differs
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-6 if dtype == "float32" else 5e-5)


def test_packed_weights_are_cached(rng):
    _, _, tp, ts = weights(3)
    folded = tf.fold_decoder_bn(tp, ts)
    tail = tuple(folded[k] for k in tf._TAIL_KEYS)
    first = tf._cached(tf._pack_tail_list, tail)
    assert tf._cached(tf._pack_tail_list, tail) is first
    folded["w2"].mul_(2.0)  # an update in place packs anew
    again = tf._cached(tf._pack_tail_list, tail)
    assert again is not first
    torch.testing.assert_close(again[0], tf.pack_weights_fma(folded["w2"]), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["basis", "gates", "y1"])
def test_cuda_ragged_batch_matches_plain(rng, dtype, form):
    """B=3 and V=11 with v_tile=16: neither the batch, the views nor the padded
    view count is a multiple of a kernel tile or of the card's SM count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    _, _, tp, ts = weights(0, rng)
    tp = {k: v.to(dev) for k, v in tp.items()}
    ts = {k: v.to(dev) for k, v in ts.items()}
    latent = torch.tensor((rng.standard_normal((3, 256, 128)) * 0.3).astype(np.float32), device=dev)
    views = torch.tensor(rng.uniform(-np.pi, np.pi, (3, 11, 2)).astype(np.float32), device=dev)
    kw = {"basis": {"enc": angular_encode(views)}, "gates": {"gates": query_gates(tp, views)},
          "y1": {"enc": angular_encode(views), "head": "y1"}}[form]
    ref = tf.fused_decode_views(tf.fold_decoder_bn(tp, ts), latent, v_tile=16, plain=True, **kw)
    folded = tf.fold_decoder_bn(tp, ts, dtype=getattr(torch, dtype))
    key = dtype if form == "basis" else f"{form}_{dtype}"
    before = tf.LAUNCHES[key]
    out = tf.fused_decode_views(folded, latent, v_tile=16, **kw)
    again = tf.fused_decode_views(folded, latent, v_tile=16, **kw)
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before + 2
    assert out.shape == (3, 11, 512) and torch.equal(out, again)
    err = float((out - ref).abs().max())
    if dtype == "float32":
        assert err <= 2e-5
    else:
        corr = np.corrcoef(out.cpu().numpy().ravel(), ref.cpu().numpy().ravel())[0, 1]
        assert err <= 1e-4 and corr > 0.999


def test_stage_table_and_timing_entry_need_the_card(rng):
    """STAGES counts the tail's multiply-adds per view; the timing entry is a
    measurement on the card and refuses CPU tensors."""
    tail = 128 * 128 * 3 * 256 + 64 * 128 * 3 * 512 + 64 * 64 * 3 * 512
    assert sum(m for _, m in tf.STAGES["y1"]) == sum(m for _, m in tf.STAGES["basis"]) == tail
    assert sum(m for _, m in tf.STAGES["gates"]) == tail + 3 * 128 * 256 * 128
    _, _, tp, ts = weights(3)
    folded = tf.fold_decoder_bn(tp, ts)
    U, ep = torch.zeros(1, 13, 128, 256), torch.zeros(1, 8, 13)
    with pytest.raises(ValueError, match="CUDA"):
        tf.decode_stage_ms("basis", folded, U, ep)
