"""Streamed-basis decoder (kernel A1): the port's plain version against the
JAX package's Pallas kernel in interpret mode, on the CPU.

Tolerances:
  * f32, head 'stream_scalar': atol 2e-5, the JAX package's own bar for the
    basis path against its XLA decoder (tests/test_pallas_decoder.py);
  * bf16, head 'stream': atol 5e-5 against the JAX bf16 result (both round
    at the same places; they differ by summation order and by the TPU
    kernel's polyphase weight combinations, rounded to bf16 once), and
    corr > 0.999 / atol 1e-4 against the f32 decode_views, the bar of
    tests/test_pallas_decoder.py:111-133;
  * the CUDA kernel against the plain version (card only): the same bars.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.models import NefNetDef as JaxNefNetDef
from electrocardio_panorama_tpu.models.nefnet import decode_views as jax_decode_views
from electrocardio_panorama_tpu.ops.pallas import decoder_fused as jf
from electrocardio_panorama_tpu.ops.theta import angular_encode as jax_angular_encode
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models import decode_views
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
