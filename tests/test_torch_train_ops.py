"""Train-mode ops and blocks of the port against the JAX package, on the CPU.

Dropout takes explicit pre-scaled masks in the port; the JAX side gets the
same masks through `x * mask`, which is what its `dropout` computes
(`where(bernoulli, x / keep, 0)`) for a mask of 0 or 1/keep. Tolerance 1e-6
(absolute, on values of order 1) for outputs, running statistics and
gradients; `num_batches_tracked` exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.models import blocks as JB
from electrocardio_panorama_tpu.models.nefnet import decoder_apply as jax_decoder_apply
from electrocardio_panorama_tpu.models.nefnet import init_nefnet as jax_init_nefnet
from electrocardio_panorama_tpu.ops import convs as JC
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models import blocks as TB
from electrocardio_panorama_tpu_torch.models.nefnet import decoder_apply
from electrocardio_panorama_tpu_torch.ops import convs as TC

TOL = 1e-6


def t(a):
    return torch.tensor(np.asarray(a))


def bn_inputs(rng, shape, c):
    x = rng.normal(0.3, 1.5, shape).astype(np.float32)
    scale, offset = rng.normal(1, 0.2, c).astype(np.float32), rng.normal(0, 0.2, c).astype(np.float32)
    rm, rv = rng.normal(0, 0.1, c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    return x, scale, offset, rm, rv


def test_dropout_with_explicit_mask():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 6, 32)).astype(np.float32)
    mask = TC.dropout_mask((4, 6, 32), 0.2, torch.Generator().manual_seed(1))
    assert set(torch.unique(mask).tolist()) == {0.0, 1.25}
    keep = float((mask > 0).float().mean())
    assert 0.7 < keep < 0.9
    out = TC.dropout(t(x), 0.2, mask, train=True)
    ref = np.asarray(jnp.asarray(x) * jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    # kept entries equal x / keep, as the JAX dropout scales them
    kept = mask.numpy() > 0
    np.testing.assert_allclose(out.numpy()[kept], x[kept] / 0.8, rtol=1e-6)
    # identity at eval, without a mask, or at rate 0
    for args in ((mask, False), (None, True)):
        assert torch.equal(TC.dropout(t(x), 0.2, *args), t(x))
    assert torch.equal(TC.dropout(t(x), 0.0, mask, True), t(x))
    # bf16 masks round exactly (0 and 1.25 are bf16 numbers)
    mb = TC.dropout_mask((64,), 0.2, torch.Generator().manual_seed(2), dtype=torch.bfloat16)
    assert mb.dtype == torch.bfloat16 and set(torch.unique(mb.float()).tolist()) <= {0.0, 1.25}


@pytest.mark.parametrize("shape", [(8, 5, 24), (3, 4, 1)])
def test_batch_norm1d_train_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    x, scale, offset, rm, rv = bn_inputs(rng, shape, shape[1])
    out, m, v = TC.batch_norm1d(t(x), t(scale), t(offset), t(rm), t(rv), train=True)
    jo, jm, jv = JC.batch_norm1d(*(jnp.asarray(a) for a in (x, scale, offset, rm, rv)), train=True)
    for a, b in ((out, jo), (m, jm), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=1e-6)
    # the running variance takes the unbiased variance
    n = shape[0] * shape[2]
    unb = x.var(axis=(0, 2)) * n / max(n - 1, 1)
    np.testing.assert_allclose(v.numpy(), 0.9 * rv + 0.1 * unb, rtol=1e-5)
    # eval form returns the output alone, from the running statistics
    ev = TC.batch_norm1d(t(x), t(scale), t(offset), t(rm), t(rv))
    je, _, _ = JC.batch_norm1d(*(jnp.asarray(a) for a in (x, scale, offset, rm, rv)), train=False)
    np.testing.assert_allclose(ev.numpy(), np.asarray(je), atol=TOL, rtol=1e-6)


@pytest.mark.parametrize("groups", [1, 3])
def test_group_batch_norm1d_matches_jax_and_sequential(groups):
    rng = np.random.default_rng(groups)
    x, scale, offset, rm, rv = bn_inputs(rng, (groups * 4, 6, 16), 6)
    out, m, v = TC.group_batch_norm1d(t(x), t(scale), t(offset), t(rm), t(rv), groups=groups)
    jo, jm, jv = JC.group_batch_norm1d(*(jnp.asarray(a) for a in (x, scale, offset, rm, rv)), groups=groups)
    for a, b in ((out, jo), (m, jm), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=1e-6)
    # G sequential batch_norm1d calls, the running stats chained in order
    sm, sv = t(rm), t(rv)
    for g, xg in enumerate(np.split(x, groups)):
        og, sm, sv = TC.batch_norm1d(t(xg), t(scale), t(offset), sm, sv, train=True)
        np.testing.assert_allclose(out.numpy()[g * 4:(g + 1) * 4], og.numpy(), atol=TOL, rtol=1e-6)
    np.testing.assert_allclose(m.numpy(), sm.numpy(), atol=TOL, rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), sv.numpy(), atol=TOL, rtol=1e-6)


def test_batch_norm_gradients_match_jax():
    rng = np.random.default_rng(7)
    x, scale, offset, rm, rv = bn_inputs(rng, (3 * 4, 6, 16), 6)
    ct = rng.normal(size=x.shape).astype(np.float32)
    xt, st, ot = (t(a).requires_grad_(True) for a in (x, scale, offset))
    out, _, _ = TC.group_batch_norm1d(xt, st, ot, t(rm), t(rv), groups=3)
    (out * t(ct)).sum().backward()

    def f(xx, ss, oo):
        o, _, _ = JC.group_batch_norm1d(xx, ss, oo, jnp.asarray(rm), jnp.asarray(rv), groups=3)
        return jnp.sum(o * ct)

    gj = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, scale, offset)))
    for a, b in zip((xt.grad, st.grad, ot.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def weights():
    params, state = jax_init_nefnet(jax.random.PRNGKey(3), lead_num=3)
    tp, ts = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                             {k: np.asarray(v) for k, v in state.items()})
    return params, state, tp, ts


def _jax_masked_block(fn, p, prefix, x, mask, **kw):
    """The JAX block with its dropout replaced by the given mask."""
    orig = JB.dropout
    JB.dropout = lambda h, rate, rng, train: h * mask
    try:
        return fn(p, prefix, x, rng=jax.random.PRNGKey(0), train=True, **kw)
    finally:
        JB.dropout = orig


@pytest.mark.parametrize("block", ["resnet", "model", "model_residual"])
def test_train_blocks_match_jax(weights, block):
    params, _, tp, _ = weights
    rng = np.random.default_rng(11)
    if block == "resnet":
        prefix, shape, groups, fj, ft = "W_encoder.layer1.1", (2, 384, 128), 3, JB.resnet_block, TB.resnet_block_apply
    elif block == "model":
        prefix, shape, groups, fj, ft = "w_conv.0", (2, 384, 128), 3, JB.model_block, TB.model_block_apply
    else:
        prefix, shape, groups, fj, ft = "z1_conv.0", (2, 192, 128), 3, JB.model_block, TB.model_block_apply
    x = rng.normal(size=shape).astype(np.float32)
    mshape = (shape[0], 384, 128)
    mask = TC.dropout_mask(mshape, 0.2, torch.Generator().manual_seed(5))
    out = ft(tp, prefix, t(x), groups=groups, mask=mask, train=True)
    ref = _jax_masked_block(fj, params, prefix, jnp.asarray(x), jnp.asarray(mask.numpy()), groups=groups)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # eval ignores the mask
    assert torch.equal(ft(tp, prefix, t(x), groups=groups, mask=mask, train=False),
                       ft(tp, prefix, t(x), groups=groups))


@pytest.mark.parametrize("bn_groups", [1, 3])
def test_train_decoder_state_updates_match_jax(weights, bn_groups):
    params, state, tp, ts = weights
    rng = np.random.default_rng(bn_groups)
    x = rng.normal(size=(bn_groups * 2, 256, 128)).astype(np.float32)
    out, upd = decoder_apply(tp, ts, t(x), train=True, bn_groups=bn_groups)
    jout, jupd = jax_decoder_apply(params, state, jnp.asarray(x), train=True, bn_groups=bn_groups)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    assert sorted(upd) == sorted(jupd) and len(upd) == 12
    for k, v in upd.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ts[k]) + bn_groups == int(jupd[k])
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(jupd[k]), atol=TOL, rtol=1e-5)
