"""The port's 1-D ResNet family against the JAX package, on the CPU.

The cases of tests/test_resnet1d.py (shapes per depth, train-mode BN updates
of the Bottleneck, grouped lead towers, features only), then forward parity
with the JAX package for one BasicBlock and one Bottleneck depth on the
same weights (JAX init, through `convert.params_from_jax`): eval scores and
features atol 1e-5; train mode with the port's dropout masks handed to the
JAX blocks in call order, scores atol 1e-5 and the BN running statistics
atol 1e-5, `num_batches_tracked` exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.models import resnet1d as JR
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models.resnet1d import (
    LAYER_SPECS,
    dropout_sites,
    init_resnet1d,
    resnet1d_apply,
)
from electrocardio_panorama_tpu_torch.ops import dropout_mask

TOL = 1e-5


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("arch", list(LAYER_SPECS))
def test_resnet1d_shapes_per_depth(arch, rng):
    params, state, meta = init_resnet1d(gen(0), arch, in_channel=8, num_classes=55, init_channels=4)
    block, layers = LAYER_SPECS[arch]
    assert meta["block"] == block and [len(lp) for lp in meta["plan"]] == layers
    assert meta["out_features"] == 4 * 8 * (4 if block == "bottleneck" else 1)
    # BasicBlocks have no BatchNorm but the downsample paths'
    assert all(".downsample." in k for k in state) == (block == "basic")
    x = torch.tensor(rng.standard_normal((2, 8, 256)).astype(np.float32))
    probs, updates = resnet1d_apply(params, state, meta, x)
    assert probs.shape == (2, 55) and updates == {}
    assert bool(torch.isfinite(probs).all()) and bool(((probs >= 0) & (probs <= 1)).all())


def test_resnet1d_bottleneck_train_mode_updates_bn(rng):
    params, state, meta = init_resnet1d(gen(1), "resnet50", in_channel=4, num_classes=5, init_channels=8)
    x = torch.tensor(rng.standard_normal((2, 4, 256)).astype(np.float32))
    _, updates = resnet1d_apply(params, state, meta, x, train=True, generator=gen(2))
    bn = {k.rsplit(".", 1)[0] for k in state}
    assert set(updates) == set(state) and len(bn) == 3 * 16 + 4  # bn1-3 per block, one downsample per layer
    for k, v in updates.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1
        elif k.endswith("running_mean"):
            assert not torch.equal(v, state[k])


def test_resnet1d_grouped_lead_towers(rng):
    params, state, meta = init_resnet1d(gen(3), "resnet18", in_channel=3, num_classes=4, lead_num=3,
                                        init_channels=8)
    assert params["conv1.weight"].shape == (24, 1, 15)
    assert params["layer2.0.conv1.weight"].shape == (48, 8, 7)  # one private tower per lead
    x = torch.tensor(rng.standard_normal((2, 3, 512)).astype(np.float32))
    probs, _ = resnet1d_apply(params, state, meta, x)
    assert probs.shape == (2, 4)
    # lead 0's tower sees lead 0 only: its stem output ignores the other leads
    x2 = x.clone()
    x2[:, 1:] = 0
    stem = torch.nn.functional.conv1d(x, params["conv1.weight"], stride=2, padding=7, groups=3)[:, :8]
    stem2 = torch.nn.functional.conv1d(x2, params["conv1.weight"], stride=2, padding=7, groups=3)[:, :8]
    assert torch.equal(stem, stem2)


def test_resnet1d_features_only_width(rng):
    params, state, meta = init_resnet1d(gen(4), "resnet34", in_channel=8, num_classes=10, init_channels=8)
    x = torch.tensor(rng.standard_normal((2, 8, 512)).astype(np.float32))
    feats, _ = resnet1d_apply(params, state, meta, x, features_only=True)
    assert feats.shape == (2, meta["out_features"]) == (2, 64)
    probs, _ = resnet1d_apply(params, state, meta, x)
    ref = torch.sigmoid(feats @ params["fc.weight"].T + params["fc.bias"])
    torch.testing.assert_close(probs, ref, rtol=1e-6, atol=1e-6)


def test_resnet1d_dropout_takes_masks_or_a_generator(rng):
    params, state, meta = init_resnet1d(gen(5), "resnet18", in_channel=2, num_classes=3, init_channels=4)
    x = torch.tensor(rng.standard_normal((2, 2, 128)).astype(np.float32))
    a, _ = resnet1d_apply(params, state, meta, x, train=True, generator=gen(6))
    b, _ = resnet1d_apply(params, state, meta, x, train=True, generator=gen(6))
    c, _ = resnet1d_apply(params, state, meta, x, train=True, generator=gen(7))
    off, _ = resnet1d_apply(params, state, meta, x, train=True)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, off)
    ones = [torch.ones(1)] * dropout_sites(meta)
    assert torch.equal(resnet1d_apply(params, state, meta, x, train=True, masks=ones)[0], off)
    # at eval the generator draws nothing
    assert torch.equal(resnet1d_apply(params, state, meta, x, generator=gen(6))[0],
                       resnet1d_apply(params, state, meta, x)[0])


def jax_weights(arch, **kw):
    params, state, meta = JR.init_resnet1d(jax.random.PRNGKey(0), arch, **kw)
    tp, ts = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                             {k: np.asarray(v) for k, v in state.items()})
    return params, state, meta, tp, ts


@pytest.mark.parametrize("arch,lead_num", [("resnet18", 2), ("resnet50", 1)])
def test_resnet1d_forward_matches_jax(arch, lead_num, rng, monkeypatch):
    kw = dict(in_channel=4, num_classes=6, lead_num=lead_num, init_channels=8)
    jp, js, jmeta, tp, ts = jax_weights(arch, **kw)
    _, _, meta = init_resnet1d(gen(0), arch, **kw)
    assert meta == jmeta and set(tp) == set(jp) and set(ts) == set(js)
    x = rng.standard_normal((2, 4, 256)).astype(np.float32)
    for features_only in (False, True):
        out, _ = resnet1d_apply(tp, ts, meta, torch.tensor(x), features_only=features_only)
        ref, _ = JR.resnet1d_apply(jp, js, jmeta, jnp.asarray(x), features_only=features_only)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)

    # train mode: the port's masks drawn in block order, fed to the JAX blocks
    shapes = []
    monkeypatch.setattr("electrocardio_panorama_tpu_torch.models.resnet1d.dropout",
                        lambda h, rate, m, train: shapes.append(h.shape) or h)
    resnet1d_apply(tp, ts, meta, torch.tensor(x), train=True)
    monkeypatch.undo()
    masks = [dropout_mask(s, 0.2, gen(9)) for s in shapes]
    assert len(masks) == dropout_sites(meta)
    queue = iter([jnp.asarray(m.numpy()) for m in masks])
    monkeypatch.setattr(JR, "dropout", lambda h, rate, key, train: h * next(queue))
    out, upd = resnet1d_apply(tp, ts, meta, torch.tensor(x), train=True, masks=masks)
    ref, jupd = JR.resnet1d_apply(jp, js, jmeta, jnp.asarray(x), train=True, rng=jax.random.PRNGKey(1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    assert set(upd) == set(jupd)
    for k, v in upd.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(jupd[k]) == 1
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(jupd[k]), atol=TOL, rtol=1e-5, err_msg=k)
