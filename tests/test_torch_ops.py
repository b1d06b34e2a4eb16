"""Port ops against the JAX package's ops on the same numpy inputs (CPU, f32).

Cases follow tests/test_convs.py and tests/test_roi.py. Tolerance: atol 1e-5
in float32 — both sides compute the same formulas, differing only in
summation order and in XLA's vs PyTorch's CPU kernels.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu import ops as jops
from electrocardio_panorama_tpu_torch import ops as tops

ATOL = 1e-5


def make_rois(rng, batch, n_seg=7, total=512):
    """Contiguous ROI partitions from 0 to 512, as the dataset emits them."""
    rois = []
    for _ in range(batch):
        cuts = np.sort(rng.choice(np.arange(4, total - 4, 4), size=n_seg - 1, replace=False))
        pts = np.concatenate([[0], cuts, [total]])
        rois.append(np.stack([pts[:-1], pts[1:]], axis=1))
    return np.stack(rois).astype(np.int64)


def close(ours: torch.Tensor, ref, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("encoder_len", [1, 2])
def test_angular_encode_matches_jax(rng, encoder_len):
    theta = rng.uniform(-np.pi, np.pi, (4, 7, 2)).astype(np.float32)
    ours = tops.angular_encode(torch.tensor(theta), encoder_len)
    assert ours.shape == (4, 7, tops.theta_feature_dim(encoder_len))
    close(ours, jops.angular_encode(jnp.asarray(theta), encoder_len))


def test_upsample_linear_x2_matches_jax(rng):
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    close(tops.upsample_linear_x2(torch.tensor(x)), jops.upsample_linear_x2(jnp.asarray(x)))


@pytest.mark.parametrize("conv", ["conv1d", "conv1d_measured"])
@pytest.mark.parametrize("case", ["stem_k15_s2_grouped", "k3_bias", "k1_grouped_bias"])
def test_conv1d_matches_jax(rng, case, conv):
    if case == "stem_k15_s2_grouped":  # encoder stem (resnet_1d.py:102-103)
        x, w, b, kw = (rng.standard_normal((2, 3, 512)), rng.standard_normal((384, 1, 15)), None,
                       dict(stride=2, padding=7, groups=3))
    elif case == "k3_bias":
        x, w, b, kw = (rng.standard_normal((2, 8, 64)), rng.standard_normal((16, 8, 3)),
                       rng.standard_normal(16), dict(padding=1))
    else:  # residual 1x1 of a grouped model block
        x, w, b, kw = (rng.standard_normal((2, 12, 32)), rng.standard_normal((24, 4, 1)),
                       rng.standard_normal(24), dict(groups=3))
    t = lambda a: None if a is None else torch.tensor(np.float32(a))  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(np.float32(a))  # noqa: E731
    close(getattr(tops, conv)(t(x), t(w), t(b), **kw), jops.conv1d(j(x), j(w), j(b), **kw))


# Nef-Net2's encode over folded rows: (x shape, weight shape, bias, conv kwargs)
MEASURED_CASES = {
    "conv1_k15_s2": ((3, 1, 512), (128, 1, 15), False, dict(stride=2, padding=7)),
    "tower_k7": ((3, 128, 128), (128, 128, 7), False, dict(padding=3)),
    "z_block_k3": ((3, 64, 128), (128, 64, 3), False, dict(padding=1)),
    "z_residual_k1": ((3, 64, 128), (128, 64, 1), True, {}),
    "single_conv_k3": ((3, 128, 128), (128, 128, 3), True, dict(padding=1)),
    "z2_conv2_0_g7": ((2, 896, 16), (896, 128, 3), False, dict(padding=1, groups=7)),
    "z2_conv2_2_g7": ((2, 448, 32), (896, 64, 3), False, dict(padding=1, groups=7)),
    "z2_conv2_2_residual_g7": ((2, 448, 32), (896, 64, 1), True, dict(groups=7)),
}


GRADS = {"all": (True, True), "no_input": (False, True), "no_weight": (True, False),
         "only_bias": (False, False)}


@pytest.mark.parametrize("case,grads", [(c, g) for c, spec in MEASURED_CASES.items() for g in GRADS
                                        if spec[2] or g != "only_bias"])
def test_conv1d_measured_equals_conv1d_under_autograd(case, grads):
    """The forward and the input, weight and bias gradients that autograd
    asks for equal `conv1d`'s bit for bit; the others stay None."""
    xs, ws, has_bias, kw = MEASURED_CASES[case]
    g = torch.Generator().manual_seed(sum(xs) + sum(ws))
    x, w = torch.randn(xs, generator=g), torch.randn(ws, generator=g) * 0.1
    b = torch.randn(ws[0], generator=g) if has_bias else None
    needs = GRADS[grads]
    runs = []
    for conv in (tops.conv1d, tops.conv1d_measured):
        xx, ww = x.clone().requires_grad_(needs[0]), w.clone().requires_grad_(needs[1])
        bb = None if b is None else b.clone().requires_grad_(True)
        y = conv(xx, ww, bb, **kw)
        (y * torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape)).sum().backward()
        runs.append((y, xx.grad, ww.grad, None if bb is None else bb.grad))
    for name, ours, want in zip(("out", "dx", "dw", "db"), runs[1], runs[0]):
        if want is None:
            assert ours is None, name
        else:
            assert torch.equal(ours, want), name


def test_conv_transpose_k2s2_matches_jax(rng):
    # z2_conv2.1: groups = 7 segments x 3 leads (model_nefnet.py:96-97)
    G, cin_pg, cout_pg, L = 21, 16, 8, 16
    x = rng.standard_normal((2, G * cin_pg, L)).astype(np.float32)
    w = rng.standard_normal((G * cin_pg, cout_pg, 2)).astype(np.float32)
    b = rng.standard_normal((G * cout_pg,)).astype(np.float32)
    ours = tops.conv_transpose1d_k2s2(torch.tensor(x), torch.tensor(w), torch.tensor(b), groups=G)
    assert ours.shape == (2, G * cout_pg, 2 * L)
    close(ours, jops.conv_transpose1d_k2s2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=G))


def test_max_pool1d_matches_jax(rng):
    x = rng.standard_normal((2, 4, 256)).astype(np.float32)
    close(tops.max_pool1d(torch.tensor(x)), jops.max_pool1d(jnp.asarray(x), kernel=3, stride=2, padding=1),
          atol=0)


def test_linear_and_eval_batch_norm_match_jax(rng):
    x = rng.standard_normal((4, 7, 12)).astype(np.float32)
    w = rng.standard_normal((128, 12)).astype(np.float32)
    b = rng.standard_normal((128,)).astype(np.float32)
    close(tops.linear(torch.tensor(x), torch.tensor(w), torch.tensor(b)),
          jops.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    h = rng.standard_normal((4, 6, 32)).astype(np.float32)
    scale, offset, mean = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    var = (np.abs(rng.standard_normal(6)) + 0.5).astype(np.float32)
    ours = tops.batch_norm1d(*(torch.tensor(a) for a in (h, scale, offset, mean, var)))
    ref, _, _ = jops.batch_norm1d(*(jnp.asarray(a) for a in (h, scale, offset, mean, var)), train=False)
    close(ours, ref)
    th = torch.tensor(h)
    assert tops.dropout(th, 0.2, None, False) is th  # identity at eval


def test_roi_align_matches_jax(rng):
    x = rng.standard_normal((3, 8, 128)).astype(np.float32)
    rois = make_rois(rng, 3)
    ours = tops.roi_align_1d(torch.tensor(x), torch.tensor(rois))
    assert ours.shape == (3, 8, 7, 16)
    close(ours, jops.roi_align_1d(jnp.asarray(x), jnp.asarray(rois)))


@pytest.mark.parametrize("degenerate", [False, True])
def test_roi_reverse_matches_jax(rng, degenerate):
    if degenerate:  # segment 1 is empty after scaling (the reference skips it)
        pts = np.array([0, 40, 40, 160, 260, 330, 470, 512])
        rois = np.stack([pts[:-1], pts[1:]], axis=1)[None].astype(np.int64)
    else:
        rois = make_rois(rng, 3)
    x = rng.standard_normal((rois.shape[0], 8, 7, 32)).astype(np.float32)
    ours = tops.roi_reverse_1d(torch.tensor(x), torch.tensor(rois))
    assert ours.shape == (rois.shape[0], 8, 128)
    close(ours, jops.roi_reverse_1d(jnp.asarray(x), jnp.asarray(rois)))


def test_full_f32_pins_and_restores_tf32_flags():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with tops.full_f32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def test_conv1d_measured_sets_and_restores_the_flags(monkeypatch):
    """cuDNN's find mode is on inside the forward and the backward; after
    each, and after a call that raises, the three flags are as they were.
    TF32 is pinned off inside for a float32 CUDA tensor (`precise`)."""
    flags = lambda: (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,  # noqa: E731
                     torch.backends.cuda.matmul.allow_tf32)
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            seen[name] = flags()
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torch.nn.functional, "conv1d", spy("fwd", torch.nn.functional.conv1d))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward",
                        spy("bwd", torch.ops.aten.convolution_backward))
    for before in [(False, True, False), (True, False, True)]:
        monkeypatch.setattr(torch.backends.cudnn, "benchmark", before[0])
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before[1])
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before[2])
        x = torch.randn(2, 4, 16, requires_grad=True)
        y = tops.conv1d_measured(x, torch.randn(8, 4, 3, requires_grad=True), padding=1)
        assert seen.pop("fwd") == (True, *before[1:]) and flags() == before
        y.sum().backward()
        assert seen.pop("bwd") == (True, *before[1:]) and flags() == before
        with pytest.raises(RuntimeError):
            tops.conv1d_measured(x, torch.randn(8, 5, 3))  # 4 input channels, weight for 5
        assert flags() == before
        cuda_f32 = type("CudaF32", (), {"is_cuda": True, "dtype": torch.float32})()
        with tops.convs._measured(cuda_f32, new_key=False):
            assert flags() == (True, False, False)
        assert flags() == before
