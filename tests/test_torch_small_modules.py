"""The port's small modules against the JAX package's, on the CPU:

  * `ops.roi_pool_1d` against the reference's loop of `adaptive_max_pool1d`
    (the case of tests/test_roi.py) and bit for bit against the JAX function
    (a max is exact);
  * `utils/transforms.py`: the transforms' outputs equal the JAX ones, the
    ROC helper returns the same AUC, and both plot helpers write a PNG;
  * `Solver.paint`, `paint_for_other_method` and `paint_for_mit` write the
    same files as the JAX Solver's methods on the same arrays;
  * `utils/flops.py`: each hand count lies at most 3% below the JAX package's
    XLA count, never above. XLA's cost analysis counts the same multiply-adds
    over the in-bounds taps (2 FLOPs each) plus the elementwise work the hand
    count leaves out: biases, relu, BatchNorm, dropout, upsampling, the gates,
    the loss and the update, a few FLOPs per activation element against 2*C*k
    per output element of a conv; it is 0.4% (encode) to 2.2% (train step)
    of XLA's totals. `basis_decode_executed_flops_per_view` equals the JAX
    one exactly on the JAX encode count.
"""

import os
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from electrocardio_panorama_tpu.ops import roi_pool_1d as jax_roi_pool_1d
from electrocardio_panorama_tpu.training.solver import Solver as JaxSolver
from electrocardio_panorama_tpu.utils import flops as JF
from electrocardio_panorama_tpu.utils import transforms as JT
from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.ops import roi_pool_1d
from electrocardio_panorama_tpu_torch.training.solver import Solver
from electrocardio_panorama_tpu_torch.utils import flops as PF
from electrocardio_panorama_tpu_torch.utils import transforms as PT


def make_rois(rng, batch, n_seg=7, total=512):
    """Contiguous ROI partitions like the dataset emits (tests/test_roi.py)."""
    rois = []
    for _ in range(batch):
        cuts = np.sort(rng.choice(np.arange(4, total - 4, 4), size=n_seg - 1, replace=False))
        pts = np.concatenate([[0], cuts, [total]])
        rois.append(np.stack([pts[:-1], pts[1:]], axis=1))
    return np.stack(rois).astype(np.int64)


def torch_roi_pool(inp, rois, size, spatial_scale):
    """The reference's `roi_pooling` loop (tests/test_roi.py)."""
    r = (torch.tensor(rois, dtype=torch.float32) * spatial_scale).long()
    out = []
    for i in range(inp.shape[0]):
        segs = []
        for j in range(r.shape[1]):
            im = torch.tensor(inp[i : i + 1])[..., r[i, j, 0] : r[i, j, 1] + 1]
            segs.append(F.adaptive_max_pool1d(im, size))
        out.append(torch.cat(segs))
    return torch.stack(out).transpose(1, 2)


def test_roi_pool_parity(rng):
    x = rng.standard_normal((2, 4, 512)).astype(np.float32)
    rois = make_rois(rng, 2)
    ref = torch_roi_pool(x, rois, size=8, spatial_scale=1.0)
    ours = roi_pool_1d(torch.tensor(x), torch.tensor(rois), size=8, spatial_scale=1.0)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("size,scale,length", [(8, 1.0, 512), (16, 128 / 512, 128), (5, 0.5, 256)])
def test_roi_pool_equals_jax(size, scale, length):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((3, 6, length)).astype(np.float32)
    rois = make_rois(rng, 3)
    ours = roi_pool_1d(torch.tensor(x), torch.tensor(rois), size=size, spatial_scale=scale)
    theirs = jax_roi_pool_1d(jnp.asarray(x), jnp.asarray(rois), size=size, spatial_scale=scale)
    assert ours.shape == (3, 6, 7, size) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_transforms_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    sig = rng.standard_normal(512) * 3 + 1
    for lo, hi in ((0.0, 1.0), (-1.0, 2.5)):
        np.testing.assert_array_equal(PT.scale_signal(sig, lo, hi), JT.scale_signal(sig, lo, hi))
        np.testing.assert_array_equal(PT.Scale(lo, hi)(sig), JT.Scale(lo, hi)(sig))
    flat = np.full(8, 2.0)
    np.testing.assert_array_equal(PT.scale_signal(flat, 0.5), JT.scale_signal(flat, 0.5))
    ours = PT.Compose([PT.Scale(-1, 1), PT.to_array])(list(sig))
    theirs = JT.Compose([JT.Scale(-1, 1), JT.to_array])(list(sig))
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)

    gt = rng.integers(0, 2, 200)
    scores = gt * 0.3 + rng.uniform(0, 1, 200)
    auc = PT.plot_roc_curve(gt, scores, str(tmp_path / "roc.png"))
    assert auc == JT.plot_roc_curve(gt, scores, str(tmp_path / "roc_jax.png")) and 0.5 < auc < 1
    cm = rng.integers(0, 20, (3, 3))
    for normalize in (False, True):
        PT.plot_confusion_matrix(cm, ["a", "b", "c"], str(tmp_path / f"cm{normalize}.png"), normalize=normalize)
    for name in ("roc.png", "cmFalse.png", "cmTrue.png"):
        assert open(tmp_path / name, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_paint_writes_the_jax_solvers_files(tmp_path):
    rng = np.random.default_rng(1)
    target, pred = rng.uniform(0, 1, (2, 3, 64)), rng.uniform(0, 1, (2, 3, 64))
    inputs = rng.uniform(0, 1, (2, 2, 64))
    cfg = get_cfg()
    cfg.MODEL.model = "model_nefnet"
    cfg.output_dir = str(tmp_path / "port")
    port = Solver(cfg, use_writer=False, device="cpu")
    jax_self = types.SimpleNamespace(output_dir=str(tmp_path / "jax"))
    calls = (("paint", dict(input_data=inputs, epoch=3, flag="train")),
             ("paint", dict(epoch=4, flag="test")),
             ("paint_for_other_method", dict(epoch=5, flag="test")),
             ("paint_for_mit", dict(epoch=6, flag="val")))
    for name, kw in calls:
        getattr(port, name)(target, pred, **kw)
        getattr(JaxSolver, name)(jax_self, target, pred, **kw)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    ours, theirs = files(port.output_dir), files(jax_self.output_dir)
    assert ours == theirs == [f"{e}_{f}/{i}.png" for e, f in ((3, "train"), (4, "test"), (5, "test"), (6, "val"))
                              for i in range(2)]
    for rel in ours:
        assert open(os.path.join(port.output_dir, rel), "rb").read() == \
            open(os.path.join(jax_self.output_dir, rel), "rb").read(), rel
    assert Solver.paint_for_mit is Solver.paint_for_other_method
    port.rank0 = False  # under a mesh only rank 0 paints
    port.paint(target, pred, epoch=9, flag="train")
    assert not os.path.exists(os.path.join(port.output_dir, "9_train"))


@pytest.mark.parametrize("name", ["ENCODE_FLOPS_PER_BEAT", "DECODE_FLOPS_PER_VIEW",
                                  "FULL_WORKLOAD_FLOPS_PER_VIEW", "TRAIN_STEP_FLOPS_B32"])
def test_hand_flop_counts_lie_just_below_xla(name):
    ours, xla = getattr(PF, name), getattr(JF, name)
    assert 0.97 * xla <= ours <= xla, f"{name}: {ours:.6g} vs XLA {xla:.6g} ({ours / xla:.4f})"


def test_flop_helpers():
    # conv_macs counts the taps inside the input, as XLA does: k7 p3 over 128
    # positions loses 3+2+1 taps at each edge
    assert PF.conv_macs(384, 128, 7, 128, padding=3) == 384 * 128 * (7 * 128 - 12)
    assert PF.conv_macs(384, 1, 15, 512, stride=2, padding=7) == 384 * 15 * 256 - 384 * (7 + 6 + 5 + 4 + 3 + 2 + 1)
    assert PF.basis_decode_executed_flops_per_view(encode_flops_per_beat=JF.ENCODE_FLOPS_PER_BEAT) == \
        JF.basis_decode_executed_flops_per_view()
    assert PF.basis_decode_executed_flops_per_view(v_tile=24, j=9, encode_flops_per_beat=JF.ENCODE_FLOPS_PER_BEAT) \
        == JF.basis_decode_executed_flops_per_view(v_tile=24, j=9)
    ex = PF.basis_decode_executed_flops_per_view()
    assert 0.3 * PF.FULL_WORKLOAD_FLOPS_PER_VIEW < ex < PF.FULL_WORKLOAD_FLOPS_PER_VIEW
    assert (PF.H100_F32_FLOPS, PF.H100_BF16_FLOPS, PF.H100_BYTES_PER_S) == (67e12, 989e12, 3.35e12)
    assert PF.mfu_pct(PF.H100_BF16_FLOPS * 0.5, 1.0) == pytest.approx(50.0)
    assert PF.mfu_pct(1e12, 0.1, PF.H100_F32_FLOPS) == pytest.approx(100.0 * 1e13 / 67e12)
