"""`ops.conv1d_measured` on the card (its CPU tests are in test_torch_ops.py
and test_torch_nefnet2.py): cuDNN's find mode over Nef-Net2's tower
convolution.

  * out, dx, dw within float32 rounding of the same convolution in float64
    (relative L2 1e-5, at 128 x 7 = 896 products a sum). Not against
    `conv1d` in float32: cuDNN keeps one plan per key whichever mode chose
    it, so after one of the two has run, the other takes its plan;
  * the first call measures three keys (fwd, dgrad, wgrad), a second call of
    the same shape none;
  * the memory the first call reserves stays under FIND_HEADROOM_BYTES, and the
    cuDNN and TF32 flags and the per-process memory fraction are restored.
"""

import pytest
import torch

from electrocardio_panorama_tpu_torch import ops
from electrocardio_panorama_tpu_torch.ops import convs


@pytest.mark.cuda
def test_cuda_measured_conv_matches_conv1d_within_its_headroom():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuDNN's find mode exists only on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(24)
    # the tower's k7 convolution over B*L = 96 folded rows (models/nefnet2.py)
    x = torch.randn(96, 128, 128, device=dev, generator=g)
    w = torch.randn(128, 128, 7, device=dev, generator=g) * 0.03
    dy = torch.randn(96, 128, 128, device=dev, generator=g)
    flags = lambda: (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,  # noqa: E731
                     torch.backends.cuda.matmul.allow_tf32, torch.cuda.get_per_process_memory_fraction(dev))
    before = flags()

    def run(conv, dtype=torch.float32):
        xx, ww = (t.to(dtype, copy=True).requires_grad_(True) for t in (x, w))
        y = conv(xx, ww, padding=3)
        with ops.full_f32():
            y.backward(dy.to(dtype))
        return y.detach(), xx.grad, ww.grad

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_reserved(dev)
    shapes = convs.MEASURED["shapes"]
    got = run(ops.conv1d_measured)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_reserved(dev) - base
    assert convs.MEASURED["shapes"] - shapes == 3, dict(convs.MEASURED)
    assert flags() == before, (flags(), before)
    assert added <= convs.FIND_HEADROOM_BYTES, added
    run(ops.conv1d_measured)
    assert convs.MEASURED["shapes"] - shapes == 3 and flags() == before, (dict(convs.MEASURED), flags())
    want = run(ops.conv1d, torch.float64)
    for name, a, b in zip(("out", "dx", "dw"), got, want):
        rel = float((a.double() - b).norm() / b.norm())
        assert rel <= 1e-5, (name, rel)
