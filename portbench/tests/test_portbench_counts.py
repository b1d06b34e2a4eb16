"""The frozen counts: Nef-Net's published numbers, Nef-Net2's hand count held
against torch's FlopCounterMode over the plain reference, and the kernels'
bounds counting no plane kept between a forward and its backward."""

import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.counts import kernels, nefnet, nefnet2
from portbench.reference import nefnet as ref
from portbench.traffic import generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_nefnet_step_and_render_counts():
    assert nefnet.train_step_flops(32) == 120_992_096_256
    assert nefnet.train_step_flops(128) == 483_968_385_024
    assert nefnet.render_flops_per_view(336) == pytest.approx(75.968768e6, abs=1.0)


def test_counts_equal_the_programs_flops_module():
    from electrocardio_panorama_tpu_torch.utils import flops

    assert nefnet.train_step_flops(32) == flops.TRAIN_STEP_FLOPS_B32
    assert nefnet.encode_flops_per_beat() == flops.ENCODE_FLOPS_PER_BEAT
    assert nefnet.render_flops_per_view(336) == flops.basis_decode_executed_flops_per_view()


@pytest.mark.parametrize("cell,counts", [("nefnet.train.f32.b85", nefnet), ("nefnet2.train.f32.b32", nefnet2)])
def test_step_count_against_flop_counter(cell, counts):
    """FlopCounterMode counts every conv tap, zero padding included, and no
    elementwise work. Over the reference's train forward it equals the hand
    count over all taps; the published count differs from that by the
    padding taps alone. (Its convolution_backward count is not held: for
    grouped convolutions it reads 2.4x to 2.8x the forward, above the data
    and weight gradients' 2x.)"""
    c = harness.load_cell(ROOT, cell)
    B = 2
    params, bn_state = harness.make_weights(c, 3, torch.device("cpu"))
    b = generator.pool(dict(c.mix, batch=B, pool=1), c.data_cfg(), 3)[0]
    keys = ("data", "input_theta", "target_theta", "rois", "target_view")
    batch = {k: torch.as_tensor(b[k]) for k in keys}
    s = {k: v.clone() for k, v in bn_state.items()}
    mats = ref.roi_reverse_matrices(ref.reverse_rows(c.model, batch["rois"], c.lead_num), "cpu")
    masks = ref.dropout_masks(c.model, 3, 0, 0, B, c.lead_num, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.forward_train(c.model, params, s, batch, masks, 0, 1, c.lead_num, mats)
    assert fc.get_total_flops() == counts.train_step_flops(B, taps="all", backward=False)
    padding = counts.train_step_flops(B, taps="all") - counts.train_step_flops(B)
    assert 0 < padding < 0.02 * counts.train_step_flops(B)


def test_nefnet2_count_by_layer():
    """Per beat of 3 leads, forward: the tower 3 x (128*15*~256 + 6*128*128*7*128), the z-blocks,
    two single convs, the ROI grid blocks and the decodes; a hand sum of the
    largest terms lies within the count."""
    fwd = nefnet2.encode_flops_per_beat()
    tower = 3 * 2 * 6 * 128 * 128 * 7 * 128
    assert tower < fwd < 2 * tower


def test_a4f_and_a4b_leave_out_the_kept_planes():
    nb, G = 32, 3
    x = G * 256 * nb * 128
    weights = 3 * (128 * 256 + 128 * 128 + 64 * 128 + 64 * 64 + 64)
    f32_rest = 128 + 64 + 64 + 1 + 128 + 2 * (128 + 128 + 64 + 64)
    # A4f reads x and the weights (storage dtype), float32 biases and BN
    # affines, and writes the output and the moments; its planes for A4b
    # (a1..a4 and h4 float32, h1..h3 in the storage dtype: 88 MB in bf16) are
    # not counted
    for dt, sz in (("bfloat16", 2), ("float32", 4)):
        flops, n_bytes = kernels.a4f_work(nb, dt)
        assert n_bytes == sz * (x + weights) + 4 * (f32_rest + G * nb * 512 + 2 * G * 4 * 128)
        planes = G * nb * (4 * (2 * 128 * 256 + 3 * 64 * 512) + sz * (2 * 128 * 256 + 64 * 512))
        assert n_bytes < planes / 4
        b_flops, b_bytes = kernels.a4b_work(nb, dt)
        assert b_flops == 2 * flops
        assert b_bytes == 2 * sz * x + 4 * G * nb * 512 + sz * weights + 4 * f32_rest + 4 * (weights + f32_rest)
    assert kernels.bound_of("a4f", nb, dtype="bfloat16") == pytest.approx(kernels.a4f_work(nb, "bfloat16")[0]
                                                                         / 989e12, rel=1e-12)


def test_kernel_bounds_at_the_kernel_tables_shapes():
    """The bounds of the program's kernel table (B=32, V=336; 3 groups of
    32), float32, all bound by operations."""
    ms = {k: kernels.bound_of(k, *shape, dtype="float32") * 1e3
          for k, shape in (("a1", (32, 336)), ("a2", (32, 3)), ("a3", (32, 3)), ("a4f", (32,)), ("a4b", (32,)))}
    assert ms == pytest.approx({"a1": 10.265, "a2": 0.439, "a3": 0.877, "a4f": 0.163, "a4b": 0.325}, abs=5e-4)
