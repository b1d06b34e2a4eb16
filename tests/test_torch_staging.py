"""A train step's inputs never wait for the card: the batch reaches the
device through the Solver's pinned slots (`ops.staging.PinnedStaging`), and
a dropout mask's scale is a Python float (`ops.dropout_mask`).

On the CPU (tier-1):
  * `dropout_mask` is the mask that scaled by a tensor copied to the device,
    bit for bit, in float32 and bfloat16, at rates 0.1, 0.2 and 0.5;
  * `Solver._tensors` on a CPU Solver returns the arrays' own memory as
    tensors and counts each array under `pageable` alone.

On the card (`cuda`):
  * the staged device tensors equal the host arrays bit for bit over calls
    that wrap the ring of two slots while the card is busy (so a slot's
    earlier copy is still pending when the host comes back to it), with the
    arrays overwritten after each call and a batch of a new shape; STAGED
    counts every array under `staged`;
  * no drain: after warm-up, with the card held busy by a sleep kernel, a
    train step returns before the card has reached the event recorded after
    the sleep: Nef-Net through the fused float32 encoder and decoder,
    Nef-Net2 through its graphed encode, the 1-D ResNet-34 at a cut width.
    Not the ResNet-50: its step launches more kernels than the card's queue
    holds (about 1,024), so the host waits for room in the queue behind the
    sleep whatever the inputs do.
"""

import numpy as np
import pytest
import torch

from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.models import ResNet1dDef
from electrocardio_panorama_tpu_torch.ops import STAGED, dropout_mask
from electrocardio_panorama_tpu_torch.training import solver as solver_module
from electrocardio_panorama_tpu_torch.training.solver import Solver

# cycles of torch.cuda._sleep that keep the card busy well past a host step
# (about a second at the H100's clocks)
SLEEP_CYCLES = 2_000_000_000


def nefnet_cfg(tmp_path, model: str, batch: int, **tpu):
    cfg = get_cfg()
    cfg.desc, cfg.output_dir = "staging", str(tmp_path / "out")
    cfg.DATA.dataset, cfg.DATA.synthetic_root = "synthetic", str(tmp_path / "synth")
    cfg.DATA.lead_num, cfg.DATA.super_mode, cfg.DATA.train_data_mode = 3, "IIv2v5_v4I_372", "input_fix"
    cfg.DATA.batch_size = batch
    cfg.MODEL.model, cfg.MODEL.jitter_factor = model, 2.5
    cfg.SOLVER.lr, cfg.SOLVER.loss_factor = 0.05, [0.5, 0.5, 1]
    for k, v in tpu.items():
        cfg.TPU[k] = v
    return cfg


def resnet_cfg(tmp_path):
    cfg = get_cfg()
    cfg.desc, cfg.output_dir = "staging", str(tmp_path / "out")
    cfg.MODEL.model, cfg.MODEL.arch, cfg.MODEL.loss, cfg.MODEL.num_classes = "model_resnet1d", "resnet34", "bce", 5
    cfg.DATA.in_channel, cfg.DATA.lead_num = 8, 1
    cfg.SOLVER.lr = 0.1
    return cfg


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("seed,shape", [(3, (6, 4, 128, 16)), (2**33 + 5, (7, 5, 33))], ids=["enc", "odd"])
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dropout_mask_is_the_tensor_scaled_mask_bitwise(dtype, rate, seed, shape):
    got = dropout_mask(shape, rate, torch.Generator().manual_seed(seed), dtype=dtype)
    keep = 1.0 - rate
    u = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
    want = (u < keep).to(dtype) * torch.tensor(1.0 / keep, dtype=dtype, device=u.device)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
    assert set(want.unique().tolist()) == {0.0, float(torch.tensor(1.0 / keep, dtype=dtype))}


def test_cpu_tensors_are_the_arrays_and_count_pageable(tmp_path):
    solver = Solver(nefnet_cfg(tmp_path, "model_nefnet", 2), use_writer=False, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"data": rng.standard_normal((2, 3, 512)).astype(np.float32),
             "rois": rng.integers(0, 512, (2, 7, 2)), "noise": rng.standard_normal((2, 512))}
    keys = ("data", "rois", "noise")
    STAGED.clear()
    for _ in range(3):
        got = solver._tensors(batch, keys)
        for t, k in zip(got, keys):
            a = batch[k]
            assert t.device.type == "cpu" and t.data_ptr() == a.ctypes.data
            assert torch.equal(t, torch.from_numpy(a))
    assert dict(STAGED) == {"pageable": 9}


# ------------------------------------------------------------------ card
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned staging and the stream's order exist only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_staged_tensors_equal_the_arrays_bitwise(tmp_path):
    dev = card()
    solver = Solver(nefnet_cfg(tmp_path, "model_nefnet", 2), use_writer=False, device=dev)
    rng = np.random.default_rng(11)
    keys = ("data", "rois", "noise")

    def fill(batch):
        batch["data"][...] = rng.standard_normal(batch["data"].shape)
        batch["rois"][...] = rng.integers(0, 512, batch["rois"].shape)
        batch["noise"][...] = rng.standard_normal(batch["noise"].shape)
        return {k: v.copy() for k, v in batch.items()}

    def empty(B):
        return {"data": np.empty((B, 3, 512), np.float32), "rois": np.empty((B, 7, 2), np.int64),
                "noise": np.empty((B, 512), np.float64)}

    STAGED.clear()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES // 4)  # the copies queue behind it: the third call finds slot 0 pending
    batch, got, want = empty(8), [], []
    for B in (8, 8, 8, 8, 5, 5):
        if B != batch["data"].shape[0]:
            batch = empty(B)
        want.append(fill(batch))
        got.append(solver._tensors(batch, keys))
        fill(batch)  # the host's arrays change at once: the staged copies must not
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        for t, k in zip(g, keys):
            assert t.device == dev and t.dtype == torch.from_numpy(w[k]).dtype
            assert torch.equal(t.cpu(), torch.from_numpy(w[k])), k
    assert STAGED["staged"] == 3 * 6 and STAGED["pageable"] == 0
    assert STAGED["slot_waits"] >= 1, dict(STAGED)


def nefnet_batches(cfg, n):
    return [b for b, _ in zip(BeatLoader(build_dataset(cfg, "train"), cfg.DATA.batch_size, shuffle=True,
                                         drop_last=True, seed=1), range(n))]


def resnet_batches(n, B=4, T=1000, C=5):
    rng = np.random.default_rng(7)
    return [{"data": rng.standard_normal((B, 8, T)).astype(np.float32),
             "label": (rng.random((B, C)) < 0.3).astype(np.int64)} for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["nefnet_fused_f32", "nefnet2_graphed", "resnet1d34_narrow"])
def test_cuda_train_step_inputs_never_drain_the_card(model, tmp_path, monkeypatch):
    dev = card()
    if model == "resnet1d34_narrow":
        build = solver_module.build_model
        monkeypatch.setattr(solver_module, "build_model", lambda cfg: ResNet1dDef(
            cfg.MODEL.arch, cfg.DATA.in_channel, cfg.MODEL.num_classes, cfg.DATA.lead_num, init_channels=8)
            if cfg.MODEL.model == "model_resnet1d" else build(cfg))
        cfg, batches = resnet_cfg(tmp_path), resnet_batches(4)
    elif model == "nefnet_fused_f32":
        cfg = nefnet_cfg(tmp_path, "model_nefnet", 8, compute_dtype="float32", train_encoder="fused",
                         train_decoder="fused")
        batches = nefnet_batches(cfg, 4)
    else:
        cfg = nefnet_cfg(tmp_path, "model_nefnet2", 8, compute_dtype="float32", train_encoder="xla",
                         train_decoder="fused")
        batches = nefnet_batches(cfg, 4)
    solver = Solver(cfg, use_writer=False, device=dev)
    params, bn_state, opt = solver.init_state()

    def step(k):
        return solver.train_step(params, bn_state, opt, epoch=0, step=k, i1=1, i2=2,
                                 batch=batches[k % len(batches)])

    for k in range(3):  # kernels built, cuDNN's plans chosen, Nef-Net2's graphs captured and replayed
        bn_state, _ = step(k)
    torch.cuda.synchronize()
    waits = STAGED["slot_waits"]
    torch.cuda._sleep(SLEEP_CYCLES)
    busy = torch.cuda.Event()
    busy.record()
    bn_state, lvec = step(3)
    drained = busy.query()
    torch.cuda.synchronize()
    assert not drained, f"{model}: the step waited for the card before it returned"
    assert STAGED["slot_waits"] == waits
    assert bool(torch.isfinite(lvec).all())
