"""Nef-Net2's train encode replayed from CUDA graphs
(`NefNet2Def.graphed_encode`, `ops.GraphedTrain`).

On the CPU (tier-1): the hook is encode_latents2 bit for bit, captures
nothing, and a Solver step through it is the step without it, bit for bit.

On the card (`cuda`), at the benchmark's B=32, L=3, in float32 with TF32
off and in bfloat16 over float32 masters (the Solver's casts):
  * the first call is the eager warm-up; the replayed z1, z2 of the next
    ones equal the eager encode's bit for bit: the same cuDNN plans and
    kernels on the same inputs;
  * the gradients stay within twice the spread of three eager backward runs
    from the same state (the largest of the second and third runs' distance
    from the first, the root of the summed squared relative distances over
    the parameters): cuDNN's weight gradients do not repeat bitwise (PERF.md
    section 6); where the eager runs repeat bitwise, so must the replay;
  * a second batch with new masks matches eager on that batch, so stale
    static buffers fail; a batch of another shape runs eagerly
    (`eager.new_shape`) and replays nothing, and so does every call of an
    encode built for a device mesh (`eager.mesh`);
  * GRAPHED counts one warm-up, one capture and the replays.
"""

import contextlib

import numpy as np
import pytest
import torch

from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.models import NefNet2Def, encode_latents2
from electrocardio_panorama_tpu_torch.ops import GRAPHED, full_f32
from electrocardio_panorama_tpu_torch.training import solver as S
from electrocardio_panorama_tpu_torch.training.optim import get_optimizer

L = 3


def make_batch(seed, B, device, dtype):
    """x [B, L, 512], thetas [B, L, 2], rois [B, 7, 2] (a contiguous
    partition of [0, 512], as the dataset gives) on `device`."""
    rng = np.random.default_rng(seed)
    rois = []
    for _ in range(B):
        pts = np.concatenate([[0], np.sort(rng.choice(np.arange(8, 504, 4), size=6, replace=False)), [512]])
        rois.append(np.stack([pts[:-1], pts[1:]], 1))
    x = torch.from_numpy(rng.uniform(0, 1, (B, L, 512)).astype(np.float32))
    th = torch.from_numpy(rng.uniform(-np.pi, np.pi, (B, L, 2)).astype(np.float32))
    return (x.to(device, dtype), th.to(device, dtype), torch.from_numpy(np.stack(rois)).to(device))


def run(encode, leaves, batch, masks, dz, dtype):
    """(z1, z2, leaf gradients) of one train encode and its backward from
    `dz`, copied out of any graph buffer, the casts as the Solver makes them."""
    for v in leaves.values():
        v.grad = None
    p = leaves if dtype == torch.float32 else {k: v.to(dtype) for k, v in leaves.items()}
    with full_f32() if dtype == torch.float32 else contextlib.nullcontext():
        z1, z2 = encode(p, *batch, masks=masks, train=True)
        torch.autograd.backward([z1, z2], list(dz))
    return z1.detach().clone(), z2.detach().clone(), {k: v.grad.clone() for k, v in leaves.items()
                                                      if v.grad is not None}


def grad_distance(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return sum(float((a[k].double() - b[k].double()).norm() / b[k].double().norm()) ** 2 for k in b) ** 0.5


# ------------------------------------------------------------------- CPU
def test_cpu_graphed_encode_is_the_eager_encode_bitwise():
    d = NefNet2Def(L)
    leaves, _ = d.init(torch.Generator().manual_seed(7))
    leaves = {k: v.requires_grad_(True) for k, v in leaves.items()}
    batch = make_batch(1, 2, "cpu", torch.float32)
    masks = d.draw_masks(torch.Generator().manual_seed(2), 2)
    dz = [torch.randn(2, L, 128, 128, generator=torch.Generator().manual_seed(s)) for s in (3, 4)]
    GRAPHED.clear()
    got = run(d.graphed_encode(mesh=False), leaves, batch, masks, dz, torch.float32)
    want = run(lambda *a, **k: encode_latents2(*a, lead_num=L, **k), leaves, batch, masks, dz, torch.float32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(got[2]) == set(want[2]) and all(torch.equal(got[2][k], want[2][k]) for k in want[2])
    assert not GRAPHED


def test_cpu_solver_step_through_the_hook_is_the_step_without_it(tmp_path, monkeypatch):
    """A Solver step on Nef-Net2 (the cell's knobs: eager encoder, the fused
    decoder pair's plain version, dropout on) through the graphed-encode hook
    and with the hook taken out: the same loss vector, parameters and BN
    state, bit for bit."""
    cfg = get_cfg()
    cfg.desc, cfg.output_dir = "n2", str(tmp_path / "out")
    cfg.DATA.dataset, cfg.DATA.synthetic_root = "synthetic", str(tmp_path / "synth")
    cfg.DATA.lead_num, cfg.DATA.super_mode, cfg.DATA.train_data_mode = L, "IIv2v5_v4I_372", "input_fix"
    cfg.MODEL.model, cfg.MODEL.jitter_factor = "model_nefnet2", 2.5
    cfg.SOLVER.lr, cfg.SOLVER.loss_factor = 0.05, [0.5, 0.5, 1]
    cfg.TPU.train_decoder = "fused"
    batch = next(iter(BeatLoader(build_dataset(cfg, "train"), 2, shuffle=True, drop_last=True, seed=1)))
    solver = S.Solver(cfg, use_writer=False, device="cpu")
    assert solver.train_encoder == "xla" and solver._train_enc_fn is not None
    p0, s0 = solver.model.init(torch.Generator().manual_seed(6))

    def step():
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        s, lvec = solver.train_step(p, {k: v.clone() for k, v in s0.items()}, get_optimizer(cfg, p), epoch=0,
                                    step=0, i1=1, i2=2, batch=batch)
        return lvec, {k: v.detach() for k, v in p.items()}, s

    GRAPHED.clear()
    hooked = step()
    monkeypatch.setattr(solver, "_train_enc_fn", None)
    plain = step()
    assert not GRAPHED
    assert torch.equal(hooked[0], plain[0])
    for ours, want in zip(hooked[1:], plain[1:]):
        assert set(ours) == set(want) and all(torch.equal(ours[k], want[k]) for k in want)


# ------------------------------------------------------------------ card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_graphed_encode_replays_the_eager_encode(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs exist only on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    d = NefNet2Def(L)
    leaves, _ = d.init(torch.Generator().manual_seed(7), device=dev)
    leaves = {k: v.requires_grad_(True) for k, v in leaves.items()}
    eager = lambda *a, **k: encode_latents2(*a, lead_num=L, **k)  # noqa: E731
    graphed = d.graphed_encode(mesh=False)

    def inputs(seed, B):
        g = torch.Generator(device=dev).manual_seed(seed)
        dz = [torch.randn(B, L, 128, 128, device=dev, generator=g).to(dtype) for _ in range(2)]
        return make_batch(seed, B, dev, dtype), d.draw_masks(g, B, dtype=dtype), dz

    GRAPHED.clear()
    for seed in (1, 2, 3):  # the eager warm-up, the capture's batch, then a new batch and new masks
        batch, masks, dz = inputs(seed, 32)
        got = run(graphed, leaves, batch, masks, dz, dtype)
        e1, e2, e3 = (run(eager, leaves, batch, masks, dz, dtype) for _ in range(3))
        assert torch.equal(got[0], e1[0]) and torch.equal(got[1], e1[1]), seed
        spread = max(grad_distance(e2[2], e1[2]), grad_distance(e3[2], e1[2]))
        gap = grad_distance(got[2], e1[2])
        assert gap <= 2 * spread, (seed, gap, spread)
    assert dict(GRAPHED) == {"warmups": 1, "captures": 1, "replays_fwd": 2, "replays_bwd": 2}, dict(GRAPHED)

    batch, masks, dz = inputs(4, 16)  # another batch shape: eager, the graph untouched
    want = run(eager, leaves, batch, masks, dz, dtype)
    for encode in (graphed, d.graphed_encode(mesh=True)):  # under a mesh: eager, never captured
        got = run(encode, leaves, batch, masks, dz, dtype)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dict(GRAPHED) == {"warmups": 1, "captures": 1, "replays_fwd": 2, "replays_bwd": 2,
                             "eager.new_shape": 1, "eager.mesh": 1}
