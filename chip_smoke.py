"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero before the
result line:
  1. device  — a CUDA device is present; its name and power limit;
  2. build   — compile every CUDA kernel of the port from csrc/, all at once;
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main paths' widths (Nef-Net, 3 leads, theta_L=1, B=32):
               A1 and the gate-input and y1 decode forms (A5/A7, A6) at V=336
               and V=11; A2/A3 (the fused encoder) for z1, the z2 grid,
               latent_all and every parameter gradient, bitwise across
               encoder_ckpt off/tower/full and a repeat launch; A4f/A4b (the
               fused train decoder) at 3 groups of 32 for the output, the
               batch moments, dx and all 18 parameter gradients, bitwise
               across a repeat launch, bfloat16 A4f's moments within the
               float64-anchored bar on 16 input sets, float32 A4f's and
               A4b's device ms by kernel, their FMA engine's TFLOP/s and
               resources, bfloat16 A4f's device ms by kernel, its
               tensor-core forward convs' TFLOP/s and resources, and both
               float32 sides' out, moments and gradient distance from a
               float64 pass; float32 and bfloat16, timed with CUDA events;
  4. render  — the port's render entry point (`render.main`) on a generated
               synthetic corpus with a seeded random checkpoint, over the
               84-view grid, in float32 and bfloat16, through A2 (eval
               form) and A1; launch counts read around that run; held
               against the same run with the plain encode and decode;
               then `fused_decode_views(gates=)` and
               `(enc=, head='y1')` on the same checkpoint and the first
               batch's latents, held against the rendered views;
  5. train   — the port's trainer (`main.main`) on a generated synthetic
               corpus at batch 32: a few steps and one eval epoch (A1), in
               float32 with TPU.train_encoder fused and in bfloat16 with
               auto (A2/A3), in float32 with TPU.train_decoder fused and the
               eager encoder, and in bfloat16 with both fused (A4f/A4b);
               launch counts read around each run; each held against the
               same run without the kernels under test (same batches, same
               masks): per-step losses, and the params after one step;
  6. nefnet2_synth — the trainer on Nef-Net2 (MODEL.model model_nefnet2,
               the shared single-lead tower) at batch 32, float32, eager
               encoder, TPU.train_decoder fused: A4f/A4b once a step, A1 in
               the eval epoch, held against the same run with the eager
               decoders (losses, params after one step, eval rest views),
               its step time and device busy ms; then the synthesis entry
               point `synth_cli` (export-latents, fit-prior, generate 8 x 24
               views) on the card from a seeded random Nef-Net checkpoint,
               held against the same commands under --device cpu;
  7. parallel_annotate — data parallelism and the annotate entry point:
               `main.main` under TPU.mesh_shape [1] (an NCCL group of one) at
               batch 32 with both fused pairs, float32 and bfloat16, bitwise
               against the same run without a mesh (params after the steps,
               losses, eval metrics) with the same A2/A3/A4f/A4b launches,
               and each step's time and MFU (utils/flops.py); the
               view-sharded panorama on a (1, 1) mesh through A1, bitwise
               against `PanoramaGenerator.render` on 32 beats x 84 views;
               the annotate CLI's segment / validate / show on records of
               the synthetic corpus, and a dataset built from them;
  8. lead_parallel — lead tensor parallelism on a (1, 1, 1) (data, lead,
               view) mesh (an NCCL group of one) at batch 32: 4 steps of
               `build_3d_train_step` in float32 and bfloat16 against the
               single-process eager step on the same batches (dropout off),
               whether each is bitwise, both steps' ms; the lead-parallel
               panorama against encode + decode_views on 32 beats x 84
               views; no kernel launches (the lead path is eager);
  9. summary — one JSON line naming every kernel with its numbers and its
               launches on the Nef-Net2 run (`launches_nefnet2`), under
               the mesh (`launches_parallel`) and on the lead path
               (`launches_lead`).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

F32_TOL, BF16_TOL, BF16_CORR = 2e-5, 1e-4, 0.999
# two bfloat16 decode forms against each other: each carries its own rounding
# (BF16_CORR against float32 each), so twice the distance from 1
BF16_PAIR_CORR = 0.998
B, V_MAIN, V_PAD, VIEW_TILE = 32, 336, 11, 16
A1_REPLACES = "electrocardio_panorama_tpu/ops/pallas/decoder_fused.py:673"
A1_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/decoder_basis.cu"
A2_REPLACES = "electrocardio_panorama_tpu/ops/pallas/encoder_fused.py:438"
A2_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/encoder_fwd.cu"
A3_REPLACES = "electrocardio_panorama_tpu/ops/pallas/encoder_fused.py:500"
A3_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/encoder_bwd.cu"
JAX_DECODER = "electrocardio_panorama_tpu/ops/pallas/decoder_fused.py"
FORMS_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/decoder_forms.cu"
# the float32 gate kernel stands for both JAX gate kernels (polyphase, layout A)
FORMS_REPLACES = {"decoder_gates_f32": f"{JAX_DECODER}:714 and {JAX_DECODER}:308",
                  "decoder_gates_bf16": f"{JAX_DECODER}:714",
                  "decoder_y1_f32": f"{JAX_DECODER}:659", "decoder_y1_bf16": f"{JAX_DECODER}:659"}
A4F_REPLACES = "electrocardio_panorama_tpu/ops/pallas/decoder_train.py:250"
A4F_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/decoder_train_fwd.cu"
A4B_REPLACES = "electrocardio_panorama_tpu/ops/pallas/decoder_train.py:267"
A4B_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/decoder_train_bwd.cu"
KERNELS = ["decoder_basis", "decoder_forms", "encoder_fwd", "encoder_bwd", "decoder_train_fwd",
           "decoder_train_bwd"]
LEADS = 3
# A2/A3 against the plain version. float32: forward max abs error 2e-5;
# gradients by the bulk (99.5% of elements within 2e-4 of the largest) plus
# energy (L2 relative 5e-4) criterion of tests/test_pallas_encoder.py.
# bfloat16: both round at the same points, and summation order moves a value
# by one bf16 ulp (2^-8 relative) now and then, which later stages carry:
# forward max abs error 2^-5 of the largest |value| and corr > 0.9999,
# gradients corr > 0.995 and L2 relative 5e-2 (tests/test_torch_encoder_fused.py).
ENC_BF16_FWD_REL, ENC_BF16_FWD_CORR, ENC_BF16_GRAD_CORR, ENC_BF16_GRAD_L2 = 2.0 ** -5, 0.9999, 0.995, 5e-2
# A2 -> A3 end to end in float32: each side takes the relu masks of its own
# forward, and a pre-activation within rounding of 0 may fall either way (one
# flip moves a tower weight gradient by about 1.4e-3 of its L2 norm at B=32),
# so every gradient is held at L2 relative 5e-3 and corr > 0.9999, as A4b's
# are; the tight float32 bars hold A3 on the plain version's forward planes.
ENC_F32_E2E_L2, ENC_F32_E2E_CORR = 5e-3, 0.9999
# A4f/A4b against the plain version at 3 groups of 32. float32 forward: max
# abs error 2e-5 on the output, the moments within 1e-5 (relative and
# absolute). Gradients: a relu mask whose pre-activation sits within rounding
# of 0 may fall either way, and one flipped element moves a whole term of a
# per-channel sum (about 6e-4 of a gradient's L2 norm at these shapes), so with
# the model's BN offsets the bar is L2 relative 5e-3 and corr > 0.9999; with
# the offsets raised so that no relu clips, summation order alone is left and
# the bar is L2 relative 2e-4. The conv biases before a BN get a gradient of
# rounding noise on both sides (the batch mean cancels them): |g| <= 1e-3.
# bfloat16: output max abs error 2e-3 and corr > 0.9999, moments within 1e-3,
# gradients at the encoder's bfloat16 bars; and on the 16 input sets of
# ops/kernels/decoder_train.py BF16_MOMENTS_BAR the kernel's and the plain
# version's moments each within that bar of the float64 pass (allclose form,
# `moments_distance`), the kernel within DEC_BF16_STAT of the plain version.
DEC_F32_GRAD_L2, DEC_F32_GRAD_CORR, DEC_F32_OPEN_L2, DEC_NOISE = 5e-3, 0.9999, 2e-4, 1e-3
DEC_NOISE_KEYS = ("b1", "b2", "b3", "b4")
DEC_BF16_FWD, DEC_BF16_FWD_CORR, DEC_BF16_STAT = 2e-3, 0.9999, 1e-3
# train phase, a run with kernels against the run without them on the same
# batches and masks: per-step loss relative difference; the params after one
# step, as the L2 distance between the two updates over the L2 size of the
# update
TRAIN_STEPS, TRAIN_N_TEST = 4, 96
TRAIN_LOSS_REL = {"float32": 1e-4, "bfloat16": 5e-2}
TRAIN_UPDATE_REL = {"float32": 1e-3, "bfloat16": 1e-1}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# multiply-adds per view (or train sample) of the decoder's convs: conv1 on the
# upsampled gated latent, and conv2..conv5 (the tail every eval form shares)
CONV1_MACS = 128 * 256 * 3 * 256
TAIL_MACS = 128 * 128 * 3 * 256 + 64 * 128 * 3 * 512 + 64 * 64 * 3 * 512 + 64 * 3 * 512


def bound_ms(flops: float, n_bytes: float, dtype) -> tuple[float, str]:
    """Least time for this work: bytes (each input read once, each output
    written once) over the HBM rate vs operations over the peak of the
    storage type (the H100 peaks of utils/flops.py)."""
    from electrocardio_panorama_tpu_torch.utils.flops import H100_BF16_FLOPS, H100_BYTES_PER_S, H100_F32_FLOPS

    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, n_bytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def a1_bound_ms(U, ep, folded, n_views: int) -> tuple[float, str]:
    """Least time for the A1 function on these inputs."""
    J = ep.shape[-1]
    flops = 2 * (J * 128 * 256 + TAIL_MACS) * n_views
    n_bytes = (nbytes(U, ep) + nbytes(*(t for k, t in folded.items() if k not in ("w1", "A")))
               + n_views * 512 * 4)
    return bound_ms(flops, n_bytes, U.dtype)


def encoder_convs(L: int) -> list[tuple[int, int, int, int]]:
    """(output channels, input channels per output, taps, output steps) of
    every convolution in the A2 chain, per sample."""
    C, Cz, Ch = 128 * L, 896 * L, 448 * L
    zblock = [(C, 64, 3, 128), (C, 128, 3, 128), (C, 64, 1, 128)]
    return ([(C, 1, 15, 256)] + [(C, 128, 7, 128)] * 6 + [(C, 128, 3, 128)] * 2 + zblock * 2
            + [(Cz, 128, 3, 16)] * 2 + [(Ch, 128, 1, 32)]
            + [(Cz, 64, 3, 32), (Cz, 128, 3, 32), (Cz, 64, 1, 32)])


def encoder_engine_share(L: int) -> float:
    """Share of one tower-mode A3 launch's products that run on the engine
    of its storage type (the bf16 tensor-core engine, the f32 FMA engine):
    all but conv1's (its recompute and weight gradient; x takes no
    gradient)."""
    convs = encoder_convs(L)
    macs = [co * ci * k * t for co, ci, k, t in convs]
    tower = sum(macs[1:7])
    total = (sum(macs) - tower) + 2 * sum(macs) - macs[0]  # recompute after the tower; data + weight grads
    return 1.0 - 2 * macs[0] / total


def encoder_bound_ms(nbytes: int, dtype, batch: int, backward: bool) -> tuple[float, str]:
    """Least time for A2 (or A3: every data gradient but the input's, and
    every weight gradient) at these shapes: bytes over HBM rate vs
    operations over the storage type's peak."""
    convs = encoder_convs(LEADS)
    fwd = 2 * batch * sum(co * ci * k * t for co, ci, k, t in convs)
    co, ci, k, t = convs[0]
    flops = 2 * fwd - 2 * batch * co * ci * k * t if backward else fwd
    return bound_ms(flops, nbytes, dtype)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def grad_errors(a, b):
    """(share of elements off by more than 2e-4 of max|b|, L2 relative, corr)."""
    a, b = a.double().flatten(), b.double().flatten()
    bulk = float(((a - b).abs() / max(float(b.abs().max()), 1e-3) > 2e-4).double().mean())
    l2 = float((a - b).norm() / max(float(b.norm()), 1e-12))
    # one number, or all zeros, has no correlation: its L2 error is what is held
    corr = float(np.corrcoef(a.cpu().numpy(), b.cpu().numpy())[0, 1]) if b.numel() > 1 and b.abs().max() > 0 else 1.0
    return bulk, l2, corr


def encoder_float64_distances(card, a2, w, x, gate, ramp, masks, dz1, dz2, rois, plain_out, plain_grads,
                              kernel_run) -> None:
    """Print how far the float32 kernels and the float32 plain version each
    lie from a float64 pass of the plain version on the same inputs: the
    forward's largest absolute difference (z1, the z2 grid, latent_all) and
    the gradients' worst L2 relative distance and bulk share (elements off by
    more than 2e-4 of the largest)."""
    from electrocardio_panorama_tpu_torch.models.nefnet import latents_from_grid

    L = LEADS
    ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    g = gate.clone().requires_grad_(True)
    z1, z2g = a2.encoder_plain(ws, x, g, ramp, masks, lead_num=L, float64=True)
    torch.autograd.backward([z1, z2g], [dz1.double(), dz2.double()])
    z1, z2g = z1.detach(), z2g.detach()
    lat = latents_from_grid(z1, z2g.reshape(B, 128 * L, 7, 32), rois.double(), lead_num=L)
    truth = {"z1": z1, "z2g": z2g, "latent_all": lat.latent_all}
    truth_grads = {"gate": g.grad, **{k: v.grad for k, v in ws.items()}}
    kernel_out, kernel_grads = kernel_run
    parts = []
    for name, out, grads in (("kernel", kernel_out, kernel_grads), ("plain f32", plain_out, plain_grads)):
        fwd = max(float((out[k].double() - truth[k]).abs().max()) for k in truth)
        worst = max((grad_errors(grads[k].double(), truth_grads[k].double()) + (k,) for k in truth_grads),
                    key=lambda e: e[1])
        parts.append(f"{name}: forward max abs {fwd:.3e}, worst grad {worst[3]} L2 {worst[1]:.3e} "
                     f"bulk {worst[0]:.2e}")
    log("kernels", "encoder f32 distance from a float64 plain pass (B=32, L=3, tower mode): "
                   + "; ".join(parts) + f" on {card}")


def encoder_kernels(card: str, dev) -> dict:
    """A2/A3 against the plain version at B=32, L=3 in float32 and bfloat16:
    z1, the z2 grid and latent_all; every parameter gradient under a fixed
    cotangent; bitwise-equal gradients across encoder_ckpt off/tower/full and
    across two launches on the same inputs. In float32 both the kernels and
    the plain version are also measured against a float64 pass of the plain
    version (printed, not held to a bar). Returns {"encoder_fwd_f32": {...},
    ...} with max_abs_err, ms, plain_ms, bound_ms, bound_by."""
    from electrocardio_panorama_tpu_torch.models import init_nefnet
    from electrocardio_panorama_tpu_torch.models.nefnet import latents_from_grid
    from electrocardio_panorama_tpu_torch.ops import angular_encode, full_f32, linear, roi_align_ramp
    from electrocardio_panorama_tpu_torch.ops.kernels import build
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2
    from electrocardio_panorama_tpu_torch.utils.profiling import device_window

    L = LEADS
    rng = np.random.default_rng(1)
    params, _ = init_nefnet(torch.Generator().manual_seed(1), lead_num=L, device=dev)
    pts = np.concatenate([[0], np.sort(rng.choice(np.arange(8, 504, 4), 6, replace=False)), [512]])
    rois = torch.tensor(np.broadcast_to(np.stack([pts[:-1], pts[1:]], 1), (B, 7, 2)).copy(),
                        dtype=torch.float32, device=dev)
    x32 = torch.tensor(rng.normal(0, 0.6, (B, L, 512)), dtype=torch.float32, device=dev)
    thetas = torch.tensor(rng.uniform(-np.pi, np.pi, (B, L, 2)), dtype=torch.float32, device=dev)
    with full_f32():
        gate32 = linear(angular_encode(thetas), params["mlp1.weight"], params["mlp1.bias"])
    ramp32 = roi_align_ramp(rois)
    masks32 = a2.draw_masks(torch.Generator(device=dev).manual_seed(2), B, L)
    dz1_32 = torch.tensor(rng.normal(0, 1, (B, 128 * L, 128)), dtype=torch.float32, device=dev)
    dz2_32 = torch.tensor(rng.normal(0, 1, (B, 896 * L, 32)), dtype=torch.float32, device=dev)
    stats = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        w = {k: params[k].to(dt) for k in a2.WEIGHT_KEYS.values()}
        x, gate, ramp = x32.to(dt), gate32.to(dt), ramp32.to(dt)
        masks = tuple(m.to(dt) for m in masks32)
        dz1, dz2 = dz1_32.to(dt), dz2_32.to(dt)

        plain_planes = {}

        def run(plain, ckpt="tower"):
            ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
            g = gate.clone().requires_grad_(True)
            with full_f32():
                if plain:
                    z1, z2g = a2.encoder_plain(ws, x, g, ramp, masks, lead_num=L, planes=plain_planes)
                else:
                    z1, z2g = a2.encode_fused(ws, x, g, ramp, masks, lead_num=L, ckpt=ckpt)
                torch.autograd.backward([z1, z2g], [dz1, dz2])
            grads = {"gate": g.grad, **{k: v.grad for k, v in ws.items()}}
            z1, z2g = z1.detach().float(), z2g.detach().float()
            lat = latents_from_grid(z1, z2g.reshape(B, 128 * L, 7, 32), rois, lead_num=L)
            return {"z1": z1, "z2g": z2g, "latent_all": lat.latent_all}, grads

        ref_out, ref_grads = run(True)
        outs, grads = {}, {}
        for ckpt in ("off", "tower", "full", "tower"):
            key = ckpt if ckpt not in outs else "repeat"
            outs[key], grads[key] = run(False, ckpt)
        torch.cuda.synchronize()
        fwd_err = max(float((outs["tower"][k] - ref_out[k]).abs().max()) for k in ref_out)
        bitwise = all(torch.equal(grads[m][k], grads["tower"][k])
                      for m in ("off", "full", "repeat") for k in ref_grads)
        same_fwd = all(torch.equal(outs[m][k], outs["tower"][k]) for m in outs for k in ref_out)
        held = grads["tower"]
        ok = bitwise and same_fwd
        if dt == torch.float32:
            # the tight float32 bars hold A3 on the plain version's forward
            # planes (the same relu masks on both sides); end to end the bars
            # are those of ENC_F32_E2E_L2 / ENC_F32_E2E_CORR
            kept = {n: v.detach() for n, v in plain_planes.items()}
            held = dict(zip(ref_grads, a2.backward_cuda(w, x, gate, ramp, masks, kept, dz1, dz2, lead_num=L,
                                                        mode="full")))
            e2e = [grad_errors(grads["tower"][k].float(), ref.float()) + (k,) for k, ref in ref_grads.items()]
            ok = ok and all(l2 <= ENC_F32_E2E_L2 and c > ENC_F32_E2E_CORR for _, l2, c, _ in e2e)
            e2e = max(e2e, key=lambda e: e[1])
            log("kernels", f"encoder f32 end to end (A2 -> A3, tower mode) vs plain: worst grad {e2e[3]} L2 "
                           f"{e2e[1]:.3e} (bar {ENC_F32_E2E_L2}) corr {e2e[2]:.7f} (bar {ENC_F32_E2E_CORR}) "
                           f"bulk {e2e[0]:.2e} (each side on its own relu masks)")
            encoder_float64_distances(card, a2, w, x, gate, ramp, masks, dz1, dz2, rois, ref_out, ref_grads,
                                      (outs["tower"], grads["tower"]))
        bwd_err, worst = 0.0, (0.0, 0.0, 1.0, "")
        for k, ref in ref_grads.items():
            got = held[k]
            bwd_err = max(bwd_err, float((got.float() - ref.float()).abs().max()))
            bulk, l2, corr = grad_errors(got.float(), ref.float())
            if l2 >= worst[1]:
                worst = (bulk, l2, corr, k)
            if dt == torch.float32:
                ok = ok and bulk <= 5e-3 and l2 <= 5e-4
            else:
                ok = ok and corr > ENC_BF16_GRAD_CORR and l2 <= ENC_BF16_GRAD_L2
        if dt == torch.float32:
            ok = ok and fwd_err <= F32_TOL
        else:
            top = max(float(ref_out[k].abs().max()) for k in ref_out)
            corr = min(compare(outs["tower"][k], ref_out[k])[1] for k in ref_out)
            ok = ok and fwd_err <= ENC_BF16_FWD_REL * top and corr > ENC_BF16_FWD_CORR
        ok = ok and all(bool(torch.isfinite(v).all()) for v in outs["tower"].values())
        on = "A3 on the plain forward planes, " if dt == torch.float32 else ""
        line = (f"encoder {name} B={B} L={L}: forward max|kernel - plain| {fwd_err:.3e}; {on}worst grad "
                f"{worst[3]}: bulk {worst[0]:.2e} L2 {worst[1]:.2e} corr {worst[2]:.6f}; max|dgrad| "
                f"{bwd_err:.3e}; bitwise across ckpt off/tower/full and a repeat: {bitwise and same_fwd}")
        if not ok:
            log("kernels", "FAIL " + line)
            raise SystemExit(1)

        # timing: one launch each, the plain version on the same inputs
        kept_all = a2.forward_cuda(w, x, gate, ramp, masks, lead_num=L)
        kept = {n: kept_all[n] for n in a2._KEEP["tower"]}
        fwd_ms = cuda_ms(lambda: a2.forward_cuda(w, x, gate, ramp, masks, lead_num=L), reps=10)
        bwd_ms = cuda_ms(lambda: a2.backward_cuda(w, x, gate, ramp, masks, kept, dz1, dz2, lead_num=L,
                                                  mode="tower"), reps=10)
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        g = gate.clone().requires_grad_(True)
        with full_f32(), torch.no_grad():
            plain_fwd_ms = cuda_ms(lambda: a2.encoder_plain(w, x, gate, ramp, masks, lead_num=L), reps=3)
        with full_f32():
            z1p, z2p = a2.encoder_plain(ws, x, g, ramp, masks, lead_num=L)
            plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                [z1p, z2p], [g, *ws.values()], [dz1, dz2], retain_graph=True, allow_unused=True), reps=3)
        wbytes = nbytes(*w.values())
        in_bytes = nbytes(x, gate, ramp, *masks) + wbytes
        fb, fby = encoder_bound_ms(in_bytes + nbytes(outs["tower"]["z1"].to(dt), outs["tower"]["z2g"].to(dt)),
                                   dt, B, backward=False)
        grad_bytes = wbytes * 4 // dt.itemsize + nbytes(gate.float())  # float32 gradients
        bb, bby = encoder_bound_ms(in_bytes + nbytes(*kept.values(), dz1, dz2) + grad_bytes, dt, B,
                                   backward=True)
        a2.backward_section_ms(w, x, gate, ramp, masks, kept, dz1, dz2, lead_num=L, mode="tower")  # warm-up
        sections = a2.backward_section_ms(w, x, gate, ramp, masks, kept, dz1, dz2, lead_num=L, mode="tower")
        log("kernels", f"A3 {name} sections (one launch, tower mode, CUDA events): "
                       + ", ".join(f"{k} {v:.3f} ms" for k, v in sections.items())
                       + f"; sum {sum(sections.values()):.3f} ms on {card}")
        split = device_window(lambda: [a2.backward_cuda(w, x, gate, ramp, masks, kept, dz1, dz2, lead_num=L,
                                                        mode="tower") for _ in range(5)], 5, top=8)
        log("kernels", f"A3 {name} device ms per launch by kernel (torch.profiler): "
                       + "; ".join(f"{k} {v:.3f}" for k, v in split["by_kernel"].items())
                       + f"; all kernels {split['kernel_sum_ms']:.3f} on {card}")
        if dt == torch.float32:
            lib = build.load("encoder_bwd")
            lib.encoder_fma_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.encoder_fma_dw_smem_bytes.argtypes = [ctypes.c_int]
            smem = {f"k{k} s{s} T{t}": lib.encoder_fma_smem_bytes(k, s, t)
                    for k, s, t in ((7, 1, 128), (3, 1, 128), (1, 1, 16), (2, 2, 16), (3, 1, 16), (3, 1, 32))}
            dw_smem = {f"k{k}": lib.encoder_fma_dw_smem_bytes(k) for k in (7, 3, 1)}
            log("kernels", f"FMA engine (encoder_fma.cuh): {encoder_engine_share(L):.4f} of a tower-mode A3 "
                           f"launch's products (all but conv1's); dynamic shared memory per block, "
                           f"conv_kernel_fma: " + ", ".join(f"{k} {v} bytes" for k, v in smem.items())
                           + "; dw_kernel_fma: " + ", ".join(f"{k} {v} bytes" for k, v in dw_smem.items()))
        if dt == torch.bfloat16:
            lib = build.load("encoder_bwd")
            lib.encoder_tc_smem_bytes.argtypes = [ctypes.c_int] * 4
            lib.encoder_tc_dw_smem_bytes.argtypes = [ctypes.c_int] * 2
            smem = {f"cig {ci} k{k} s{s} T{t}": lib.encoder_tc_smem_bytes(ci, k, s, t)
                    for ci, k, s, t in ((128, 7, 1, 128), (128, 3, 1, 128), (64, 3, 1, 128), (128, 3, 1, 16),
                                        (64, 2, 2, 16), (128, 3, 1, 32))}
            dw_smem = {f"k{k} T{t}": lib.encoder_tc_dw_smem_bytes(k, t)
                       for k, t in ((7, 128), (3, 128), (1, 128), (3, 32), (1, 16), (3, 16))}
            log("kernels", f"tensor-core engine (encoder_tc.cuh): {encoder_engine_share(L):.4f} of a tower-mode A3 "
                           f"launch's products "
                           f"(all but conv1's); dynamic shared memory per block, conv_kernel_tc: "
                           + ", ".join(f"{k} {v} bytes" for k, v in smem.items())
                           + "; dw_kernel_tc: " + ", ".join(f"{k} {v} bytes" for k, v in dw_smem.items()))
        stats[f"encoder_fwd_{name}"] = dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=plain_fwd_ms,
                                            bound_ms=fb, bound_by=fby)
        stats[f"encoder_bwd_{name}"] = dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=plain_bwd_ms,
                                            bound_ms=bb, bound_by=bby)
        engine = "FMA engine encoder_fma.cuh" if dt == torch.float32 else "tensor-core engine encoder_tc.cuh"
        log("kernels", f"ok {line} | every conv and weight gradient but conv1's on the {engine} | "
                       f"A2 {fwd_ms:.3f} ms/launch (plain {plain_fwd_ms:.3f} ms, bound {fb:.4f} ms "
                       f"{fby}), A3 {bwd_ms:.3f} ms/launch (plain {plain_bwd_ms:.3f} ms, bound {bb:.4f} ms "
                       f"{bby}) on {card}")
    return stats


def engine_kernel_resources(report: str) -> list[str]:
    """One line per kernel of the encoder's engines (tensor-core and FMA) in a
    `ptxas -v` report: its name (demangled where c++filt is found),
    registers, spills and static shared memory."""
    lines, kernel, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1) if re.search(r"kernel_(tc|fma)", m.group(1)) else None
            if kernel:
                try:
                    kernel = subprocess.run(["c++filt", kernel], capture_output=True, text=True,
                                            timeout=10).stdout.strip() or kernel
                except OSError:
                    pass
        elif kernel and "spill stores" in line:
            spills = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            lines.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}")
            kernel = None
    return lines


def stage_kernel_resources(report: str) -> list[str]:
    """One line per eval-decoder stage kernel in a `ptxas -v` report: its
    template arguments, registers and spills."""
    lines, kernel, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_ZN3dec\d(tc|fma)12stage_kernelI((?:L[ib]\d+E)+)E", line)
        if "Compiling entry function" in line:
            kernel = None
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2))
            names = ("CIN", "NOUT", "T", "TAPS", "IN", "OUT", "RELU", "NWG")
            kernel = f"{m.group(1)} stage_kernel<{', '.join(f'{k}={v}' for k, v in zip(names, args))}>"
        elif kernel and "spill stores" in line:
            spills = line.strip()
        elif kernel and (used := re.search(r"Used (\d+) registers", line)):
            lines.append(f"{kernel}: {used.group(1)} registers; {spills}")
    return lines


# the convolution that one F.conv1d call runs as a stage's yardstick:
# (input channels, output channels, steps); the stage does the same products
# (the gate stage half of them: it takes them before the upsample)
STAGE_CONV = {"gate+conv1": (256, 128, 256), "mix+conv2": (128, 128, 256), "up+conv2": (128, 128, 256),
              "conv2": (128, 128, 256), "conv3": (128, 64, 512), "conv4+conv5": (64, 64, 512)}


def decoder_stages(card: str, dev, params, latent, folded, rng) -> None:
    """Every stage of the A1 and A5 kernel chains at B=32, V=336 in float32
    and bfloat16: its time (CUDA events inside the call) and achieved
    TFLOP/s, beside one F.conv1d call (cuDNN; float32 under full_f32) on a
    tensor of the stage's shape. The port calls no such conv on a CUDA path:
    it is a yardstick."""
    import torch.nn.functional as F

    from electrocardio_panorama_tpu_torch.models import query_gates
    from electrocardio_panorama_tpu_torch.ops import angular_encode, full_f32
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1

    n = B * V_MAIN
    thetas = torch.tensor(rng.uniform(-np.pi, np.pi, (B, V_MAIN, 2)), dtype=torch.float32, device=dev)
    with torch.no_grad(), full_f32():
        gates = query_gates(params, thetas)
        for dt, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            log("kernels", f"stage blocks' dynamic shared memory, {key}: {a1.stage_smem_bytes(dt)} bytes")
            inputs = {"basis": (a1.basis_planes(folded[dt], latent).to(dt),
                                a1.basis_coeffs(angular_encode(thetas)).to(dt).float()),
                      "gates": (latent.to(dt), gates)}
            conv_ms = {}
            for form, ins in inputs.items():
                a1.decode_stage_ms(form, folded[dt], *ins)  # warm-up
                ms = a1.decode_stage_ms(form, folded[dt], *ins)
                for stage, macs in a1.STAGES[form]:
                    if form == "gates" and stage in ("conv3", "conv4+conv5"):
                        continue  # the basis form's stages, timed above
                    cin, cout, steps = STAGE_CONV[stage]
                    if (cin, cout, steps) not in conv_ms:
                        x = torch.randn(n, cin, steps, dtype=dt, device=dev)
                        w = torch.randn(cout, cin, 3, dtype=dt, device=dev)
                        conv_ms[cin, cout, steps] = cuda_ms(lambda: F.conv1d(x, w, padding=1), reps=3)
                        del x, w
                    log("kernels", f"stage decoder_{form} {key} {stage}: {ms[stage]:.3f} ms = "
                                   f"{2 * macs * n / ms[stage] * 1e-9:.1f} TFLOP/s | F.conv1d {cin}->{cout} k3 over "
                                   f"{steps} steps (cuDNN, yardstick): {conv_ms[cin, cout, steps]:.3f} ms on {card}")
            del inputs
            torch.cuda.empty_cache()


def check_views(name: str, out, ref32, same, dt, shape) -> tuple[bool, float, str]:
    """A decode form's output against the float32 plain version (the A1
    bars) and the plain version of its own dtype: (ok, max abs error, line)."""
    err, corr = compare(out, ref32)
    err_same, _ = compare(out, same)
    ok = (err <= F32_TOL) if dt == torch.float32 else (err <= BF16_TOL and corr > BF16_CORR)
    ok = ok and tuple(out.shape) == shape and bool(torch.isfinite(out).all())
    key = "f32" if dt == torch.float32 else "bf16"
    return ok, err, (f"{name} {key} B={shape[0]} V={shape[1]}: max|kernel - plain f32| = {err:.3e} "
                     f"corr {corr:.7f} (max|kernel - plain {key}| = {err_same:.3e})")


def forms_kernels(card: str, dev, params, latent, folded, rng) -> dict:
    """The gate-input form (A5, and A7 as its float32 instantiation) and the
    y1 form (A6) against their plain versions at B=32, V=336 and V=11, in
    float32 and bfloat16, at A1's bars. Returns {"decoder_gates_f32": {...},
    ...} with max_abs_err, ms, plain_ms, bound_ms, bound_by."""
    from electrocardio_panorama_tpu_torch.models import query_gates
    from electrocardio_panorama_tpu_torch.ops import angular_encode, full_f32
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1

    stats = {}
    with torch.no_grad():
        for n_views in (V_MAIN, V_PAD):
            thetas = torch.tensor(rng.uniform(-np.pi, np.pi, (B, n_views, 2)), dtype=torch.float32, device=dev)
            enc = angular_encode(thetas)
            with full_f32():
                gates = query_gates(params, thetas)
            for form, kw in (("gates", {"gates": gates}), ("y1", {"enc": enc, "head": "y1"})):
                ref = a1.fused_decode_views(folded[torch.float32], latent, v_tile=VIEW_TILE, plain=True, **kw)
                for dt, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                    out = a1.fused_decode_views(folded[dt], latent, v_tile=VIEW_TILE, **kw)
                    torch.cuda.synchronize()
                    same = a1.fused_decode_views(folded[dt], latent, v_tile=VIEW_TILE, plain=True, **kw)
                    ok, err, line = check_views(f"decoder_{form}", out, ref, same, dt, (B, n_views, 512))
                    if not ok:
                        log("kernels", "FAIL " + line)
                        raise SystemExit(1)
                    st = stats.setdefault(f"decoder_{form}_{key}", {"max_abs_err": 0.0})
                    st["max_abs_err"] = max(st["max_abs_err"], err)
                    del out, same
                    if n_views == V_MAIN:
                        n = B * n_views
                        weights = [t for k, t in folded[dt].items() if k not in ("A", "w1", "b1")]
                        if form == "gates":
                            lat = latent.to(dt)
                            ms = cuda_ms(lambda: a1.decode_gates_cuda(lat, gates, folded[dt]), reps=5)
                            plain_ms = cuda_ms(lambda: a1.decode_gates_plain(lat, gates, folded[dt]), reps=2)
                            flops = 2 * (CONV1_MACS + TAIL_MACS) * n
                            in_bytes = nbytes(lat, gates, folded[dt]["w1"], folded[dt]["b1"], *weights)
                        else:
                            y1 = a1.basis_y1(folded[dt], latent, enc)
                            ms = cuda_ms(lambda: a1.decode_y1_cuda(y1, folded[dt]), reps=5)
                            plain_ms = cuda_ms(lambda: a1.decode_y1_plain(y1, folded[dt]), reps=2)
                            flops = 2 * TAIL_MACS * n
                            in_bytes = nbytes(y1, *weights)
                            del y1
                        bms, bby = bound_ms(flops, in_bytes + n * 512 * 4, dt)
                        st.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby)
                        line += (f" | kernel {ms:.3f} ms/launch = {n / ms * 1e3:,.0f} views/s, plain "
                                 f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({bby}) on {card}")
                    log("kernels", "ok " + line)
                del ref
                torch.cuda.empty_cache()
    return stats


def decoder_float64_distances(card, a4, w, x, dout, runs: dict, label: str) -> bool:
    """Print how far each float32 run in `runs` ({name: (out dict, grads)},
    the kernels and the plain version) lies from a float64 pass of the plain
    version on the same inputs: out's and the moments' largest absolute
    difference and the gradients' worst L2 relative distance (the conv
    biases before a BN, rounding noise on every side, left out). Returns
    whether the kernel's moments lie within 1e-5 (relative and absolute) of
    the float64 pass's."""
    from electrocardio_panorama_tpu_torch.ops import full_f32

    ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    xg = x.clone().requires_grad_(True)
    with full_f32():
        out, mean, var = a4.train_decode_groups_plain(ws, xg, float64=True)
        out.backward(dout.double())
    truth_out, truth = out.detach(), {"x": xg.grad, **{k: v.grad for k, v in ws.items()}}
    moments = {"mean": mean, "var": var}
    parts, within = [], {}
    for name, (fwd, grads) in runs.items():
        err = float((fwd["out"].double() - truth_out).abs().max())
        m_err = max(float((fwd[k].double() - v).abs().max()) for k, v in moments.items())
        within[name] = all(torch.allclose(fwd[k].double(), v, rtol=1e-5, atol=1e-5) for k, v in moments.items())
        l2, worst = max((grad_errors(grads[k], truth[k])[1], k) for k in truth if k not in DEC_NOISE_KEYS)
        parts.append(f"{name}: out max abs {err:.3e}, moments max abs {m_err:.3e} (within 1e-5: {within[name]}), "
                     f"worst grad {worst} L2 {l2:.3e}")
    log("kernels", f"decoder_train f32 distance from a float64 plain pass (G=3, nb={B}, {label}): "
                   + "; ".join(parts) + f" on {card}")
    return within["kernel"]


def decoder_bf16_moments_bar(card: str, a4, w) -> bool:
    """bfloat16 A4f on the 16 input sets of a4.BF16_MOMENTS_BAR's shapes and
    x seeds (3 groups of 2, x from seed 5, and 3 groups of 32, x from each
    seed of a4.BF16_BAR_SEEDS, x ~ N(0, 0.5)) on this run's weights: prints,
    per set, the kernel's and the plain version's moments distance from the
    float64 pass and the kernel-vs-plain distance over the former 1e-5 bar.
    Returns whether every set meets the bar."""
    sets = [("nb 2, seed 5", 2, 5), *((f"nb 32, seed {s}", B, s) for s in a4.BF16_BAR_SEEDS)]
    ok, worst = True, (0.0, 0.0, 0.0)
    for name, nb, seed in sets:
        x = torch.tensor(np.random.default_rng(seed).normal(0, 0.5, (3, 256, nb * 128)), dtype=torch.float32,
                         device=w["w1"].device).to(torch.bfloat16)
        with torch.no_grad():
            ref = a4.train_decode_groups(w, x, plain=True)
            got = a4.train_decode_groups(w, x)
            truth = a4.train_decode_groups_plain(w, x, float64=True)
        torch.cuda.synchronize()
        c_kernel, c_plain = (a4.moments_distance(r[1:], truth[1:]) for r in (got, ref))
        gap = a4.moments_distance(got[1:], ref[1:])
        good = c_kernel <= a4.BF16_MOMENTS_BAR and c_plain <= a4.BF16_MOMENTS_BAR and gap <= DEC_BF16_STAT
        ok = ok and good
        worst = tuple(max(a, b) for a, b in zip(worst, (c_kernel, c_plain, gap)))
        log("kernels", f"{'ok' if good else 'FAIL'} decoder_train bf16 moments bar {a4.BF16_MOMENTS_BAR:.1e}, "
                       f"set {name}: c(kernel) {c_kernel:.4e}, c(plain) {c_plain:.4e}, kernel vs plain "
                       f"{gap:.4e} = {gap / 1e-5:.3f} x the former 1e-5 bar on {card}")
    log("kernels", f"decoder_train bf16 moments over {len(sets)} sets: worst c(kernel) {worst[0]:.4e}, c(plain) "
                   f"{worst[1]:.4e}, kernel vs plain {worst[2]:.4e}; all within the bar: {ok}")
    return ok


def decoder_fma_forward(card: str, a4, w, x) -> None:
    """Print float32 A4f's device ms by kernel (torch.profiler) and its conv
    stages' TFLOP/s on the FMA engine, and the forward conv kernel's
    registers, spills, shared memory, blocks per SM and grid against the
    card's SMs. Fails if a conv3_kernel<float...> ran, the FMA forward kernel
    did not, it spills, or it fits no SM."""
    from electrocardio_panorama_tpu_torch.ops.kernels import build
    from electrocardio_panorama_tpu_torch.utils.profiling import device_window

    N = 3 * B
    split = device_window(lambda: [a4.forward_cuda(w, x) for _ in range(5)], 5, top=16)
    by = split["by_kernel"]
    conv_ms = sum(v for k, v in by.items() if "conv_fwd_kernel_fma" in k)
    flops = 2 * (CONV1_MACS + TAIL_MACS - 64 * 3 * 512) * N  # conv1..conv4
    log("kernels", "A4f f32 device ms per launch by kernel (torch.profiler): "
                   + "; ".join(f"{k} {v:.3f}" for k, v in by.items())
                   + f"; all kernels {split['kernel_sum_ms']:.3f}, busy {split['busy_ms']:.3f}; the four convs "
                   + f"{conv_ms:.3f} ms = {flops / (1e9 * conv_ms) if conv_ms else 0.0:.1f} TFLOP/s on {card}")
    lib = build.load("decoder_train_fwd")
    res = (ctypes.c_int * 4)()
    rc = lib.decoder_train_fwd_fma_resources(res)
    regs, local, smem, per_sm = res
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {f"conv{i}": N * t // 64 * (co // 64)
             for i, (co, t) in enumerate(((128, 256), (128, 256), (64, 512), (64, 512)), 1)}
    ws = lib.decoder_train_fwd_workspace_floats_f32
    ws.restype, ws.argtypes = ctypes.c_longlong, [ctypes.c_int, ctypes.c_int]
    line = (f"FMA engine forward (decoder_train_fma.cuh conv_fwd_kernel_fma): {regs} registers, {local} bytes "
            f"local memory (spills), {smem} bytes static shared memory, {per_sm} blocks per SM of {sms} SMs; blocks "
            + ", ".join(f"{k} {v} ({v / (sms * max(per_sm, 1)):.2f} waves)" for k, v in grids.items())
            + f"; A4f f32 workspace at 3 groups of {B}: {ws(3, B) * 4 / 1e6:.2f} MB")
    if (rc != 0 or local > 0 or per_sm < 1 or conv_ms == 0
            or any("conv3_kernel<float" in k or "conv3_kernelIf" in k for k in by)):
        log("kernels", f"FAIL {line} (rc {rc}); a conv3_kernel<float...> ran, the FMA forward kernel did not, "
                       "it spills, or it fits no SM")
        raise SystemExit(1)
    log("kernels", line)


def decoder_tc_forward(card: str, a4, w, x) -> None:
    """Print bfloat16 A4f's device ms by kernel (torch.profiler) and its conv
    stages' TFLOP/s on the tensor-core engine, and the forward conv kernel's
    registers, spills, shared memory, blocks per SM and grids against the
    card's SMs, for the plain convs (conv2, conv4) and the upsampled ones at
    input resolution (conv1, conv3). Fails if a conv3_kernel ran, the
    tensor-core forward kernel did not, it spills, or it fits no SM."""
    from electrocardio_panorama_tpu_torch.ops.kernels import build
    from electrocardio_panorama_tpu_torch.utils.profiling import device_window

    N = 3 * B
    split = device_window(lambda: [a4.forward_cuda(w, x) for _ in range(5)], 5, top=16)
    by = split["by_kernel"]
    conv_ms = sum(v for k, v in by.items() if "conv_fwd_kernel_tc" in k)
    # the products the kernels run (conv1 and conv3 at input resolution), and
    # the same four convs counted at output resolution
    run_flops = 2 * 3 * (128 * 256 * 128 + 128 * 128 * 256 + 64 * 128 * 256 + 64 * 64 * 512) * N
    out_flops = 2 * (CONV1_MACS + TAIL_MACS - 64 * 3 * 512) * N
    rate = (lambda f: f / (1e9 * conv_ms)) if conv_ms else (lambda f: 0.0)
    log("kernels", "A4f bf16 device ms per launch by kernel (torch.profiler): "
                   + "; ".join(f"{k} {v:.3f}" for k, v in by.items())
                   + f"; all kernels {split['kernel_sum_ms']:.3f}, busy {split['busy_ms']:.3f}; the four convs "
                   + f"{conv_ms:.3f} ms = {rate(run_flops):.1f} TFLOP/s of the products run "
                   + f"({rate(out_flops):.1f} counted at output resolution) on {card}")
    lib = build.load("decoder_train_fwd")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ws = lib.decoder_train_fwd_workspace_floats_bf16
    ws.restype, ws.argtypes = ctypes.c_longlong, [ctypes.c_int, ctypes.c_int]
    ok = conv_ms > 0 and not any("conv3_kernel" in k for k in by)
    parts = []
    # (up, convs with their grids: N * input steps / 64 x output channels / 64)
    for up, grids in ((0, {"conv2": N * 256 // 64 * 2, "conv4": N * 512 // 64}),
                      (1, {"conv1": N * 128 // 64 * 2, "conv3": N * 256 // 64})):
        res = (ctypes.c_int * 5)()
        rc = lib.decoder_train_fwd_tc_resources(up, res)
        regs, local, smem, dyn, per_sm = res
        ok = ok and rc == 0 and local == 0 and per_sm >= 1
        parts.append(f"conv_fwd_kernel_tc<{up}>: {regs} registers, {local} bytes local memory (spills), {smem} "
                     f"bytes static and {dyn} dynamic shared memory, {per_sm} blocks per SM of {sms} SMs (rc {rc}); "
                     + ", ".join(f"{k} {v} blocks ({v / (sms * max(per_sm, 1)):.2f} waves)"
                                 for k, v in grids.items()))
    line = ("tensor-core engine forward (decoder_train_tc.cuh): " + "; ".join(parts)
            + f"; A4f bf16 workspace {ws(3, B) * 4 / 1e6:.3f} MB")
    if not ok:
        log("kernels", f"FAIL {line}; a conv3_kernel ran, the tensor-core forward kernel did not, it spills, "
                       "or it fits no SM")
        raise SystemExit(1)
    log("kernels", line)


def decoder_fma_engine(card: str, a4, w, x, dout, planes) -> None:
    """Print float32 A4b's device ms by kernel (torch.profiler), the FMA
    engine's TFLOP/s for the data gradients and the weight gradients apart,
    its dynamic shared memory, blocks per SM and the weight gradients'
    grids against two waves of the card's SMs."""
    from electrocardio_panorama_tpu_torch.ops.kernels import build
    from electrocardio_panorama_tpu_torch.utils.profiling import device_window

    N = 3 * B
    split = device_window(lambda: [a4.backward_cuda(w, x, dout, planes) for _ in range(5)], 5, top=16)
    by = split["by_kernel"]
    flops = 2 * (CONV1_MACS + TAIL_MACS - 64 * 3 * 512) * N  # conv1..conv4, once each way
    rates = {name: flops / (1e9 * sum(v for k, v in by.items() if name in k))
             for name in ("dgrad_kernel_fma", "dw_kernel_fma") if any(name in k for k in by)}
    log("kernels", "A4b f32 device ms per launch by kernel (torch.profiler): "
                   + "; ".join(f"{k} {v:.3f}" for k, v in by.items())
                   + f"; all kernels {split['kernel_sum_ms']:.3f}, busy {split['busy_ms']:.3f}; FMA engine "
                   + ", ".join(f"{k} {v:.1f} TFLOP/s" for k, v in rates.items()) + f" on {card}")
    lib = build.load("decoder_train_bwd")
    lib.decoder_train_bwd_fma_dw_blocks.argtypes = [ctypes.c_int] * 4
    lib.decoder_train_bwd_fma_blocks_per_sm.argtypes = [ctypes.c_int]
    per_sm = {name: lib.decoder_train_bwd_fma_blocks_per_sm(dw) for name, dw in (("dgrad", 0), ("dw", 1))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {f"conv{i}": lib.decoder_train_bwd_fma_dw_blocks(co, ci, t, N)
             for i, (co, ci, t) in enumerate(((128, 256, 256), (128, 128, 256), (64, 128, 512), (64, 64, 512)), 1)}
    waves = {k: v / (sms * max(per_sm["dw"], 1)) for k, v in grids.items()}
    ws_mb = {}
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"decoder_train_bwd_workspace_floats_{suffix}")
        fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int, ctypes.c_int]
        ws_mb[suffix] = fn(3, B) * 4 / 1e6
    log("kernels", f"FMA engine (decoder_train_fma.cuh): dw_kernel_fma {lib.decoder_train_bwd_fma_dw_smem_bytes()} "
                   f"bytes dynamic shared memory; blocks per SM dgrad_kernel_fma {per_sm['dgrad']}, dw_kernel_fma "
                   f"{per_sm['dw']} of {sms} SMs; dw_kernel_fma blocks "
                   + ", ".join(f"{k} {v} ({waves[k]:.2f} waves)" for k, v in grids.items())
                   + f"; A4b workspace at 3 groups of {B}: f32 {ws_mb['f32']:.2f} MB, bf16 {ws_mb['bf16']:.2f} MB")
    if min(waves.values()) < 2 or min(per_sm.values()) < 1:
        log("kernels", "FAIL dw_kernel_fma fills fewer than two waves of the card, or a kernel fits no SM")
        raise SystemExit(1)


def train_decoder_kernels(card: str, dev) -> dict:
    """A4f/A4b against the plain version at 3 groups of 32 samples in float32
    and bfloat16: the output, the batch moments, dx and all 18 parameter
    gradients under a fixed cotangent, with the model's BN offsets and (in
    float32) with offsets that leave every relu open; bitwise-equal results
    across two launches. Returns {"decoder_train_fwd_f32": {...}, ...} with
    max_abs_err, ms, plain_ms, bound_ms, bound_by."""
    from electrocardio_panorama_tpu_torch.models import init_nefnet
    from electrocardio_panorama_tpu_torch.ops import full_f32
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as a4

    G, nb = 3, B
    rng = np.random.default_rng(4)
    params, _ = init_nefnet(torch.Generator().manual_seed(4), lead_num=LEADS, device=dev)
    for key in a4.BN_KEYS:  # non-trivial BN affines
        for leaf, spread in (("weight", 0.2), ("bias", 0.2)):
            v = params[f"{key}.{leaf}"]
            params[f"{key}.{leaf}"] = v + torch.tensor(rng.normal(0, spread, v.shape), dtype=torch.float32, device=dev)
    x32 = torch.tensor(rng.normal(0, 0.5, (G, 256, nb * 128)), dtype=torch.float32, device=dev)
    dout = torch.tensor(rng.normal(0, 1, (G, nb, 512)), dtype=torch.float32, device=dev)
    stats = {}

    def run(w, x0, plain):
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        x = x0.clone().requires_grad_(True)
        with full_f32():
            out, mean, var = a4.train_decode_groups(ws, x, plain=plain)
            out.backward(dout)
        return {"out": out.detach(), "mean": mean, "var": var}, {"x": x.grad, **{k: v.grad for k, v in ws.items()}}

    def grads_ok(got, ref, l2_bar, corr_bar):
        """(ok, max abs error, (L2 relative, corr, name) of the worst gradient)."""
        ok, err, worst = True, 0.0, (0.0, 1.0, "")
        for k, r in ref.items():
            g, r = got[k].float(), r.float()
            err = max(err, float((g - r).abs().max()))
            if k in DEC_NOISE_KEYS:
                ok = ok and float(g.abs().max()) <= DEC_NOISE and float(r.abs().max()) <= DEC_NOISE
                continue
            _, l2, corr = grad_errors(g, r)
            if l2 >= worst[0]:
                worst = (l2, corr, k)
            ok = ok and l2 <= l2_bar and corr > corr_bar and bool(torch.isfinite(g).all())
        return ok, err, worst

    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        w = a4.pack_train_weights(params, dtype=dt)
        x = x32.to(dt)
        ref_fwd, ref_grads = run(w, x, True)
        fwd, grads = run(w, x, False)
        fwd2, grads2 = run(w, x, False)
        torch.cuda.synchronize()
        bitwise = (all(torch.equal(fwd[k], fwd2[k]) for k in fwd)
                   and all(torch.equal(grads[k], grads2[k]) for k in grads))
        fwd_err = float((fwd["out"] - ref_fwd["out"]).abs().max())
        stat_err = max(float((fwd[k] - ref_fwd[k]).abs().max()) for k in ("mean", "var"))
        pad_zero = float(fwd["mean"][:, 2:, 64:].abs().max()) == 0 and float(fwd["var"][:, 2:, 64:].abs().max()) == 0
        ok = bitwise and pad_zero and tuple(fwd["out"].shape) == (G, nb, 512) and bool(torch.isfinite(fwd["out"]).all())
        if dt == torch.float32:
            ok = ok and fwd_err <= F32_TOL and all(
                torch.allclose(fwd[k], ref_fwd[k], rtol=1e-5, atol=1e-5) for k in ("mean", "var"))
            g_ok, bwd_err, worst = grads_ok(grads, ref_grads, DEC_F32_GRAD_L2, DEC_F32_GRAD_CORR)
            # every relu open: the BN offsets at +8 leave summation order alone
            w_open = {k: (v + 8.0 if k[0] == "o" else v) for k, v in w.items()}
            open_ref, open_ref_grads = run(w_open, x, True)
            open_fwd, open_grads = run(w_open, x, False)
            o_ok, _, o_worst = grads_ok(open_grads, open_ref_grads, DEC_F32_OPEN_L2, DEC_F32_GRAD_CORR)
            o_ok = o_ok and float((open_fwd["out"] - open_ref["out"]).abs().max()) <= F32_TOL
            ok = ok and g_ok and o_ok
            extra = (f"; every relu open: worst grad {o_worst[2]} L2 {o_worst[0]:.2e}; A4f's and A4b's convs on "
                     f"the FMA engine decoder_train_fma.cuh (A4f: conv_fwd_kernel_fma)")
            m_ok = decoder_float64_distances(card, a4, w, x, dout, {"kernel": (fwd, grads),
                                                                    "plain f32": (ref_fwd, ref_grads)},
                                             "the model's BN offsets")
            m_ok = decoder_float64_distances(card, a4, w_open, x, dout, {"kernel": (open_fwd, open_grads),
                                                                         "plain f32": (open_ref, open_ref_grads)},
                                             "every relu open") and m_ok
            ok = ok and m_ok
            extra += f"; kernel moments within 1e-5 of the float64 pass: {m_ok}"
        else:
            _, corr = compare(fwd["out"], ref_fwd["out"])
            ok = ok and fwd_err <= DEC_BF16_FWD and corr > DEC_BF16_FWD_CORR and stat_err <= DEC_BF16_STAT
            g_ok, bwd_err, worst = grads_ok(grads, ref_grads, ENC_BF16_GRAD_L2, ENC_BF16_GRAD_CORR)
            bar_ok = decoder_bf16_moments_bar(card, a4, w)
            ok = ok and g_ok and bar_ok
            extra = f"; moments within the float64 bar on 16 sets: {bar_ok}"
        line = (f"decoder_train {name} G={G} nb={nb}: out max|kernel - plain| {fwd_err:.3e}, moments {stat_err:.3e}; "
                f"worst grad {worst[2]}: L2 {worst[0]:.2e} corr {worst[1]:.6f}; max|dgrad| {bwd_err:.3e}{extra}; "
                f"bitwise across a repeat launch: {bitwise}")
        if not ok:
            log("kernels", "FAIL " + line)
            raise SystemExit(1)

        # timing: one launch each as the trainer runs them (A4b on the planes
        # A4f kept), the pair, and the plain version on the same inputs
        planes = a4.forward_cuda(w, x)
        fwd_ms = cuda_ms(lambda: a4.forward_cuda(w, x), reps=10)
        bwd_ms = cuda_ms(lambda: a4.backward_cuda(w, x, dout, planes), reps=10)
        pair_ms = cuda_ms(lambda: a4.backward_cuda(w, x, dout), reps=10)
        with torch.no_grad():
            plain_fwd_ms = cuda_ms(lambda: a4.train_decode_groups_plain(w, x), reps=3)
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        xg = x.clone().requires_grad_(True)
        with full_f32():
            out_p, _, _ = a4.train_decode_groups_plain(ws, xg)
            plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad([out_p], [xg, *ws.values()], [dout],
                                                               retain_graph=True), reps=3)
        # operations: the forward's convs; the backward reads the planes the
        # forward kept (no recompute) and takes every data and every weight
        # gradient, twice the forward's operations, against x, dout, the
        # weights and the kept planes read and the float32 gradients written.
        # Bytes: the forward reads x and the weights and writes every plane it
        # keeps for the backward (a1..a4 and h4 float32, h1..h3 in the storage
        # type), out and the moments
        fwd_flops = 2 * (CONV1_MACS + TAIL_MACS) * G * nb
        wbytes = nbytes(*w.values())
        fb, fby = bound_ms(fwd_flops, nbytes(x, *planes.values()) + wbytes, dt)
        grad_bytes = nbytes(x.float()) + sum(v.numel() * 4 for v in w.values())  # float32 gradients
        bb, bby = bound_ms(2 * fwd_flops, nbytes(x, dout, *planes.values()) + wbytes + grad_bytes, dt)
        stats[f"decoder_train_fwd_{name}"] = dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=plain_fwd_ms,
                                                  bound_ms=fb, bound_by=fby)
        stats[f"decoder_train_bwd_{name}"] = dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=plain_bwd_ms,
                                                  bound_ms=bb, bound_by=bby)
        log("kernels", f"ok {line} | A4f {fwd_ms:.3f} ms/launch (plain {plain_fwd_ms:.3f} ms, bound {fb:.4f} ms "
                       f"{fby}), A4b on the kept planes {bwd_ms:.3f} ms/launch (plain {plain_bwd_ms:.3f} ms, "
                       f"bound {bb:.4f} ms {bby}), A4f + A4b {pair_ms:.3f} ms on {card}")
        if dt == torch.float32:
            decoder_fma_forward(card, a4, w, x)
            decoder_fma_engine(card, a4, w, x, dout, planes)
        else:
            decoder_tc_forward(card, a4, w, x)
    return stats


def train_phase(card: str, tmp: str) -> dict:
    """`main.main` at batch 32 for TRAIN_STEPS steps and one eval epoch, four
    runs with kernels in the train step, each held against the same run
    without the kernels under test (same batches, same masks):
      float32, TPU.train_encoder fused            vs the eager encoder   (A2/A3)
      bfloat16, TPU.train_encoder auto            vs the eager encoder   (A2/A3)
      float32, TPU.train_decoder fused, eager encoder vs all eager       (A4f/A4b)
      bfloat16, train_decoder fused + train_encoder auto vs the eager decoder
                                                  (every train kernel in one step)
    then one step of each from the same init, the params compared, and
    steady-state steps/s; and the float32 step with both fused twice from
    the same init, bitwise compared. Returns the launch counts of the runs
    with kernels, {"encoder_fwd_f32": n, ..., "decoder_train_fwd_f32": n, ...}."""
    from electrocardio_panorama_tpu_torch import main as train_main
    from electrocardio_panorama_tpu_torch.config import load_cfg
    from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as a4
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2
    from electrocardio_panorama_tpu_torch.training.solver import Solver

    def cfg_for(dtype, enc, dec, name):
        return load_cfg("configs/nef_net_synthetic.yml", [
            "output_dir", f"{tmp}/{name}_{dtype}_{enc}_{dec}", "DATA.synthetic_root", f"{tmp}/train_synth",
            "DATA.synthetic_n_train", str(B * TRAIN_STEPS), "DATA.synthetic_n_test", str(TRAIN_N_TEST),
            "DATA.batch_size", str(B), "SOLVER.epochs", "1", "TPU.steps_per_epoch", str(TRAIN_STEPS),
            "TPU.compute_dtype", dtype, "TPU.train_encoder", enc, "TPU.train_decoder", dec])

    runs, steps = {}, {}

    def run_main(dtype, enc, dec):
        """(history of the one epoch, kernel launches of the run), once per configuration."""
        if (dtype, enc, dec) not in runs:
            for counter in (a1.LAUNCHES, a2.LAUNCHES, a4.LAUNCHES):
                counter.clear()
            torch.cuda.synchronize()
            solver = train_main.main(cfg_for(dtype, enc, dec, "train"), device="cuda")
            torch.cuda.synchronize()
            runs[dtype, enc, dec] = (solver.history[0], {
                "A1": a1.LAUNCHES["float32"] + a1.LAUNCHES["bfloat16"],
                "A2": a2.LAUNCHES[f"fwd_{dtype}"], "A3": a2.LAUNCHES[f"bwd_{dtype}"],
                "A4f": a4.LAUNCHES[f"fwd_{dtype}"], "A4b": a4.LAUNCHES[f"bwd_{dtype}"]})
        return runs[dtype, enc, dec]

    loader = BeatLoader(build_dataset(cfg_for("float32", "xla", "xla", "data"), "train"), B, shuffle=True,
                        drop_last=True, seed=cfg_for("float32", "xla", "xla", "data").seed)
    batches = [b for _, b in zip(range(TRAIN_STEPS), loader)]

    def first_step(solver):
        params, bn, opt = solver.init_state()
        p0 = {k: v.detach().clone() for k, v in params.items()}
        bn, _ = solver.train_step(params, bn, opt, epoch=0, step=0, i1=1, i2=2, batch=batches[0])
        return p0, params, bn, opt

    def run_steps(dtype, enc, dec):
        """(init params, params after one step, steady steps/s), once per configuration."""
        if (dtype, enc, dec) not in steps:
            solver = Solver(cfg_for(dtype, enc, dec, "step"), use_writer=False, device="cuda")
            p0, params, bn, opt = first_step(solver)
            after = {k: v.detach().clone() for k, v in params.items()}
            for b in batches[1:]:  # warm-up
                bn, _ = solver.train_step(params, bn, opt, epoch=0, step=1, i1=0, i2=1, batch=b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = 3
            for r in range(reps):
                for i, b in enumerate(batches):
                    bn, _ = solver.train_step(params, bn, opt, epoch=1, step=i, i1=i % 3, i2=(i + 1) % 3, batch=b)
            torch.cuda.synchronize()
            steps[dtype, enc, dec] = (p0, after, reps * len(batches) / (time.perf_counter() - t0))
        return steps[dtype, enc, dec]

    def repeat_bitwise(dtype, enc, dec):
        """The first step again from the same init: equal bits?"""
        _, after, _ = run_steps(dtype, enc, dec)
        _, again, _, _ = first_step(Solver(cfg_for(dtype, enc, dec, "again"), use_writer=False, device="cuda"))
        return all(torch.equal(again[k].detach(), after[k]) for k in after)

    cases = (("float32", ("fused", "xla"), ("xla", "xla"), ("A2", "A3")),
             ("bfloat16", ("auto", "xla"), ("xla", "xla"), ("A2", "A3")),
             ("float32", ("xla", "fused"), ("xla", "xla"), ("A4f", "A4b")),
             ("bfloat16", ("auto", "fused"), ("auto", "xla"), ("A2", "A3", "A4f", "A4b")))
    launches = {}
    for dtype, (enc, dec), (base_enc, base_dec), kernels in cases:
        key = "f32" if dtype == "float32" else "bf16"
        hf, counts = run_main(dtype, enc, dec)
        he, _ = run_main(dtype, base_enc, base_dec)
        lf, le = hf["train_losses"][:, 0], he["train_losses"][:, 0]
        loss_rel = float(np.max(np.abs(lf - le) / np.abs(le)))
        sc = hf["scalars"]

        # one step of each from the same init on the same batch and masks
        p0, after, rate = run_steps(dtype, enc, dec)
        _, after_base, rate_base = run_steps(dtype, base_enc, base_dec)
        upd = torch.cat([(after_base[k] - p0[k]).flatten() for k in p0])

        def dist(a, b):  # |a - b| over the size of the baseline's update
            return float(torch.cat([(a[k] - b[k]).flatten() for k in p0]).norm() / upd.norm())

        upd_rel = dist(after, after_base)
        extra = f"; the step repeated from the same init bitwise equal: {repeat_bitwise(dtype, enc, dec)}"
        if dtype == "float32" and (enc, dec) == ("fused", "xla"):
            # the eager step with its backward left to PyTorch's default cuDNN
            # TF32 (the forward convs stay pinned): what full_f32 around
            # loss.backward() guards against
            loose = Solver(cfg_for(dtype, "xla", "xla", "tf32"), use_writer=False, device="cuda")
            loose._precision = contextlib.nullcontext
            saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                _, tf32, _, _ = first_step(loose)
            finally:
                torch.backends.cudnn.allow_tf32 = saved
            extra += (f"; eager step with a TF32 backward: |tf32 - eager| / |update| = "
                      f"{dist({k: v.detach() for k, v in tf32.items()}, after_base):.2e}")

        finite = all(np.isfinite(v) for v in sc.values()) and np.isfinite(hf["train_losses"]).all()
        line = (f"{dtype} TPU.train_encoder {enc} TPU.train_decoder {dec} vs {base_enc}/{base_dec}: "
                f"{hf['train_steps']} steps at B={B} + eval epoch of "
                f"{hf['eval_views']} views; losses {np.round(lf, 6).tolist()} vs "
                f"{np.round(le, 6).tolist()}: max rel {loss_rel:.2e} (bar {TRAIN_LOSS_REL[dtype]:g}); "
                f"params after step 1: |kernels - baseline| / |update| = {upd_rel:.2e} (bar "
                f"{TRAIN_UPDATE_REL[dtype]:g}); psnr_gen {sc['psnr_gen']:.3f} ssim_gen {sc['ssim_gen']:.4f}; "
                f"launches {' '.join(f'{k} {v}' for k, v in counts.items())}; "
                f"eval {hf['eval_views'] / hf['eval_s']:,.0f} views/s; "
                f"train steps/s steady {rate:.2f} (baseline {rate_base:.2f}), "
                f"first epoch {hf['train_steps'] / hf['train_s']:.2f} with warm-up{extra}; on {card}")
        ok = (finite and loss_rel <= TRAIN_LOSS_REL[dtype] and upd_rel <= TRAIN_UPDATE_REL[dtype]
              and all(counts[k] > 0 for k in kernels) and counts["A1"] > 0 and hf["train_steps"] == TRAIN_STEPS)
        if not ok:
            log("train", "FAIL " + line)
            raise SystemExit(1)
        log("train", "ok " + line)
        if dec == "xla":
            launches[f"encoder_fwd_{key}"], launches[f"encoder_bwd_{key}"] = counts["A2"], counts["A3"]
        else:
            launches[f"decoder_train_fwd_{key}"] = counts["A4f"]
            launches[f"decoder_train_bwd_{key}"] = counts["A4b"]

    # with both pairs fused no cuDNN backward convolution is left in the step
    log("train", f"float32 step with TPU.train_encoder fused and TPU.train_decoder fused, twice from the same "
                 f"init: bitwise equal: {repeat_bitwise('float32', 'fused', 'fused')}; steady "
                 f"{run_steps('float32', 'fused', 'fused')[2]:.2f} steps/s; on {card}")

    # roi_reverse is a batched matmul, so its backward has no atomics: two
    # gradients from the same inputs are bitwise equal
    from electrocardio_panorama_tpu_torch.ops import roi_reverse_1d

    rois = torch.as_tensor(batches[0]["rois"], device="cuda")
    grid = torch.randn(B, 384, 7, 32, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    cot = torch.randn(B, 384, 128, device="cuda", generator=torch.Generator("cuda").manual_seed(4))
    g = []
    for _ in range(2):
        x = grid.clone().requires_grad_(True)
        (roi_reverse_1d(x, rois) * cot).sum().backward()
        g.append(x.grad)
    if not torch.equal(g[0], g[1]):
        log("train", "FAIL roi_reverse_1d gradients differ between two runs on the same inputs")
        raise SystemExit(1)
    log("train", f"ok roi_reverse_1d gradient bitwise equal across two runs at B={B}")
    return launches


def nefnet2_synth_phase(card: str, tmp: str) -> dict:
    """Nef-Net2 through the trainer, then synthesis from scratch:
      * `main.main` with MODEL.model model_nefnet2 at batch 32 for
        TRAIN_STEPS steps and one eval epoch, float32, the eager encoder and
        TPU.train_decoder fused (A4f/A4b once a step, A1 in the eval epoch,
        A2/A3 never), held against the same run with train_decoder and
        eval_decoder xla: per-step losses, the params after one step, and an
        eval step's outputs and rest views (A1 against the eager decode);
        then the steady step time (CUDA events) and device busy ms;
      * `synth_cli` export-latents (4 batches of 8), fit-prior and generate
        (8 beats x 24 views) on the card from a seeded random Nef-Net
        checkpoint, held against the same commands under --device cpu, and
        generate under --device cpu on the card's prior (the same latents,
        bit for bit) against the card's.
    Returns the Nef-Net2 run's launches {"A1": n, "A4f": n, "A4b": n}."""
    import shutil

    from electrocardio_panorama_tpu_torch import main as train_main
    from electrocardio_panorama_tpu_torch import synth_cli
    from electrocardio_panorama_tpu_torch.config import load_cfg
    from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
    from electrocardio_panorama_tpu_torch.models import init_nefnet
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as a4
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2
    from electrocardio_panorama_tpu_torch.synthesis import GaussianLatentPrior
    from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer
    from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
    from electrocardio_panorama_tpu_torch.training.solver import Solver
    from electrocardio_panorama_tpu_torch.utils.profiling import device_window

    def cfg_for(dec, name):
        return load_cfg("configs/nef_net_synthetic.yml", [
            "output_dir", f"{tmp}/n2_{name}_{dec}", "DATA.synthetic_root", f"{tmp}/train_synth",
            "DATA.synthetic_n_train", str(B * TRAIN_STEPS), "DATA.synthetic_n_test", str(TRAIN_N_TEST),
            "DATA.batch_size", str(B), "SOLVER.epochs", "1", "TPU.steps_per_epoch", str(TRAIN_STEPS),
            "MODEL.model", "model_nefnet2", "TPU.compute_dtype", "float32", "TPU.train_encoder", "auto",
            "TPU.train_decoder", dec, "TPU.eval_decoder", "auto" if dec == "fused" else "xla"])

    runs = {}
    for dec in ("fused", "xla"):
        for counter in (a1.LAUNCHES, a2.LAUNCHES, a4.LAUNCHES):
            counter.clear()
        torch.cuda.synchronize()
        solver = train_main.main(cfg_for(dec, "train"), device="cuda")
        torch.cuda.synchronize()
        runs[dec] = (solver, {"A1": a1.LAUNCHES["float32"], "A2": a2.LAUNCHES["fwd_float32"],
                              "A3": a2.LAUNCHES["bwd_float32"], "A4f": a4.LAUNCHES["fwd_float32"],
                              "A4b": a4.LAUNCHES["bwd_float32"]})
    (sf, counts), (se, counts_e) = runs["fused"], runs["xla"]
    hf, he = sf.history[0], se.history[0]
    lf, le = hf["train_losses"][:, 0], he["train_losses"][:, 0]
    loss_rel = float(np.max(np.abs(lf - le) / np.abs(le)))

    # one step of each from the same init on the same batch and masks, then
    # both eval steps (A1 and eager rest views) on the eager run's stepped params
    cfg = cfg_for("fused", "step")
    batch = next(iter(BeatLoader(build_dataset(cfg, "train"), B, shuffle=True, drop_last=True, seed=cfg.seed)))
    test_batch = next(iter(BeatLoader(build_dataset(cfg, "test"), B, shuffle=False, drop_last=True,
                                      seed=cfg.seed + 1)))
    stepped = {}
    for dec in ("fused", "xla"):
        solver = Solver(cfg_for(dec, "step"), use_writer=False, device="cuda")
        params, bn, opt = solver.init_state()
        p0 = {k: v.detach().clone() for k, v in params.items()}
        bn, _ = solver.train_step(params, bn, opt, epoch=0, step=0, i1=1, i2=2, batch=batch)
        stepped[dec] = (solver, p0, {k: v.detach() for k, v in params.items()}, bn)
    (solver, p0, after_f, bn_f), (eager, _, after_e, bn_e) = stepped["fused"], stepped["xla"]
    upd = torch.cat([(after_e[k] - p0[k]).flatten() for k in p0])
    upd_rel = float(torch.cat([(after_f[k] - after_e[k]).flatten() for k in p0]).norm() / upd.norm())
    evals = {}
    for name, s_ in (("A1", solver), ("eager", eager)):  # the same stepped params and BN state
        a1.LAUNCHES.clear()
        evals[name] = (s_.eval_step(after_e, bn_e, test_batch), a1.LAUNCHES["float32"])
    (ev_f, a1_eval), (ev_e, a1_eager) = evals["A1"], evals["eager"]
    out_err, _ = compare(ev_f[0], ev_e[0])
    rest_err, rest_corr = compare(ev_f[1], ev_e[1])

    # the steady f32 step with A4 fused and the eager encoder
    params = {k: v.clone().requires_grad_(True) for k, v in after_f.items()}
    opt = get_optimizer(cfg, params)
    batches = [b for _, b in zip(range(TRAIN_STEPS), BeatLoader(build_dataset(cfg, "train"), B, shuffle=True,
                                                                 drop_last=True, seed=cfg.seed))]
    state = {"bn": bn_f}

    def run_all():
        for i, b in enumerate(batches):
            state["bn"], _ = solver.train_step(params, state["bn"], opt, epoch=1, step=i, i1=i % 3,
                                               i2=(i + 1) % 3, batch=b)

    run_all()  # warm-up
    step_ms = cuda_ms(run_all, reps=3) / len(batches)
    win = device_window(run_all, len(batches))

    sc = hf["scalars"]
    finite = all(np.isfinite(v) for v in sc.values()) and np.isfinite(hf["train_losses"]).all()
    line = (f"Nef-Net2 float32, eager encoder, TPU.train_decoder fused vs xla/xla: {hf['train_steps']} steps at "
            f"B={B} + eval epoch of {hf['eval_views']} views; losses {np.round(lf, 6).tolist()} vs "
            f"{np.round(le, 6).tolist()}: max rel {loss_rel:.2e} (bar {TRAIN_LOSS_REL['float32']:g}); params "
            f"after step 1: |kernels - eager| / |update| = {upd_rel:.2e} (bar {TRAIN_UPDATE_REL['float32']:g}); "
            f"eval step on the eager run's stepped params: out max|diff| {out_err:.3e}, rest views (A1, "
            f"{a1_eval} launch) "
            f"max|A1 - eager| {rest_err:.3e} corr {rest_corr:.7f} (bar {F32_TOL:g}); psnr_gen "
            f"{sc['psnr_gen']:.3f}; launches {' '.join(f'{k} {v}' for k, v in counts.items())} (eager run: "
            f"{' '.join(f'{k} {v}' for k, v in counts_e.items())}); steady step {step_ms:.3f} ms (CUDA events), "
            f"device busy {win['busy_ms']:.3f} ms per step (share {win['busy_share']:.3f}); on {card}")
    ok = (finite and hf["train_steps"] == TRAIN_STEPS and loss_rel <= TRAIN_LOSS_REL["float32"]
          and upd_rel <= TRAIN_UPDATE_REL["float32"] and rest_err <= F32_TOL and out_err <= F32_TOL
          and tuple(ev_f[1].shape) == tuple(ev_e[1].shape) and bool(torch.isfinite(ev_f[1]).all())
          and counts["A4f"] == counts["A4b"] == TRAIN_STEPS and counts["A1"] > 0 and a1_eval == 1
          and counts["A2"] == counts["A3"] == 0 and a1_eager == 0 and not any(counts_e.values()))
    if not ok:
        log("nefnet2_synth", "FAIL " + line)
        raise SystemExit(1)
    log("nefnet2_synth", "ok " + line)
    log("nefnet2_synth", "f32 Nef-Net2 step device ms by kernel: "
        + ", ".join(f"{k} {v:.3f}" for k, v in win["by_kernel"].items()))

    # ------------------------------------------------ synthesis from scratch
    out = f"{tmp}/synth_out"
    opts = ["output_dir", out, "DATA.dataset", "synthetic", "DATA.synthetic_root", f"{tmp}/synth_corpus",
            "DATA.synthetic_n_train", "2", "DATA.synthetic_n_test", "32"]
    scfg = load_cfg("configs/synthesis_from_scratch.yml", opts)
    p, s = init_nefnet(torch.Generator().manual_seed(scfg.seed), lead_num=3)
    CheckPointer(os.path.join(out, scfg.desc)).save("best_valid", params=p, bn_state=s)
    walls = {}

    def synth(device, latents, *cmds):
        for cmd, extra in cmds:
            argv = [cmd, "--config-file", "configs/synthesis_from_scratch.yml", "--device", device, *extra,
                    *opts, "latent_save_dir", latents]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synth_cli.main(argv)
            torch.cuda.synchronize()
            walls[device, cmd, latents] = time.perf_counter() - t0
        return np.load(f"{latents}/generated.npz")

    gen_args = ["--n", "8", "--views", "24"]
    cmds = (("export-latents", ["--max-batches", "4"]), ("fit-prior", []), ("generate", gen_args))
    card_gen = synth("cuda", f"{tmp}/lat_cuda", *cmds)
    synth("cuda", f"{tmp}/lat_cuda", ("generate", gen_args))  # warm: the second generate's wall time
    cpu_gen = synth("cpu", f"{tmp}/lat_cpu", *cmds)
    os.makedirs(f"{tmp}/lat_shared", exist_ok=True)
    shutil.copy(f"{tmp}/lat_cuda/prior.npz", f"{tmp}/lat_shared/prior.npz")
    shared_gen = synth("cpu", f"{tmp}/lat_shared", ("generate", gen_args))
    # the same prior gives the same latents on the host whichever device decodes
    draws = [GaussianLatentPrior.load(f"{tmp}/{d}/prior.npz").sample(np.random.default_rng(scfg.seed), 8)
             for d in ("lat_cuda", "lat_shared")]
    same_latents = all(np.array_equal(a, b) for a, b in zip(*draws))
    pc, pq = np.load(f"{tmp}/lat_cuda/prior.npz"), np.load(f"{tmp}/lat_cpu/prior.npz")
    prior_err = max(float(np.abs(pc[k] - pq[k]).max()) for k in ("mean_z1", "std_z1", "mean_z2", "std_z2"))
    ecg = card_gen["ecg"]
    err = float(np.abs(ecg - cpu_gen["ecg"]).max())
    err_shared = float(np.abs(ecg - shared_gen["ecg"]).max())
    good = (ecg.shape == (8, 24, 512) and np.isfinite(ecg).all() and ((ecg > 0) & (ecg < 1)).all()
            and err <= F32_TOL and err_shared <= F32_TOL and same_latents
            and np.array_equal(card_gen["views"], cpu_gen["views"]))
    w = {k[:2]: v for k, v in walls.items() if k[2] == f"{tmp}/lat_cuda"}
    line = (f"synth_cli on the card: export-latents (4 batches of 8) {w['cuda', 'export-latents']:.3f} s, "
            f"fit-prior {w['cuda', 'fit-prior']:.3f} s, generate 8 x 24 views {w['cuda', 'generate']:.3f} s "
            f"wall (in process, second call; --device cpu {walls['cpu', 'generate', f'{tmp}/lat_cpu']:.3f} s); "
            f"generated {list(ecg.shape)}; card vs --device cpu: prior moments max|diff| {prior_err:.3e}, "
            f"max|generated diff| {err:.3e}; on the card's prior (latents bitwise equal: {same_latents}) "
            f"{err_shared:.3e} (bar {F32_TOL:g}); on {card}")
    if not good:
        log("nefnet2_synth", "FAIL " + line)
        raise SystemExit(1)
    log("nefnet2_synth", "ok " + line)
    return {"A1": counts["A1"], "A4f": counts["A4f"], "A4b": counts["A4b"]}


def parallel_annotate_phase(card: str, tmp: str) -> dict:
    """Data parallelism and the annotate entry point:
      * `main.main` at batch 32 for TRAIN_STEPS steps and one eval epoch with
        TPU.train_encoder and TPU.train_decoder fused, float32 and bfloat16,
        under TPU.mesh_shape [1] (the Solver starts an NCCL group of one)
        against the same run without a mesh: params and BN state after the
        steps, per-step losses and the eval scalars bitwise equal, and the
        same A2/A3/A4f/A4b launches; then each Solver's steady step time
        (CUDA events, mesh and no mesh in turns) and the MFU of the
        utils/flops.py train-step count;
      * the view-sharded panorama (`parallel.build_sharded_panorama`) on a
        (1, 1) mesh through A1 against `PanoramaGenerator.render` on 32 beats
        x 84 views, float32 and bfloat16: bitwise equal, one A1 launch each;
      * the annotate CLI (`annotation.cli`) segment / validate / show on
        records of the synthetic corpus, then the port's `build_dataset` on
        the segmented labels.
    Returns the mesh runs' launches by kernel row name."""
    import io
    import shutil

    from electrocardio_panorama_tpu_torch import main as train_main
    from electrocardio_panorama_tpu_torch.annotation import cli as annotate_cli
    from electrocardio_panorama_tpu_torch.config import load_cfg
    from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
    from electrocardio_panorama_tpu_torch.models import build_model, init_nefnet
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as a4
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2
    from electrocardio_panorama_tpu_torch.parallel import build_sharded_panorama, make_mesh
    from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator, theta_grid
    from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer
    from electrocardio_panorama_tpu_torch.utils import flops

    def cfg_for(dtype, mesh):
        cfg = load_cfg("configs/nef_net_synthetic.yml", [
            "output_dir", f"{tmp}/mesh{len(mesh)}_{dtype}", "DATA.synthetic_root", f"{tmp}/train_synth",
            "DATA.synthetic_n_train", str(B * TRAIN_STEPS), "DATA.synthetic_n_test", str(TRAIN_N_TEST),
            "DATA.batch_size", str(B), "SOLVER.epochs", "1", "TPU.steps_per_epoch", str(TRAIN_STEPS),
            "TPU.compute_dtype", dtype, "TPU.train_encoder", "fused", "TPU.train_decoder", "fused"])
        cfg.TPU.mesh_shape = list(mesh)
        return cfg

    launches = {}
    for dtype in ("float32", "bfloat16"):
        key = "f32" if dtype == "float32" else "bf16"
        runs = {}
        for mesh in ((), (1,)):
            for counter in (a1.LAUNCHES, a2.LAUNCHES, a4.LAUNCHES):
                counter.clear()
            torch.cuda.synchronize()
            cfg = cfg_for(dtype, mesh)
            solver = train_main.main(cfg, device="cuda")
            torch.cuda.synchronize()
            counts = {"A1": a1.LAUNCHES["float32"] + a1.LAUNCHES["bfloat16"],
                      "A2": a2.LAUNCHES[f"fwd_{dtype}"], "A3": a2.LAUNCHES[f"bwd_{dtype}"],
                      "A4f": a4.LAUNCHES[f"fwd_{dtype}"], "A4b": a4.LAUNCHES[f"bwd_{dtype}"]}
            params, bn, _, extras = CheckPointer(os.path.join(cfg.output_dir, cfg.desc)).load()
            runs[mesh] = (solver, counts, params, bn, extras)
        (s0, c0, p0, b0, e0), (s1, c1, p1, b1, e1) = runs[()], runs[(1,)]
        h0, h1 = s0.history[0], s1.history[0]
        same = (all(torch.equal(p0[k], p1[k]) for k in p0) and all(torch.equal(b0[k], b1[k]) for k in b0)
                and np.array_equal(h0["train_losses"], h1["train_losses"]) and h0["scalars"] == h1["scalars"]
                and e0 == e1)

        # steady steps of both Solvers on the same batches, in turns
        batches = [b for _, b in zip(range(TRAIN_STEPS), BeatLoader(
            build_dataset(cfg, "train"), B, shuffle=True, drop_last=True, seed=cfg.seed))]
        step_ms = {}
        for solver in (s0, s1, s1, s0):
            params, bn, opt = solver.init_state()
            state = {"bn": bn}

            def run_all():
                for i, b in enumerate(batches):
                    state["bn"], _ = solver.train_step(params, state["bn"], opt, epoch=1, step=i, i1=i % 3,
                                                       i2=(i + 1) % 3, batch=b)

            step_ms.setdefault(solver.mesh is not None, []).append(cuda_ms(run_all, reps=3) / len(batches))
        peak = flops.H100_F32_FLOPS if dtype == "float32" else flops.H100_BF16_FLOPS
        mfu = {m: [flops.mfu_pct(flops.TRAIN_STEP_FLOPS_B32, t / 1e3, peak) for t in ts] for m, ts in step_ms.items()}
        line = (f"{dtype}, both pairs fused, TPU.mesh_shape [1] vs no mesh: {h1['train_steps']} steps at B={B} + "
                f"eval epoch; params, BN state, losses {np.round(h1['train_losses'][:, 0], 6).tolist()} and eval "
                f"scalars (psnr_gen {h1['scalars']['psnr_gen']:.4f}) bitwise equal: {same}; launches "
                f"{' '.join(f'{k} {v}' for k, v in c1.items())} (no mesh: "
                f"{' '.join(f'{k} {v}' for k, v in c0.items())}); steady step "
                f"{' / '.join(f'{t:.3f}' for t in step_ms[True])} ms under the mesh, "
                f"{' / '.join(f'{t:.3f}' for t in step_ms[False])} ms without (CUDA events); MFU of "
                f"{flops.TRAIN_STEP_FLOPS_B32:.4g} FLOPs a step against {peak / 1e12:g} TFLOP/s: "
                f"{' / '.join(f'{m:.3f}' for m in mfu[True])} % under the mesh, "
                f"{' / '.join(f'{m:.3f}' for m in mfu[False])} % without; on {card}")
        ok = (same and c0 == c1 and all(c1[k] == TRAIN_STEPS for k in ("A2", "A3", "A4f", "A4b")) and c1["A1"] > 0
              and np.isfinite(h1["train_losses"]).all())
        if not ok:
            log("parallel_annotate", "FAIL " + line)
            raise SystemExit(1)
        log("parallel_annotate", "ok " + line)
        launches.update({f"encoder_fwd_{key}": c1["A2"], f"encoder_bwd_{key}": c1["A3"],
                         f"decoder_train_fwd_{key}": c1["A4f"], f"decoder_train_bwd_{key}": c1["A4b"]})

    # ------------------------------------------- the view-sharded panorama
    cfg = cfg_for("float32", ())
    model = build_model(cfg)
    p0, s0 = init_nefnet(torch.Generator().manual_seed(cfg.seed), lead_num=3, device="cuda")
    batch = next(iter(BeatLoader(build_dataset(cfg, "test"), B, shuffle=False, drop_last=True, seed=cfg.seed)))
    views = theta_grid(7, 12)
    inputs = [torch.as_tensor(batch[k], device="cuda") for k in ("data", "input_theta", "rois")]
    mesh = make_mesh((1, 1), ("data", "view"), device="cuda")
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ref = PanoramaGenerator(model, p0, s0, compute_dtype=dt, use_fused=True, device="cuda").render(
            batch["data"], batch["input_theta"], batch["rois"], views)
        a1.LAUNCHES.clear()
        render = build_sharded_panorama(model, mesh, use_fused=True, compute_dtype=dt)
        out = render(p0, s0, *inputs, torch.as_tensor(views, device="cuda"))
        torch.cuda.synchronize()
        n = a1.LAUNCHES[name]
        line = (f"view-sharded panorama on a (1, 1) mesh, {name}: {list(out.shape)} through A1 ({n} launch) "
                f"bitwise equal to PanoramaGenerator.render: {torch.equal(out, ref)}; on {card}")
        if not (torch.equal(out, ref) and n == 1 and tuple(out.shape) == (B, len(views), 512)):
            log("parallel_annotate", "FAIL " + line)
            raise SystemExit(1)
        log("parallel_annotate", "ok " + line)
        launches[f"decoder_basis_{'f32' if name == 'float32' else 'bf16'}"] = n

    # ---------------------------------------------------- the annotate CLI
    npy_dir = f"{tmp}/train_synth/npy_data/tianchi_train_round1"
    truth_dir = f"{tmp}/train_synth/tianchi_interval"
    label_dir = f"{tmp}/annotated"
    os.makedirs(label_dir, exist_ok=True)
    names = sorted(os.listdir(npy_dir))[:4]
    beats, true_beats, printed = 0, 0, io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        for name in names:
            rec, label = f"{npy_dir}/{name}", f"{label_dir}/{name[:-4]}.json"
            codes = (annotate_cli.main(["segment", rec, "--out", label]),
                     annotate_cli.main(["validate", label, "--record", rec]), annotate_cli.main(["show", label]))
            if codes != (0, 0, 0):
                log("parallel_annotate", f"FAIL annotate CLI on {name}: exit codes {codes}")
                raise SystemExit(1)
            beats += len(json.load(open(label))["P on"])
            true_beats += len(json.load(open(f"{truth_dir}/{name[:-4]}.json"))["P on"])
    secs = time.perf_counter() - t0
    with open(f"{label_dir}/list.txt", "w") as f:
        f.write("".join(f"{name[:-4]}.json\n" for name in names))
    shutil.copy(f"{label_dir}/list.txt", f"{label_dir}/test_list.txt")
    dcfg = load_cfg("configs/nef_net_synthetic.yml", [
        "output_dir", f"{tmp}/annotated_out", "DATA.dataset", "tianchi", "DATA.train_label_path",
        f"{label_dir}/list.txt", "DATA.test_label_path", f"{label_dir}/test_list.txt", "DATA.train_data_root",
        npy_dir, "DATA.train_label_root", label_dir])
    ds = build_dataset(dcfg, "train")
    meta = ds.__getitem__(0, rng=np.random.default_rng(0))
    good = (meta["data"].shape == (3, 512) and meta["rois"][0, 0] == 0 and meta["rois"][-1, 1] == 512
            and printed.getvalue().count("OK:") == len(names) and beats > 0)
    line = (f"annotate CLI segment / validate / show on {len(names)} records of the synthetic corpus in {secs:.3f} s: "
            f"{beats} beats found ({true_beats} in the corpus' own labels); build_dataset on the segmented labels: "
            f"{len(ds)} records, a train example's data {list(meta['data'].shape)}, rois from "
            f"{int(meta['rois'][0, 0])} to {int(meta['rois'][-1, 1])}")
    if not good:
        log("parallel_annotate", "FAIL " + line)
        raise SystemExit(1)
    log("parallel_annotate", "ok " + line)
    torch.distributed.destroy_process_group()  # the group of one that the mesh runs started
    return launches


def launches_by_row(a1, a2, a4) -> dict:
    """Every kernel row's launch count from the wrappers' counters."""
    rows = {}
    for dt, key in (("float32", "f32"), ("bfloat16", "bf16")):
        rows.update({f"decoder_basis_{key}": a1.LAUNCHES[dt], f"decoder_gates_{key}": a1.LAUNCHES[f"gates_{dt}"],
                     f"decoder_y1_{key}": a1.LAUNCHES[f"y1_{dt}"], f"encoder_fwd_{key}": a2.LAUNCHES[f"fwd_{dt}"],
                     f"encoder_bwd_{key}": a2.LAUNCHES[f"bwd_{dt}"],
                     f"decoder_train_fwd_{key}": a4.LAUNCHES[f"fwd_{dt}"],
                     f"decoder_train_bwd_{key}": a4.LAUNCHES[f"bwd_{dt}"]})
    return rows


def lead_parallel_phase(card: str, tmp: str) -> dict:
    """Lead tensor parallelism and the 3-axis train step on a (1, 1, 1)
    (data, lead, view) mesh, an NCCL group of one, at full width
    (configs/nef_net_synthetic.yml: 3 leads, batch 32):
      * TRAIN_STEPS steps of `build_3d_train_step(deterministic=True)` in
        float32 and bfloat16 against the same steps of the single-process
        eager Solver step (no mesh, dropout off) on the same batches, both on
        cuDNN's deterministic algorithms: float32 losses atol 2e-6, params,
        BN state and SGD momentum atol 5e-6 (the JAX package's
        tests/test_sharding.py bars); bfloat16 losses within rtol 0.05 / atol
        5e-3 of the float32 3-axis run's, float32 masters; whether each is
        bitwise; on cuDNN's default algorithms the same distances, and the
        single-process step's from its own repeat, printed with no bar; both
        steps' ms (CUDA events, in turns);
      * the lead-parallel panorama over 32 beats x 84 views against encode +
        decode_views: atol 2e-5;
      * no kernel launches: the lead path is eager, as in the JAX package.
    Returns the phase's launches by kernel row name."""
    from electrocardio_panorama_tpu_torch.config import load_cfg
    from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
    from electrocardio_panorama_tpu_torch.models import init_nefnet
    from electrocardio_panorama_tpu_torch.ops import full_f32
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as a4
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2
    from electrocardio_panorama_tpu_torch.parallel import (build_3d_train_step, build_lead_parallel_panorama,
                                                           gather_lead_params, make_mesh, shard_lead_params)
    from electrocardio_panorama_tpu_torch.synthesis import theta_grid
    from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
    from electrocardio_panorama_tpu_torch.training.solver import Solver

    def cfg_for(dtype):
        return load_cfg("configs/nef_net_synthetic.yml", [
            "output_dir", f"{tmp}/lead_{dtype}", "DATA.synthetic_root", f"{tmp}/train_synth",
            "DATA.synthetic_n_train", str(B * TRAIN_STEPS), "DATA.synthetic_n_test", str(TRAIN_N_TEST),
            "DATA.batch_size", str(B), "TPU.compute_dtype", dtype, "TPU.train_encoder", "xla",
            "TPU.train_decoder", "xla", "desc", "debug"])

    def momentum(opt, params):
        return {k: opt.state[v].get("momentum_buffer", torch.zeros_like(v)) for k, v in params.items()}

    def max_diff(a: dict, b: dict) -> float:
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)

    for counter in (a1.LAUNCHES, a2.LAUNCHES, a4.LAUNCHES):
        counter.clear()
    dev = torch.device("cuda")
    mesh = make_mesh((1, 1, 1), ("data", "lead", "view"), device="cuda")
    cfg = cfg_for("float32")
    batches = [b for _, b in zip(range(TRAIN_STEPS), BeatLoader(
        build_dataset(cfg, "train"), B, shuffle=True, drop_last=True, seed=cfg.seed))]
    p_init, s_init = init_nefnet(torch.Generator().manual_seed(cfg.seed), lead_num=LEADS, device=dev)
    def train(cfg, solver, which: str):
        """TRAIN_STEPS steps from p_init on `batches`, the single-process
        Solver step or the 3-axis step: ((losses [steps, 4], params, momentum,
        BN state) as full tensors, a closure that takes the steps again)."""
        if which == "single":
            p = {k: v.clone().requires_grad_(True) for k, v in p_init.items()}
            opt = get_optimizer(cfg, p)

            def one(bn, **kw):
                return solver.train_step(p, bn, opt, **kw)
        else:
            p = {k: v.requires_grad_(True) for k, v in shard_lead_params(p_init, mesh, lead_num=LEADS).items()}
            opt = get_optimizer(cfg, p)
            one = functools.partial(build_3d_train_step(solver.model, cfg, opt, mesh, deterministic=True), p)

        def steps(losses=None):
            bn = s_init
            for i, b in enumerate(batches):
                bn, lvec = one(bn, epoch=0, step=i, i1=i % LEADS, i2=(i + 1) % LEADS, batch=b)
                if losses is not None:
                    losses.append(lvec)
            return bn

        losses = []
        bn = steps(losses)
        torch.cuda.synchronize()
        return (torch.stack(losses).cpu(), gather_lead_params(p, mesh), gather_lead_params(momentum(opt, p), mesh),
                bn), steps

    def distance(a, b) -> tuple[dict, bool]:
        """Max |a - b| of losses, params, momentum and BN state; bitwise."""
        d = {"losses": float((a[0] - b[0]).abs().max())}
        d.update({name: max_diff(x, y) for name, x, y in zip(("params", "momentum", "bn"), a[1:], b[1:])})
        bitwise = torch.equal(a[0], b[0]) and all(torch.equal(x[k], y[k]) for x, y in zip(a[1:], b[1:]) for k in x)
        return d, bitwise

    def fmt(d: dict) -> str:
        return ", ".join(f"{k} {v:.3e}" for k, v in d.items())

    cudnn_deterministic = torch.backends.cudnn.deterministic
    losses3d, ok_all = {}, True
    for dtype in ("float32", "bfloat16"):
        cfg = cfg_for(dtype)
        solver = Solver(cfg, use_writer=False, device="cuda")
        solver.draw_masks = lambda gen, b: None  # dropout off, as deterministic=True
        # cuDNN's default algorithms: the float32 eager backward does not
        # repeat bitwise (ROADMAP Queue C item 1), which sets a floor under
        # any comparison of two eager runs; printed, no bar
        torch.backends.cudnn.deterministic = False
        single, run_single = train(cfg, solver, "single")
        again, _ = train(cfg, solver, "single")
        lead, run_lead = train(cfg, solver, "3d")
        floor, floor_bitwise = distance(single, again)
        free, free_bitwise = distance(single, lead)
        log("lead_parallel", f"{dtype}, cuDNN's default algorithms (no bar): the single-process step against its "
                             f"own repeat: max |diff| {fmt(floor)}, bitwise {floor_bitwise}; the 3-axis step against "
                             f"it: {fmt(free)}, bitwise {free_bitwise}")
        step_ms = {}
        for which, fn in (("single", run_single), ("3d", run_lead), ("3d", run_lead), ("single", run_single)):
            step_ms.setdefault(which, []).append(cuda_ms(fn, reps=2) / len(batches))
        # the bars, on cuDNN's deterministic algorithms
        torch.backends.cudnn.deterministic = True
        single, _ = train(cfg, solver, "single")
        lead, _ = train(cfg, solver, "3d")
        d, bitwise = distance(single, lead)
        losses3d[dtype] = lead[0]
        full, mom = lead[1], lead[2]
        masters = all(v.dtype == torch.float32 for v in (*full.values(), *mom.values()))
        ok = masters and bool(torch.isfinite(lead[0]).all()) and all(
            full[k].shape == p_init[k].shape for k in p_init)
        if dtype == "float32":
            ok = ok and d["losses"] <= 2e-6 and max(d["params"], d["momentum"], d["bn"]) <= 5e-6
            track = ""
        else:
            track_ok = torch.allclose(lead[0], losses3d["float32"], rtol=0.05, atol=5e-3)
            ok = ok and track_ok
            track = (f"; losses against the float32 3-axis run: max abs "
                     f"{float((lead[0] - losses3d['float32']).abs().max()):.3e} (rtol 0.05, atol 5e-3: {track_ok})")
        line = (f"{dtype}, {TRAIN_STEPS} steps at B={B}, {LEADS} leads, (1, 1, 1) mesh, cuDNN deterministic: "
                f"3-axis step vs the single-process eager step, losses {np.round(lead[0][:, 0].numpy(), 6).tolist()}; "
                f"max |diff| {fmt(d)} (bars: losses 2e-6, the rest 5e-6 in float32); bitwise: {bitwise}; float32 "
                f"masters: {masters}{track}; step (cuDNN's default algorithms) "
                f"{' / '.join(f'{t:.3f}' for t in step_ms['3d'])} ms 3-axis, "
                f"{' / '.join(f'{t:.3f}' for t in step_ms['single'])} ms single-process (CUDA events) on {card}")
        log("lead_parallel", ("ok " if ok else "FAIL ") + line)
        ok_all = ok_all and ok
    torch.backends.cudnn.deterministic = cudnn_deterministic

    # the lead-parallel panorama against encode + decode_views
    cfg = cfg_for("float32")
    model = Solver(cfg, use_writer=False, device="cuda").model
    batch = next(iter(BeatLoader(build_dataset(cfg, "test"), B, shuffle=False, drop_last=True, seed=cfg.seed)))
    data, it, rois = (torch.as_tensor(batch[k], device=dev) for k in ("data", "input_theta", "rois"))
    views = torch.as_tensor(theta_grid(7, 12), device=dev)
    with torch.no_grad(), full_f32():
        latent = model.encode(p_init, data, it, rois).latent_all
        ref = model.decode_views(p_init, s_init, latent, views[None].expand(B, -1, -1))
    render = build_lead_parallel_panorama(model, mesh, view_axis="view")
    t0 = time.perf_counter()
    out = render(p_init, s_init, data, it, rois, views)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    err = float((out - ref).abs().max())
    ok = tuple(out.shape) == (B, len(views), 512) and err <= 2e-5 and bool(torch.isfinite(out).all())
    log("lead_parallel", f"{'ok' if ok else 'FAIL'} lead-parallel panorama on the (1, 1, 1) mesh: {list(out.shape)} "
                         f"in {secs:.3f} s, max |render - (encode + decode_views)| {err:.3e} (bar 2e-5), bitwise "
                         f"{torch.equal(out, ref)} on {card}")
    ok_all = ok_all and ok
    torch.cuda.synchronize()
    launches = launches_by_row(a1, a2, a4)
    if sum(launches.values()):
        log("lead_parallel", f"FAIL the lead path launched kernels: {launches}")
        ok_all = False
    torch.distributed.destroy_process_group()  # the group of one that the mesh started
    if not ok_all:
        raise SystemExit(1)
    return launches


def compare(out, ref):
    err = float((out - ref).abs().max())
    corr = float(np.corrcoef(out.double().cpu().numpy().ravel(), ref.double().cpu().numpy().ravel())[0, 1])
    return err, corr


def main() -> int:
    # ---------------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        log("device", "FAIL: torch.cuda.is_available() is False")
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    from electrocardio_panorama_tpu_torch.config import load_cfg
    from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
    from electrocardio_panorama_tpu_torch.models import build_model, init_nefnet, query_gates
    from electrocardio_panorama_tpu_torch.ops import angular_encode, full_f32
    from electrocardio_panorama_tpu_torch.ops.kernels import build
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1
    from electrocardio_panorama_tpu_torch import render
    from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator, theta_grid
    from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer

    # ----------------------------------------------------------------- 2. build
    t0 = time.time()
    reports = build.build(KERNELS)
    for name in KERNELS:
        build.load(name)
    log("build", f"{', '.join(KERNELS)} built in {time.time() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "spill" in line and " 0 bytes spill stores" not in line:
                log("build", f"{name}: {line.strip()}")
        for line in stage_kernel_resources(report) + engine_kernel_resources(report):
            log("build", f"{name}: {line}")

    # --------------------------------------------------------------- 3. kernels
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    params, state = init_nefnet(gen, lead_num=3, theta_encoder_len=1, device=dev)
    for k in state:  # non-trivial BN running statistics
        if k.endswith("running_mean"):
            state[k] = torch.tensor(rng.standard_normal(state[k].shape) * 0.1, dtype=torch.float32, device=dev)
        elif k.endswith("running_var"):
            state[k] = torch.tensor(rng.uniform(0.5, 2.0, state[k].shape), dtype=torch.float32, device=dev)
    model = build_model(load_cfg("configs/nef_net_synthetic.yml"))
    pts = np.concatenate([[0], np.sort(rng.choice(np.arange(8, 504, 4), 6, replace=False)), [512]])
    with torch.no_grad():
        latent = model.encode(
            params, torch.tensor(rng.uniform(0, 1, (B, 3, 512)), dtype=torch.float32, device=dev),
            torch.tensor(rng.uniform(-np.pi, np.pi, (B, 3, 2)), dtype=torch.float32, device=dev),
            torch.tensor(np.broadcast_to(np.stack([pts[:-1], pts[1:]], 1), (B, 7, 2)).copy(), device=dev),
        ).latent_all
    folded = {dt: a1.fold_decoder_bn(params, state, dtype=dt) for dt in (torch.float32, torch.bfloat16)}

    a1_stats = {}
    with torch.no_grad():
        for n_views in (V_MAIN, V_PAD):
            enc = angular_encode(torch.tensor(rng.uniform(-np.pi, np.pi, (B, n_views, 2)),
                                              dtype=torch.float32, device=dev))
            ref = a1.fused_decode_views(folded[torch.float32], latent, enc=enc, v_tile=VIEW_TILE, plain=True)
            for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                out = a1.fused_decode_views(folded[dt], latent, enc=enc, v_tile=VIEW_TILE)
                torch.cuda.synchronize()
                same = a1.fused_decode_views(folded[dt], latent, enc=enc, v_tile=VIEW_TILE, plain=True)
                ok, err, line = check_views("decoder_basis", out, ref, same, dt, (B, n_views, 512))
                if not ok:
                    log("kernels", "FAIL " + line)
                    return 1
                st = a1_stats.setdefault(name, {"max_abs_err": 0.0})
                st["max_abs_err"] = max(st["max_abs_err"], err)
                if n_views == V_MAIN:
                    U = a1.basis_planes(folded[dt], latent).to(dt)
                    ep = a1.basis_coeffs(enc).to(dt).float()
                    ms = cuda_ms(lambda: a1.decode_basis_cuda(U, ep, folded[dt]), reps=10)
                    plain_ms = cuda_ms(lambda: a1.decode_basis_plain(U, ep, folded[dt]), reps=3)
                    bound_ms, bound_by = a1_bound_ms(U, ep, folded[dt], B * n_views)
                    st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                    line += (f" | kernel {ms:.3f} ms/launch = {B * n_views / ms * 1e3:,.0f} views/s, "
                             f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}) on {card}")
                log("kernels", "ok " + line)
    form_stats = forms_kernels(card, dev, params, latent, folded, rng)
    decoder_stages(card, dev, params, latent, folded, rng)
    del folded, latent
    torch.cuda.empty_cache()
    enc_stats = encoder_kernels(card, dev)
    dec_stats = train_decoder_kernels(card, dev)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 4. render
    with tempfile.TemporaryDirectory() as tmp:
        overrides = ["output_dir", f"{tmp}/out", "DATA.synthetic_root", f"{tmp}/synth",
                     "DATA.synthetic_n_train", "2", "DATA.synthetic_n_test", "96"]
        cfg = load_cfg("configs/nef_net_synthetic.yml", overrides)
        p0, s0 = init_nefnet(torch.Generator().manual_seed(cfg.seed), lead_num=3)
        CheckPointer(os.path.join(cfg.output_dir, cfg.desc)).save("best_valid", params=p0, bn_state=s0)
        n_views = len(theta_grid(7, 12))
        results = {}
        a1.LAUNCHES.clear()
        for name in ("float32", "bfloat16"):
            cfg.TPU.compute_dtype = name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, rois = render.main(cfg, use_fused=True, batch_size=B, device="cuda",
                                    out_path=f"{tmp}/{name}.npz")
            torch.cuda.synchronize()
            results[name] = (out, time.perf_counter() - t0)
        launches = dict(a1.LAUNCHES)
        for name, (out, secs) in results.items():
            cfg.TPU.compute_dtype = name
            ref, _ = render.main(cfg, use_fused=True, batch_size=B, device="cuda", plain=True,
                                 out_path=f"{tmp}/{name}_plain.npz")
            err, corr = compare(torch.from_numpy(out), torch.from_numpy(ref))
            good = (out.shape[1:] == (n_views, 512) and out.shape[0] > 0
                    and np.isfinite(out).all() and ((out > 0) & (out < 1)).all())
            good = good and (err <= F32_TOL if name == "float32" else err <= BF16_TOL and corr > BF16_CORR)
            key = "f32" if name == "float32" else "bf16"
            line = (f"{name}: rest_out {list(out.shape)}, {out.shape[0]} beats x {n_views} views in "
                    f"{secs:.3f} s = {out.shape[0] * n_views / secs:,.0f} views/s end to end "
                    f"(data + encode + decode); kernel launches {launches.get(name, 0)}; "
                    f"max|kernel - plain| {err:.3e} corr {corr:.7f}")
            if not good or launches.get(name, 0) == 0:
                log("render", "FAIL " + line)
                return 1
            a1_stats[key]["launches"] = launches[name]
            log("render", "ok " + line)

        # the other entries of fused_decode_views, on the render checkpoint and
        # the first render batch's latents, against the views just rendered
        batch = next(iter(BeatLoader(build_dataset(cfg, phase="test"), B, shuffle=False, drop_last=False,
                                     seed=cfg.seed)))
        views = torch.tensor(theta_grid(7, 12), device=dev)[None].expand(B, n_views, 2)
        a1.LAUNCHES.clear()
        form_outs = {}
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            gen = PanoramaGenerator(model, p0, s0, compute_dtype=dt, use_fused=True, device="cuda")
            latent = gen.encode(batch["data"], batch["input_theta"], batch["rois"])
            with torch.no_grad(), full_f32():
                gates = query_gates(gen.params, views.to(dt)).float()
                enc = angular_encode(views.to(dt), 1)
                form_outs["gates", name] = a1.fused_decode_views(gen._folded, latent, gates, v_tile=VIEW_TILE)
                form_outs["y1", name] = a1.fused_decode_views(gen._folded, latent, enc=enc, v_tile=VIEW_TILE,
                                                              head="y1")
        torch.cuda.synchronize()
        launches = dict(a1.LAUNCHES)
        for (form, name), out in form_outs.items():
            key = "f32" if name == "float32" else "bf16"
            rendered = torch.from_numpy(results[name][0][:B]).to(dev)
            err, corr = compare(out, rendered)
            n = launches.get(f"{form}_{name}", 0)
            good = tuple(out.shape) == (B, n_views, 512) and bool(torch.isfinite(out).all()) and n > 0
            good = good and (err <= F32_TOL if name == "float32" else err <= BF16_TOL and corr > BF16_PAIR_CORR)
            line = (f"fused_decode_views {form} form, {name}: {B} beats x {n_views} views; kernel launches {n}; "
                    f"max|form - rendered (A1)| {err:.3e} corr {corr:.7f}")
            if not good:
                log("render", "FAIL " + line)
                return 1
            form_stats[f"decoder_{form}_{key}"]["launches"] = n
            log("render", "ok " + line)
        del form_outs

        # ------------------------------------------------------------- 5. train
        for name, n in train_phase(card, tmp).items():
            (enc_stats if name.startswith("encoder") else dec_stats)[name]["launches"] = n

        # ----------------------------------------------------- 6. nefnet2_synth
        n2 = nefnet2_synth_phase(card, tmp)

        # ------------------------------------------------- 7. parallel_annotate
        parallel_launches = parallel_annotate_phase(card, tmp)

        # ----------------------------------------------------- 8. lead_parallel
        lead_launches = lead_parallel_phase(card, tmp)
    nefnet2_launches = {"decoder_basis_f32": n2["A1"], "decoder_train_fwd_f32": n2["A4f"],
                        "decoder_train_bwd_f32": n2["A4b"]}

    # --------------------------------------------------------------- 9. summary
    kernels = [{
        "name": f"decoder_basis_{key}", "route": "cuda", "source": A1_SOURCE, "replaces": A1_REPLACES,
        "launches": st["launches"], "max_abs_err": st["max_abs_err"], "ms": st["ms"],
        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None,
    } for key, st in a1_stats.items()]
    where = {"encoder_fwd": (A2_SOURCE, A2_REPLACES), "encoder_bwd": (A3_SOURCE, A3_REPLACES),
             "decoder_train_fwd": (A4F_SOURCE, A4F_REPLACES), "decoder_train_bwd": (A4B_SOURCE, A4B_REPLACES)}
    for name, st in {**enc_stats, **dec_stats, **form_stats}.items():
        source, replaces = where.get(name.rsplit("_", 1)[0], (FORMS_SOURCE, FORMS_REPLACES.get(name)))
        # library_ms: no single PyTorch call computes any of these chains
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": st["launches"],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"], "library_ms": None,
        })
    for k in kernels:  # launches on the Nef-Net2 train run, under the mesh and on the lead path
        k["launches_nefnet2"] = nefnet2_launches.get(k["name"], 0)
        k["launches_parallel"] = parallel_launches.get(k["name"], 0)
        k["launches_lead"] = lead_launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 — any failure is a failed smoke run
        traceback.print_exc()
        code = 1
    sys.exit(code)
