"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero before the
result line:
  1. device  — a CUDA device is present; its name and power limit;
  2. build   — compile every CUDA kernel of the port from csrc/, all at once;
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main paths' widths (Nef-Net, 3 leads, theta_L=1, B=32):
               A1 at V=336 and V=11; A2/A3 (the fused encoder) for z1, the
               z2 grid, latent_all and every parameter gradient, bitwise
               across encoder_ckpt off/tower/full and a repeat launch;
               float32 and bfloat16, timed with CUDA events;
  4. render  — the port's render entry point (`render.main`) on a generated
               synthetic corpus with a seeded random checkpoint, over the
               84-view grid, in float32 and bfloat16, through A1; launch
               counts read around that run; held against the same run with
               the plain decode;
  5. train   — the port's trainer (`main.main`) on a generated synthetic
               corpus at batch 32: a few steps and one eval epoch (A1), in
               float32 with TPU.train_encoder fused and in bfloat16 with
               auto; A2/A3 launch counts read around each run; held against
               the same run with the eager encoder (same batches, same
               masks): per-step losses, and the params after one step;
  6. summary — one JSON line naming every kernel with its numbers.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # bf16 dense tensor cores
F32_TOL, BF16_TOL, BF16_CORR = 2e-5, 1e-4, 0.999
B, V_MAIN, V_PAD, VIEW_TILE = 32, 336, 11, 16
A1_REPLACES = "electrocardio_panorama_tpu/ops/pallas/decoder_fused.py:673"
A1_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/decoder_basis.cu"
A2_REPLACES = "electrocardio_panorama_tpu/ops/pallas/encoder_fused.py:438"
A2_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/encoder_fwd.cu"
A3_REPLACES = "electrocardio_panorama_tpu/ops/pallas/encoder_fused.py:500"
A3_SOURCE = "electrocardio_panorama_tpu_torch/ops/kernels/csrc/encoder_bwd.cu"
KERNELS = ["decoder_basis", "encoder_fwd", "encoder_bwd"]
LEADS = 3
# A2/A3 against the plain version. float32: forward max abs error 2e-5;
# gradients by the bulk (99.5% of elements within 2e-4 of the largest) plus
# energy (L2 relative 5e-4) criterion of tests/test_pallas_encoder.py.
# bfloat16: both round at the same points, and summation order moves a value
# by one bf16 ulp (2^-8 relative) now and then, which later stages carry:
# forward max abs error 2^-5 of the largest |value| and corr > 0.9999,
# gradients corr > 0.995 and L2 relative 5e-2 (tests/test_torch_encoder_fused.py).
ENC_BF16_FWD_REL, ENC_BF16_FWD_CORR, ENC_BF16_GRAD_CORR, ENC_BF16_GRAD_L2 = 2.0 ** -5, 0.9999, 0.995, 5e-2
# train phase, fused encoder against the eager one on the same batches and
# masks: per-step loss relative difference; the params after one step, as
# the L2 distance between the two updates over the L2 size of the update
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


def a1_bound_ms(U, ep, folded, n_views: int) -> tuple[float, str]:
    """Least time for the A1 function on these inputs: bytes (each input read
    once, the output written once) over HBM rate vs operations over the peak
    of the storage type."""
    J = ep.shape[-1]
    flops_per_view = 2 * (J * 128 * 256 + 128 * 128 * 3 * 256 + 64 * 128 * 3 * 512
                          + 64 * 64 * 3 * 512 + 64 * 3 * 512)
    flops = flops_per_view * n_views
    nbytes = (U.numel() * U.element_size() + ep.numel() * ep.element_size()
              + sum(t.numel() * t.element_size() for k, t in folded.items() if k not in ("w1", "A"))
              + n_views * 512 * 4)
    peak = H100_BF16_FLOPS if U.dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def encoder_convs(L: int) -> list[tuple[int, int, int, int]]:
    """(output channels, input channels per output, taps, output steps) of
    every convolution in the A2 chain, per sample."""
    C, Cz, Ch = 128 * L, 896 * L, 448 * L
    zblock = [(C, 64, 3, 128), (C, 128, 3, 128), (C, 64, 1, 128)]
    return ([(C, 1, 15, 256)] + [(C, 128, 7, 128)] * 6 + [(C, 128, 3, 128)] * 2 + zblock * 2
            + [(Cz, 128, 3, 16)] * 2 + [(Ch, 128, 1, 32)]
            + [(Cz, 64, 3, 32), (Cz, 128, 3, 32), (Cz, 64, 1, 32)])


def encoder_bound_ms(nbytes: int, dtype, batch: int, backward: bool) -> tuple[float, str]:
    """Least time for A2 (or A3: every data gradient but the input's, and
    every weight gradient) at these shapes: bytes over HBM rate vs
    operations over the storage type's peak."""
    convs = encoder_convs(LEADS)
    fwd = 2 * batch * sum(co * ci * k * t for co, ci, k, t in convs)
    co, ci, k, t = convs[0]
    flops = 2 * fwd - 2 * batch * co * ci * k * t if backward else fwd
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def grad_errors(a, b):
    """(share of elements off by more than 2e-4 of max|b|, L2 relative, corr)."""
    a, b = a.double().flatten(), b.double().flatten()
    bulk = float(((a - b).abs() / max(float(b.abs().max()), 1e-3) > 2e-4).double().mean())
    l2 = float((a - b).norm() / max(float(b.norm()), 1e-12))
    corr = float(np.corrcoef(a.cpu().numpy(), b.cpu().numpy())[0, 1]) if b.abs().max() > 0 else 1.0
    return bulk, l2, corr


def encoder_kernels(card: str, dev) -> dict:
    """A2/A3 against the plain version at B=32, L=3 in float32 and bfloat16:
    z1, the z2 grid and latent_all; every parameter gradient under a fixed
    cotangent; bitwise-equal gradients across encoder_ckpt off/tower/full and
    across two launches on the same inputs. Returns {"encoder_fwd_f32": {...},
    ...} with max_abs_err, ms, plain_ms, bound_ms, bound_by."""
    from electrocardio_panorama_tpu_torch.models import init_nefnet
    from electrocardio_panorama_tpu_torch.models.nefnet import latents_from_grid
    from electrocardio_panorama_tpu_torch.ops import angular_encode, full_f32, linear, roi_align_ramp
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2

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

        def run(plain, ckpt="tower"):
            ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
            g = gate.clone().requires_grad_(True)
            with full_f32():
                z1, z2g = a2.encode_fused(ws, x, g, ramp, masks, lead_num=L, ckpt=ckpt, plain=plain)
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
        bwd_err, worst = 0.0, (0.0, 0.0, 1.0, "")
        ok = bitwise and same_fwd
        for k, ref in ref_grads.items():
            got = grads["tower"][k]
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
        line = (f"encoder {name} B={B} L={L}: forward max|kernel - plain| {fwd_err:.3e}; worst grad "
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
        stats[f"encoder_fwd_{name}"] = dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=plain_fwd_ms,
                                            bound_ms=fb, bound_by=fby)
        stats[f"encoder_bwd_{name}"] = dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=plain_bwd_ms,
                                            bound_ms=bb, bound_by=bby)
        log("kernels", f"ok {line} | A2 {fwd_ms:.3f} ms/launch (plain {plain_fwd_ms:.3f} ms, bound {fb:.4f} ms "
                       f"{fby}), A3 {bwd_ms:.3f} ms/launch (plain {plain_bwd_ms:.3f} ms, bound {bb:.4f} ms "
                       f"{bby}) on {card}")
    return stats


def train_phase(card: str, tmp: str) -> dict:
    """`main.main` at batch 32 for TRAIN_STEPS steps and one eval epoch, in
    float32 (TPU.train_encoder fused) and bfloat16 (auto), each held against
    the same run with the eager encoder; then one step of each from the same
    init, the params compared, and steady-state steps/s. Returns the A2/A3
    launch counts of the fused runs, {"encoder_fwd_f32": n, ...}."""
    from electrocardio_panorama_tpu_torch import main as train_main
    from electrocardio_panorama_tpu_torch.config import load_cfg
    from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2
    from electrocardio_panorama_tpu_torch.training.solver import Solver

    def cfg_for(dtype, enc, name):
        return load_cfg("configs/nef_net_synthetic.yml", [
            "output_dir", f"{tmp}/{name}", "DATA.synthetic_root", f"{tmp}/train_synth",
            "DATA.synthetic_n_train", str(B * TRAIN_STEPS), "DATA.synthetic_n_test", str(TRAIN_N_TEST),
            "DATA.batch_size", str(B), "SOLVER.epochs", "1", "TPU.steps_per_epoch", str(TRAIN_STEPS),
            "TPU.compute_dtype", dtype, "TPU.train_encoder", enc])

    launches = {}
    for dtype, mode in (("float32", "fused"), ("bfloat16", "auto")):
        key = "f32" if dtype == "float32" else "bf16"
        a2.LAUNCHES.clear()
        a1.LAUNCHES.clear()
        torch.cuda.synchronize()
        fused = train_main.main(cfg_for(dtype, mode, f"train_{key}"), device="cuda")
        torch.cuda.synchronize()
        n_fwd, n_bwd = a2.LAUNCHES[f"fwd_{dtype}"], a2.LAUNCHES[f"bwd_{dtype}"]
        n_a1 = sum(a1.LAUNCHES.values())
        eager = train_main.main(cfg_for(dtype, "xla", f"train_{key}_eager"), device="cuda")
        hf, he = fused.history[0], eager.history[0]
        lf, le = hf["train_losses"][:, 0], he["train_losses"][:, 0]
        loss_rel = float(np.max(np.abs(lf - le) / np.abs(le)))
        sc = hf["scalars"]

        # one step of each from the same init on the same batch and masks
        cfg_f, cfg_e = cfg_for(dtype, mode, f"step_{key}"), cfg_for(dtype, "xla", f"step_{key}_eager")
        loader = BeatLoader(build_dataset(cfg_f, "train"), B, shuffle=True, drop_last=True, seed=cfg_f.seed)
        batches = [b for _, b in zip(range(TRAIN_STEPS), loader)]

        def first_step(solver):
            params, bn, opt = solver.init_state()
            p0 = {k: v.detach().clone() for k, v in params.items()}
            bn, _ = solver.train_step(params, bn, opt, epoch=0, step=0, i1=1, i2=2, batch=batches[0])
            return p0, params, bn, opt

        def dist(a, b):  # |a - b| over the size of the eager update
            return float(torch.cat([(a[k] - b[k]).flatten() for k in p0]).norm() / upd.norm())

        after, rates = {}, {}
        for name, cfg in (("fused", cfg_f), ("eager", cfg_e)):
            solver = Solver(cfg, use_writer=False, device="cuda")
            p0, params, bn, opt = first_step(solver)
            after[name] = {k: v.detach().clone() for k, v in params.items()}
            for b in batches[1:]:  # warm-up
                bn, _ = solver.train_step(params, bn, opt, epoch=0, step=1, i1=0, i2=1, batch=b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = 3
            for r in range(reps):
                for i, b in enumerate(batches):
                    bn, _ = solver.train_step(params, bn, opt, epoch=1, step=i, i1=i % 3, i2=(i + 1) % 3, batch=b)
            torch.cuda.synchronize()
            rates[name] = reps * len(batches) / (time.perf_counter() - t0)
        upd = torch.cat([(after["eager"][k] - p0[k]).flatten() for k in p0])
        upd_rel = dist(after["fused"], after["eager"])
        # determinism: the fused step again from the same init, bitwise
        _, again, _, _ = first_step(Solver(cfg_f, use_writer=False, device="cuda"))
        repeat_bitwise = all(torch.equal(again[k].detach(), after["fused"][k]) for k in p0)
        extra = f"; fused step repeated from the same init bitwise equal: {repeat_bitwise}"
        if dtype == "float32":
            # the eager step with its backward left to PyTorch's default cuDNN
            # TF32 (the forward convs stay pinned): what full_f32 around
            # loss.backward() guards against
            loose = Solver(cfg_e, use_writer=False, device="cuda")
            loose._precision = contextlib.nullcontext
            saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                _, tf32, _, _ = first_step(loose)
            finally:
                torch.backends.cudnn.allow_tf32 = saved
            extra += (f"; eager step with a TF32 backward: |tf32 - eager| / |update| = "
                      f"{dist({k: v.detach() for k, v in tf32.items()}, after['eager']):.2e}")

        finite = all(np.isfinite(v) for v in sc.values()) and np.isfinite(hf["train_losses"]).all()
        line = (f"{dtype} TPU.train_encoder {mode}: {hf['train_steps']} steps at B={B} + eval epoch of "
                f"{hf['eval_views']} views; losses {np.round(lf, 6).tolist()} vs eager "
                f"{np.round(le, 6).tolist()}: max rel {loss_rel:.2e} (bar {TRAIN_LOSS_REL[dtype]:g}); "
                f"params after step 1: |fused - eager| / |update| = {upd_rel:.2e} (bar "
                f"{TRAIN_UPDATE_REL[dtype]:g}); psnr_gen {sc['psnr_gen']:.3f} ssim_gen {sc['ssim_gen']:.4f}; "
                f"launches A2 {n_fwd} A3 {n_bwd} A1 {n_a1}; eval {hf['eval_views'] / hf['eval_s']:,.0f} views/s; "
                f"train steps/s steady {rates['fused']:.2f} (eager encoder {rates['eager']:.2f}), "
                f"first epoch {hf['train_steps'] / hf['train_s']:.2f} with warm-up{extra}; on {card}")
        ok = (finite and loss_rel <= TRAIN_LOSS_REL[dtype] and upd_rel <= TRAIN_UPDATE_REL[dtype]
              and n_fwd > 0 and n_bwd > 0 and n_a1 > 0 and hf["train_steps"] == TRAIN_STEPS)
        if not ok:
            log("train", "FAIL " + line)
            raise SystemExit(1)
        log("train", "ok " + line)
        launches[f"encoder_fwd_{key}"], launches[f"encoder_bwd_{key}"] = n_fwd, n_bwd

    # roi_reverse is a batched matmul, so its backward has no atomics: two
    # gradients from the same inputs are bitwise equal
    from electrocardio_panorama_tpu_torch.ops import roi_reverse_1d

    batch = next(iter(loader))
    rois = torch.as_tensor(batch["rois"], device="cuda")
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
    from electrocardio_panorama_tpu_torch.models import build_model, init_nefnet
    from electrocardio_panorama_tpu_torch.ops import angular_encode
    from electrocardio_panorama_tpu_torch.ops.kernels import build
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1
    from electrocardio_panorama_tpu_torch import render
    from electrocardio_panorama_tpu_torch.synthesis import theta_grid
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
                err, corr = compare(out, ref)
                err_same, _ = compare(out, same)
                ok = (err <= F32_TOL) if dt == torch.float32 else (err <= BF16_TOL and corr > BF16_CORR)
                ok = ok and out.shape == (B, n_views, 512) and bool(torch.isfinite(out).all())
                line = (f"decoder_basis {name} B={B} V={n_views}: max|kernel - plain f32| = {err:.3e} "
                        f"corr {corr:.7f} (max|kernel - plain {name}| = {err_same:.3e})")
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
    enc_stats = encoder_kernels(card, dev)

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

        # ------------------------------------------------------------- 5. train
        for name, n in train_phase(card, tmp).items():
            enc_stats[name]["launches"] = n

    # --------------------------------------------------------------- 6. summary
    kernels = [{
        "name": f"decoder_basis_{key}", "route": "cuda", "source": A1_SOURCE, "replaces": A1_REPLACES,
        "launches": st["launches"], "max_abs_err": st["max_abs_err"], "ms": st["ms"],
        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None,
    } for key, st in a1_stats.items()]
    for name, st in enc_stats.items():
        fwd = name.startswith("encoder_fwd")
        kernels.append({
            "name": name, "route": "cuda", "source": A2_SOURCE if fwd else A3_SOURCE,
            "replaces": A2_REPLACES if fwd else A3_REPLACES, "launches": st["launches"],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"], "library_ms": None,
        })
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
