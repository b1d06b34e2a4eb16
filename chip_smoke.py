"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero before the
result line:
  1. device  — a CUDA device is present; its name and power limit;
  2. build   — compile every CUDA kernel of the render path from csrc/;
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main path's widths (Nef-Net, 3 leads, theta_L=1, B=32,
               V=336 and V=11), float32 and bfloat16, timed with CUDA events;
  4. render  — the port's render entry point (`render.main`) on a generated
               synthetic corpus with a seeded random checkpoint, over the
               84-view grid, in float32 and bfloat16, through the kernel;
               launch counts read around that run; held against the same run
               with the plain decode;
  5. summary — one JSON line naming every kernel with its numbers.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
    reports = build.build(["decoder_basis"])
    build.load("decoder_basis")
    log("build", f"decoder_basis built in {time.time() - t0:.1f} s")
    for line in reports.get("decoder_basis", "").splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

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

    # --------------------------------------------------------------- 5. summary
    kernels = [{
        "name": f"decoder_basis_{key}", "route": "cuda", "source": A1_SOURCE, "replaces": A1_REPLACES,
        "launches": st["launches"], "max_abs_err": st["max_abs_err"], "ms": st["ms"],
        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None,
    } for key, st in a1_stats.items()]
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
