"""Where the fused encoder's time goes on the card.

    python -m electrocardio_panorama_tpu_torch.profile_encoder [--batch-size 32] [--dtype float32 bfloat16]
        [--timeline]

Runs kernels A2 (the fused encoder forward, train form) and A3 (its
backward, `encoder_ckpt` tower) at Nef-Net's widths (3 leads) on seeded
random weights, inputs, dropout masks and cotangents. For each dtype it
prints one JSON line with
  * ms per launch of A2 and A3 (CUDA events over repeated launches);
  * A3's six sections (`encoder_fused.backward_section_ms`);
  * device ms per launch by kernel name (`torch.profiler`) for A2 and A3;
  * with --timeline, every kernel of one A3 launch in order: start and
    duration in microseconds.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from electrocardio_panorama_tpu_torch.models import init_nefnet
from electrocardio_panorama_tpu_torch.ops import angular_encode, full_f32, linear, roi_align_ramp
from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2
from electrocardio_panorama_tpu_torch.utils import resolve_device
from electrocardio_panorama_tpu_torch.utils.profiling import device_window

LEADS = 3


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


def inputs(B: int, dtype, device, seed: int = 1):
    """Weights, x, gate, ramp, masks and cotangents of one A2/A3 call."""
    L = LEADS
    rng = np.random.default_rng(seed)
    params, _ = init_nefnet(torch.Generator().manual_seed(seed), lead_num=L, device=device)
    pts = np.concatenate([[0], np.sort(rng.choice(np.arange(8, 504, 4), 6, replace=False)), [512]])
    rois = torch.tensor(np.broadcast_to(np.stack([pts[:-1], pts[1:]], 1), (B, 7, 2)).copy(),
                        dtype=torch.float32, device=device)
    thetas = torch.tensor(rng.uniform(-np.pi, np.pi, (B, L, 2)), dtype=torch.float32, device=device)
    with full_f32():
        gate = linear(angular_encode(thetas), params["mlp1.weight"], params["mlp1.bias"]).to(dtype)
    return {
        "w": {k: params[k].to(dtype) for k in a2.WEIGHT_KEYS.values()},
        "x": torch.tensor(rng.normal(0, 0.6, (B, L, 512)), dtype=dtype, device=device),
        "gate": gate,
        "ramp": roi_align_ramp(rois).to(dtype),
        "masks": tuple(m.to(dtype) for m in a2.draw_masks(torch.Generator(device=device).manual_seed(seed + 1),
                                                           B, L)),
        "dz1": torch.tensor(rng.normal(0, 1, (B, 128 * L, 128)), dtype=dtype, device=device),
        "dz2": torch.tensor(rng.normal(0, 1, (B, 896 * L, 32)), dtype=dtype, device=device),
    }


def profile(B: int, dtype, device, timeline: bool) -> dict:
    t = inputs(B, dtype, device)
    args = (t["w"], t["x"], t["gate"], t["ramp"], t["masks"])
    planes = a2.forward_cuda(*args, lead_num=LEADS)
    kept = {n: planes[n] for n in a2._KEEP["tower"]}

    def fwd():
        return a2.forward_cuda(*args, lead_num=LEADS)

    def bwd():
        return a2.backward_cuda(*args, kept, t["dz1"], t["dz2"], lead_num=LEADS, mode="tower")

    rec = {"dtype": str(dtype).removeprefix("torch."), "batch": B, "leads": LEADS,
           "a2_ms": cuda_ms(fwd, reps=20), "a3_ms": cuda_ms(bwd, reps=20),
           "a3_sections_ms": a2.backward_section_ms(*args, kept, t["dz1"], t["dz2"], lead_num=LEADS,
                                                     mode="tower")}
    for name, fn in (("a2", fwd), ("a3", bwd)):
        win = device_window(lambda: [fn() for _ in range(5)], 5, top=12)
        rec[f"{name}_device_ms_by_kernel"] = win["by_kernel"]
        rec[f"{name}_device_kernel_sum_ms"] = win["kernel_sum_ms"]
    if timeline:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            bwd()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        t0 = events[0].time_range.start if events else 0
        rec["a3_timeline_us"] = [[round(e.time_range.start - t0, 1), round(e.time_range.elapsed_us(), 1),
                                  e.name[:80]] for e in events]
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"], choices=["float32", "bfloat16"])
    p.add_argument("--timeline", action="store_true", help="every kernel of one A3 launch, in order")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile_encoder needs a CUDA device: the kernels have no CPU mode")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for name in args.dtype:
        rec = profile(args.batch_size, getattr(torch, name), device, args.timeline)
        rec["card"] = card
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
