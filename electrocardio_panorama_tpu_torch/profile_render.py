"""Where the render path's time goes on the card.

    python -m electrocardio_panorama_tpu_torch.profile_render [--batches 4] [--batch-size 32]

Builds a synthetic corpus and a seeded random checkpoint in a temporary
directory, then renders the 84-view grid through the streamed-basis kernel in
float32 and bfloat16. For each dtype it prints one JSON line with
  * the host-clock split of a render batch by layer (host data, encode,
    basis planes, A1 decode), each timed up to a `torch.cuda.synchronize()`;
  * a `torch.profiler` window over the same batches: device time by kernel
    name and the device's busy share of the window.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch

from electrocardio_panorama_tpu_torch.config import load_cfg
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.models import build_model, init_nefnet
from electrocardio_panorama_tpu_torch.ops import angular_encode
from electrocardio_panorama_tpu_torch.ops.kernels import decoder_fused as a1
from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator, theta_grid
from electrocardio_panorama_tpu_torch.utils import resolve_device
from electrocardio_panorama_tpu_torch.utils.profiling import device_window

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def render_batch(gen: PanoramaGenerator, batch, views, clock=None):
    """One batch, layer by layer; `clock(layer)` is called after each layer."""
    tick = clock or (lambda name: None)
    latent = gen.encode(batch["data"], batch["input_theta"], batch["rois"])
    tick("encode")
    v = torch.as_tensor(views, device=gen.device)[None].expand(latent.shape[0], -1, -1)
    enc = angular_encode(v.to(gen.dtype), gen.model.theta_encoder_len)
    pad = (-enc.shape[1]) % gen.v_tile
    if pad:
        enc = torch.cat([enc, enc.new_zeros(enc.shape[0], pad, enc.shape[2])], dim=1)
    sd = gen._folded["w2"].dtype
    U = a1.basis_planes(gen._folded, latent).to(sd)
    ep = a1.basis_coeffs(enc).to(sd).float()
    tick("basis_planes")
    out = a1.decode_basis(U, ep, gen._folded)
    tick("a1_decode")
    return out


def profile_dtype(cfg, dtype: str, batches: int, batch_size: int, device) -> dict:
    from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer

    cfg.TPU.compute_dtype = dtype
    params, state, _, _ = CheckPointer(os.path.join(cfg.output_dir, cfg.desc)).load(best_valid=True)
    gen = PanoramaGenerator(build_model(cfg), params, state, compute_dtype=getattr(torch, dtype),
                            use_fused=True, device=device)
    loader = BeatLoader(build_dataset(cfg, "test"), batch_size, shuffle=False, drop_last=True,
                        seed=cfg.seed)
    views = theta_grid(7, 12)
    render_batch(gen, next(iter(loader)), views)  # warm-up: kernel build, cuDNN plans
    torch.cuda.synchronize()

    split, n = defaultdict(float), 0
    it = iter(loader)
    for _ in range(batches):
        t = time.perf_counter()
        batch = next(it)
        split["host_data"] += time.perf_counter() - t

        last = [time.perf_counter()]

        def clock(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            split[name] += now - last[0]
            last[0] = now

        render_batch(gen, batch, views, clock)
        n += 1

    batches_data = [b for _, b in zip(range(batches), iter(loader))]
    win = device_window(lambda: [render_batch(gen, b, views) for b in batches_data], n)
    return {
        "dtype": dtype, "batch": batch_size, "views": len(views), "batches": n,
        "host_ms_per_batch": {k: 1e3 * v / n for k, v in split.items()},
        "device_ms_per_batch_by_kernel": win["by_kernel"],
        "device_kernel_sum_ms_per_batch": win["kernel_sum_ms"],
        "device_busy_ms_per_batch": win["busy_ms"],
        "device_busy_share": win["busy_share"],
        "window_ms_per_batch": win["window_ms"],
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_cfg(os.path.join(REPO, "configs", "nef_net_synthetic.yml"),
                       ["output_dir", f"{tmp}/out", "DATA.synthetic_root", f"{tmp}/synth",
                        "DATA.synthetic_n_train", "2",
                        "DATA.synthetic_n_test", str(args.batch_size * (args.batches + 1))])
        from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer

        p0, s0 = init_nefnet(torch.Generator().manual_seed(cfg.seed), lead_num=cfg.DATA.lead_num)
        CheckPointer(os.path.join(cfg.output_dir, cfg.desc)).save("best_valid", params=p0, bn_state=s0)
        for dtype in ("float32", "bfloat16"):
            rec = profile_dtype(cfg, dtype, args.batches, args.batch_size, device)
            rec["card"] = card
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
