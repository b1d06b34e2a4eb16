"""Where the train step's time goes on the card.

    python -m electrocardio_panorama_tpu_torch.profile_train [--steps 8] [--batch-size 32]
        [--train-decoder xla|fused]

Builds a synthetic corpus in a temporary directory and runs the Nef-Net
train step (training/solver.py) from a seeded init in float32 and bfloat16,
each with the fused encoder (kernels A2/A3) and with the eager one, with the
eager grouped decode or, under `--train-decoder fused`, the fused train
decoder (kernels A4f/A4b). For each it prints one JSON line with
  * the host-clock split of a step by layer (the loader assembling the
    batch, inputs to the device and the dropout masks, encode forward,
    decode forward + loss, decode backward, encode backward, optimizer),
    each layer timed up to a `torch.cuda.synchronize()`;
  * the unsynchronized step time over the same batches, and a
    `torch.profiler` window over them: device time by kernel name and the
    device's busy share of the window.
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
from electrocardio_panorama_tpu_torch.models import NefNetLatents
from electrocardio_panorama_tpu_torch.training.precision import cast_floats, cast_floats_f32
from electrocardio_panorama_tpu_torch.training.solver import Solver, step_seed
from electrocardio_panorama_tpu_torch.utils import resolve_device
from electrocardio_panorama_tpu_torch.utils.profiling import device_window

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split_step(solver: Solver, params, bn_state, opt, batch, step: int, clock):
    """Solver.train_step cut at its layers; `clock(layer)` after each. The
    encoder's outputs enter the decoder as leaves, so that the backward runs
    in two parts: decoder, then encoder."""
    cfg = solver.cfg
    data, it, tt, rois, tv, _ = solver._tensors(batch, ("data", "input_theta", "target_theta", "rois",
                                                        "target_view", "noise"))
    gen = torch.Generator(device=solver.device).manual_seed(step_seed(cfg.seed, 0, step))
    masks = solver.draw_masks(gen, data.shape[0])
    opt.zero_grad(set_to_none=True)
    clock("inputs_to_device_and_masks")
    held = {}

    def encode(p, x, input_thetas, rois_, *, masks=None, train=False):
        if solver._train_enc_fn is not None:
            lat = solver._train_enc_fn(p, x, input_thetas, rois_, masks=masks, train=train)
        else:
            lat = solver.model.encode(p, x, input_thetas, rois_, masks=masks, train=train)
        clock("encode_fwd")
        held["lat"] = lat
        held["leaves"] = [t.detach().requires_grad_(True) for t in lat]
        return NefNetLatents(*held["leaves"])

    with solver._precision():
        p = cast_floats(params, solver.compute_dtype) if solver.mixed else params
        if solver.mixed:
            data, it, tt = (t.to(solver.compute_dtype) for t in (data, it, tt))
        (out, sp, sl), new_bn = solver.model.apply(p, bn_state, data, it, tt, rois, phase="train", masks=masks,
                                                   shuffle_idx=(step % 3, (step + 1) % 3), encode_fn=encode,
                                                   train_decode_fn=solver._train_dec_fn)
        if solver.mixed:
            out, sp, sl = (t.float() for t in (out, sp, sl))
            new_bn = cast_floats_f32(new_bn)
        loss = solver.loss(out, sp, sl, tv[:, None, :], cfg)[0]
        clock("decode_fwd_loss")
        loss.backward()
        clock("decode_bwd")
        pairs = [(t, leaf.grad) for t, leaf in zip(held["lat"], held["leaves"]) if leaf.grad is not None]
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
        clock("encode_bwd")
    opt.step()
    clock("optimizer")
    return {k: v.detach() for k, v in new_bn.items()}


def profile(cfg, steps: int, device) -> dict:
    solver = Solver(cfg, use_writer=False, device=device)
    params, bn, opt = solver.init_state()
    loader = BeatLoader(build_dataset(cfg, "train"), cfg.DATA.batch_size, shuffle=True, drop_last=True,
                        seed=cfg.seed)
    t0 = time.perf_counter()
    batches = [b for _, b in zip(range(steps), loader)]
    loader_ms = 1e3 * (time.perf_counter() - t0) / steps
    for i, b in enumerate(batches[:2]):  # warm-up: kernel loads, cuDNN plans
        bn, _ = solver.train_step(params, bn, opt, epoch=0, step=i, i1=0, i2=1, batch=b)
    torch.cuda.synchronize()

    split = defaultdict(float)
    last = [time.perf_counter()]

    def clock(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[name] += now - last[0]
        last[0] = now

    for i, b in enumerate(batches):
        last[0] = time.perf_counter()
        bn = split_step(solver, params, bn, opt, b, i, clock)

    def run_all():
        nonlocal bn
        for i, b in enumerate(batches):
            bn, _ = solver.train_step(params, bn, opt, epoch=0, step=i, i1=i % 3, i2=(i + 1) % 3, batch=b)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_all()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps

    win = device_window(run_all, steps)
    return {
        "dtype": cfg.TPU.compute_dtype, "train_encoder": solver.train_encoder,
        "train_decoder": solver.train_decoder, "batch": cfg.DATA.batch_size,
        "steps": steps,
        "host_ms_per_step_synced": {"loader_batch": loader_ms, **{k: 1e3 * v / steps for k, v in split.items()}},
        "step_ms_unsynced": step_ms,
        "device_ms_per_step_by_kernel": win["by_kernel"],
        "device_kernel_sum_ms_per_step": win["kernel_sum_ms"],
        "device_busy_ms_per_step": win["busy_ms"],
        "device_busy_share": win["busy_share"],
        "window_ms_per_step": win["window_ms"],
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--train-decoder", default="xla", choices=["xla", "fused"],
                   help="TPU.train_decoder: the eager grouped decode, or kernels A4f/A4b")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            for enc in ("fused", "xla"):
                cfg = load_cfg(os.path.join(REPO, "configs", "nef_net_synthetic.yml"), [
                    "output_dir", f"{tmp}/out", "DATA.synthetic_root", f"{tmp}/synth",
                    "DATA.synthetic_n_train", str(args.batch_size * args.steps), "DATA.synthetic_n_test", "8",
                    "DATA.batch_size", str(args.batch_size), "TPU.compute_dtype", dtype,
                    "TPU.train_encoder", enc, "TPU.train_decoder", args.train_decoder])
                rec = profile(cfg, args.steps, device)
                rec["card"] = card
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
