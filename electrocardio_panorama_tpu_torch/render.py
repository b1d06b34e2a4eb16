"""Panorama rendering entry point (reference demo.ipynb as a CLI).

    python -m electrocardio_panorama_tpu_torch.render --config-file configs/nef_net_synthetic.yml \
        [--fused] [--device cuda|cpu] [--n-theta 7 --n-phi 12] \
        [--out output/.../all_theta_data.npz] [--plot sample0.png] [KEY VALUE ...]

Loads best_valid.pkl (or MODEL.resume), renders the dense viewpoint grid for
the test split in batches, saves the npz (rest_out + rois) and optionally a
panorama grid PNG. Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import os

import torch

from electrocardio_panorama_tpu_torch.cli import base_parser, cfg_from_args
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.models import build_model
from electrocardio_panorama_tpu_torch.parallel import ensure_initialized
from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator, plot_panorama, theta_grid
from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer
from electrocardio_panorama_tpu_torch.utils import resolve_device, seed_everything


def main(cfg, n_theta=7, n_phi=12, out_path=None, plot_path=None, max_batches=None,
         batch_size=2, use_fused=False, device=None, plain=False):
    device = resolve_device(device)
    ensure_initialized(device)  # a no-op without a launcher
    seed_everything(cfg.seed)
    ckpt = CheckPointer(os.path.join(cfg.output_dir, cfg.desc))
    loaded = ckpt.load(cfg.MODEL.resume or None, best_valid=not cfg.MODEL.resume)
    if loaded is None:
        raise FileNotFoundError("no checkpoint (train first, or set MODEL.resume)")
    params, bn_state, _, _ = loaded

    model = build_model(cfg)
    gen = PanoramaGenerator(
        model, params, bn_state, compute_dtype=getattr(torch, cfg.TPU.compute_dtype),
        use_fused=use_fused, device=device, plain=plain,
    )
    test_ds = build_dataset(cfg, phase="test")
    # demo.ipynb uses batch size 2 for rendering
    dl = BeatLoader(test_ds, batch_size, shuffle=False, drop_last=False, seed=cfg.seed)
    views = theta_grid(n_theta, n_phi)
    out_path = out_path or os.path.join(cfg.output_dir, cfg.desc, "all_theta_data.npz")
    rest_out, rois = gen.render_dataset(dl, views, out_path, max_batches=max_batches)
    print(f"rendered {rest_out.shape[0]} beats x {rest_out.shape[1]} views -> {out_path}")
    if plot_path and rest_out.shape[0]:
        plot_panorama(rest_out, rois, 0, plot_path, n_theta, n_phi)
        print(f"panorama grid -> {plot_path}")
    return rest_out, rois


if __name__ == "__main__":
    parser = base_parser("electrocardio panorama rendering (PyTorch/CUDA)")
    parser.add_argument("--n-theta", default=7, type=int)
    parser.add_argument("--n-phi", default=12, type=int)
    parser.add_argument("--out", default=None)
    parser.add_argument("--plot", default=None)
    parser.add_argument("--max-batches", default=None, type=int)
    parser.add_argument("--fused", action="store_true",
                        help="decode with the streamed-basis CUDA kernel")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="default: cuda (fails when no GPU is present)")
    args = parser.parse_args()
    cfg = cfg_from_args(args)
    main(cfg, args.n_theta, args.n_phi, args.out, args.plot, args.max_batches,
         use_fused=args.fused, device=args.device)
