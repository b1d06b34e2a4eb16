"""Synthesis-from-scratch entry point: the latent workflow the reference only
implies (phase='gen' latents and gen_ecg, model_nefnet.py:140-141,196-218,
and a `latent_save_dir` config key, but no sampler, README.md:19-22).

    python -m electrocardio_panorama_tpu_torch.synth_cli export-latents --config-file CFG [--device cuda|cpu]
        -> encode the test split with phase='gen', save z1 / z2 / rois npz
           shards (latents_*.npz) into cfg.latent_save_dir
    python -m electrocardio_panorama_tpu_torch.synth_cli fit-prior --config-file CFG
        -> fit the Gaussian latent prior over the saved (or freshly encoded)
           latents -> latent_save_dir/prior.npz
    python -m electrocardio_panorama_tpu_torch.synth_cli generate --config-file CFG \
        [--n 8] [--views 24] [--out gen.npz] [--plot gen.png]
        -> sample the prior, decode under a viewpoint grid, save the waveforms
           (latent_save_dir/generated.npz by default)

The checkpoint is best_valid.pkl under output_dir/desc, or MODEL.resume.
Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from electrocardio_panorama_tpu_torch.cli import cfg_from_args
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.main import device_arg
from electrocardio_panorama_tpu_torch.models import build_model
from electrocardio_panorama_tpu_torch.synthesis import (
    GaussianLatentPrior,
    plot_panorama,
    synthesize_from_scratch,
    theta_grid,
)
from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer
from electrocardio_panorama_tpu_torch.utils import resolve_device, seed_everything


def _load_model(cfg, device):
    loaded = CheckPointer(os.path.join(cfg.output_dir, cfg.desc)).load(
        cfg.MODEL.resume or None, best_valid=not cfg.MODEL.resume)
    if loaded is None:
        raise FileNotFoundError("no checkpoint (train first, or set MODEL.resume)")
    params, bn_state, _, _ = loaded
    params = {k: v.to(device) for k, v in params.items()}
    return build_model(cfg), params, {k: v.to(device) for k, v in bn_state.items()}


def _test_loader(cfg, batch_size):
    return BeatLoader(build_dataset(cfg, "test"), batch_size, shuffle=False, drop_last=False, seed=cfg.seed)


@torch.no_grad()
def export_latents(cfg, max_batches=None, batch_size=8, device=None) -> int:
    model, params, _ = _load_model(cfg, resolve_device(device))
    out_dir = cfg.latent_save_dir
    os.makedirs(out_dir, exist_ok=True)
    dev = next(iter(params.values())).device
    n = 0
    for bi, batch in enumerate(_test_loader(cfg, batch_size)):
        if max_batches is not None and bi >= max_batches:
            break
        z1, z2 = model.encode(params, *(torch.as_tensor(batch[k], device=dev)
                                        for k in ("data", "input_theta", "rois")),
                              stop_before_reverse=True)
        np.savez(os.path.join(out_dir, f"latents_{bi:05d}.npz"),
                 z1=z1.cpu().numpy(), z2=z2.cpu().numpy(), rois=batch["rois"])
        n += z1.shape[0]
    print(f"exported {n} latents -> {out_dir}")
    return n


def fit_prior(cfg, max_batches=8, batch_size=8, loaded=None, device=None) -> str:
    """Fit the Gaussian prior over the latents export-latents saved
    (latent_save_dir/latents_*.npz), or, without them, over up to
    `max_batches` freshly encoded test batches."""
    shards = sorted(glob.glob(os.path.join(cfg.latent_save_dir, "latents_*.npz")))
    if shards:
        zs = [np.load(s) for s in shards]
        prior = GaussianLatentPrior.from_latents(np.concatenate([z["z1"] for z in zs]),
                                                 np.concatenate([z["z2"] for z in zs]), zs[0]["rois"][0])
        print(f"prior fitted from {len(shards)} exported shard(s) ({sum(len(z['z1']) for z in zs)} latents)")
    else:
        model, params, _ = loaded or _load_model(cfg, resolve_device(device))
        prior = GaussianLatentPrior.fit(model, params, iter(_test_loader(cfg, batch_size)),
                                        max_batches=max_batches)
        print(f"prior fitted from {max_batches} freshly encoded batch(es)")
    path = os.path.join(cfg.latent_save_dir, "prior.npz")
    prior.save(path)
    print(f"prior -> {path}")
    return path


def _grid_dims(n_views: int) -> tuple[int, int]:
    """Factor a view count into the most square (n_theta, n_phi) grid."""
    if n_views < 1:
        raise ValueError(f"--views must be >= 1, got {n_views}")
    for d in range(int(n_views**0.5), 0, -1):
        if n_views % d == 0:
            return d, n_views // d
    return 1, n_views


def generate(cfg, n=8, n_views=24, out_path=None, plot_path=None, seed=0, temperature=1.0,
             device=None) -> np.ndarray:
    loaded = _load_model(cfg, resolve_device(device))
    model, params, bn_state = loaded
    prior_path = os.path.join(cfg.latent_save_dir, "prior.npz")
    if not os.path.exists(prior_path):
        fit_prior(cfg, loaded=loaded)
    prior = GaussianLatentPrior.load(prior_path)
    nt, np_ = _grid_dims(n_views)
    views = theta_grid(nt, np_)
    ecg = synthesize_from_scratch(model, params, bn_state, prior, views, n=n, seed=seed,
                                  temperature=temperature).cpu().numpy()
    out_path = out_path or os.path.join(cfg.latent_save_dir, "generated.npz")
    rois = np.broadcast_to(prior.rois_template, (n, *prior.rois_template.shape))
    np.savez(out_path, ecg=ecg, views=views, rois=rois)
    print(f"generated {n} beats x {len(views)} views -> {out_path}")
    if plot_path:
        plot_panorama(ecg, rois, 0, plot_path, nt, np_)
        print(f"plot -> {plot_path}")
    return ecg


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="ECG synthesis from scratch (PyTorch/CUDA)")
    parser.add_argument("cmd", choices=["export-latents", "fit-prior", "generate"])
    parser.add_argument("--config-file", default="", metavar="FILE")
    device_arg(parser)
    parser.add_argument("--n", type=int, default=8)
    parser.add_argument("--views", type=int, default=24)
    parser.add_argument("--out", default=None)
    parser.add_argument("--plot", default=None)
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=None, help="sampling seed (default: cfg.seed)")
    parser.add_argument("opts", nargs="*", default=[], help="KEY VALUE overrides")
    # the command, the flags and the KEY VALUE overrides may come in any
    # order: older argparse takes an empty `opts` with the command otherwise
    args = parser.parse_intermixed_args(argv)
    cfg = cfg_from_args(args)
    seed_everything(cfg.seed)
    if args.cmd == "export-latents":
        export_latents(cfg, args.max_batches, device=args.device)
    elif args.cmd == "fit-prior":
        fit_prior(cfg, args.max_batches or 8, device=args.device)
    else:
        generate(cfg, args.n, args.views, args.out, args.plot,
                 seed=cfg.seed if args.seed is None else args.seed, temperature=args.temperature,
                 device=args.device)


if __name__ == "__main__":
    main()
