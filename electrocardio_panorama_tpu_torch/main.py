"""Training entry point.

    python -m electrocardio_panorama_tpu_torch.main --config-file configs/nef_net_synthetic.yml \
        [--device cuda|cpu] [KEY VALUE ...]

Trailing overrides as in the JAX package, e.g. `SOLVER.epochs 1
TPU.steps_per_epoch 2`. Runs on the card unless `--device cpu` is given.

Data parallelism, one process per device (the batch splits over the ranks):

    torchrun --nproc-per-node 4 -m electrocardio_panorama_tpu_torch.main \
        --config-file configs/nef_net_synthetic.yml TPU.mesh_shape "[4]"
"""

from __future__ import annotations

import os

from electrocardio_panorama_tpu_torch.cli import base_parser, cfg_from_args
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.parallel import ensure_initialized, local_batch_slice
from electrocardio_panorama_tpu_torch.training.solver import Solver
from electrocardio_panorama_tpu_torch.utils import resolve_device, seed_everything


def main(cfg, device=None) -> Solver:
    """Train per `cfg`; returns the Solver (its `history` holds each epoch's
    train losses and timings)."""
    device = resolve_device(device)
    ensure_initialized(device)  # under a launcher (torchrun) each process loads its slice of every batch
    proc_slice = local_batch_slice(cfg.DATA.batch_size)
    seed_everything(cfg.seed)
    os.makedirs(os.path.join(cfg.output_dir, cfg.desc), exist_ok=True)
    train_ds = build_dataset(cfg, phase="train")
    test_ds = build_dataset(cfg, phase="test")
    # reference DataLoader recipe: shuffle train, drop_last; weighted sampling
    # (num_samples=5000) when the dataset exposes weights (train_net.py:22-28)
    weights = (train_ds.get_label_weight()
               if cfg.DATA.weighted_sample and hasattr(train_ds, "get_label_weight") else None)
    train_dl = BeatLoader(train_ds, cfg.DATA.batch_size, shuffle=True, drop_last=True, seed=cfg.seed,
                          num_threads=cfg.DATA.num_workers, sample_weights=weights, process_slice=proc_slice)
    test_dl = BeatLoader(test_ds, cfg.DATA.batch_size, shuffle=False, drop_last=True, seed=cfg.seed + 1,
                         num_threads=cfg.DATA.num_workers, process_slice=proc_slice)
    solver = Solver(cfg, device=device)
    solver.train(train_dl, test_dl)
    return solver


def device_arg(parser):
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="default: cuda (fails when no GPU is present)")
    return parser


if __name__ == "__main__":
    args = device_arg(base_parser("ecg generation (PyTorch/CUDA)")).parse_args()
    cfg = cfg_from_args(args)
    print("Using config: ", cfg)
    main(cfg, device=args.device)
