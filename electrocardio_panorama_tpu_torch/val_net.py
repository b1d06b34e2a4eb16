"""Validation entry point (reference val_net.py:27-49).

    python -m electrocardio_panorama_tpu_torch.val_net --config-file ... [--epoch N] [--device cuda|cpu]

`--epoch -1` (the default) loads best_valid.pkl. Runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import os

from electrocardio_panorama_tpu_torch.cli import base_parser, cfg_from_args
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.main import device_arg
from electrocardio_panorama_tpu_torch.parallel import ensure_initialized, local_batch_slice
from electrocardio_panorama_tpu_torch.training.solver import Solver
from electrocardio_panorama_tpu_torch.utils import resolve_device, seed_everything


def main(cfg, epoch: int = -1, device=None) -> dict:
    device = resolve_device(device)
    ensure_initialized(device)  # under a launcher (torchrun) each process loads its slice of every batch
    proc_slice = local_batch_slice(cfg.DATA.batch_size)
    seed_everything(cfg.seed)
    os.makedirs(os.path.join(cfg.output_dir, cfg.desc), exist_ok=True)
    test_ds = build_dataset(cfg, phase="test")
    test_dl = BeatLoader(test_ds, cfg.DATA.batch_size, shuffle=False, drop_last=True, seed=cfg.seed + 1,
                         num_threads=cfg.DATA.num_workers, process_slice=proc_slice)
    return Solver(cfg, use_writer=False, device=device).val(test_dl, epoch=epoch)


if __name__ == "__main__":
    parser = device_arg(base_parser("ecg generation eval (PyTorch/CUDA)"))
    parser.add_argument("--epoch", default=-1, type=int)
    args = parser.parse_args()
    main(cfg_from_args(args), epoch=args.epoch, device=args.device)
