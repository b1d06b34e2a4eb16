"""One rank of the port's 2-process gloo runs (tests/test_torch_parallel.py).

Launched by the parent test with RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT set, as torchrun sets them:

    _torch_dist_child.py train OUT SYNTH
        the real entry point, main.main, under TPU.mesh_shape [2]: the
        launcher's group -> local_batch_slice loaders -> the dp Solver ->
        rank 0's pickle checkpoints;
    _torch_dist_child.py step_render DIR
        reads DIR/inputs.npz (params, BN state, a global batch of 8, views),
        runs one dp Solver.train_step with dropout off and the view-sharded
        panorama on a (1, 2) mesh, eager and fused; rank 0 writes
        DIR/port.npz.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from electrocardio_panorama_tpu_torch.config import get_cfg

BATCH = 8
SHUFFLE = (2, 1)


def make_cfg(output_dir: str, synth_root: str, mesh_shape=(2,)):
    """The shared parent/child recipe: 1 epoch of 2 steps at a global batch
    of 8, then an eval epoch over 16 test beats."""
    cfg = get_cfg()
    cfg.desc = "mh"
    cfg.DATA.dataset = "synthetic"
    cfg.DATA.synthetic_n_train = 16
    cfg.DATA.synthetic_n_test = 16
    cfg.DATA.lead_num = 3
    cfg.DATA.super_mode = "IIv2v5_v4I_372"
    cfg.DATA.train_data_mode = "input_fix"
    cfg.DATA.batch_size = BATCH
    cfg.DATA.num_workers = 0
    cfg.MODEL.model = "model_nefnet"
    cfg.SOLVER.epochs = 1
    cfg.SOLVER.lr = 0.05
    cfg.SOLVER.loss_factor = [0.5, 0.5, 1]
    cfg.TPU.steps_per_epoch = 2
    cfg.TPU.mesh_shape = list(mesh_shape)
    cfg.DATA.synthetic_root = synth_root
    cfg.output_dir = output_dir
    return cfg


def step_render(work: str) -> None:
    from electrocardio_panorama_tpu_torch.models import build_model
    from electrocardio_panorama_tpu_torch.parallel import build_sharded_panorama, local_batch_slice, make_mesh
    from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
    from electrocardio_panorama_tpu_torch.training.solver import Solver

    z = np.load(f"{work}/inputs.npz")
    params = {k[2:]: torch.tensor(z[k]) for k in z.files if k.startswith("p:")}
    state = {k[2:]: torch.tensor(z[k]) for k in z.files if k.startswith("s:")}
    batch = {k[2:]: z[k] for k in z.files if k.startswith("b:")}
    cfg = make_cfg(f"{work}/out", f"{work}/synth")
    cfg.desc = "debug"
    cfg.SOLVER.lr = 0.01

    solver = Solver(cfg, use_writer=False, device="cpu")
    solver.draw_masks = lambda gen, b: None  # dropout off: the JAX step's deterministic=True
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = get_optimizer(cfg, p)
    rows = local_batch_slice(BATCH)
    local = {k: v[rows] for k, v in batch.items() if k != "views"}
    new_bn, lvec = solver.train_step(p, state, opt, epoch=0, step=0, i1=SHUFFLE[0], i2=SHUFFLE[1], batch=local)

    mesh = make_mesh((1, 2), ("data", "view"), device="cpu")
    views = {}
    for fused in (False, True):
        render = build_sharded_panorama(build_model(cfg), mesh, use_fused=fused)
        views[fused] = render(params, state, *(torch.tensor(batch[k]) for k in
                                               ("data", "input_theta", "rois", "views")))
    if rows.start == 0:
        np.savez(f"{work}/port.npz", loss=lvec.numpy(), eager=views[False].numpy(), fused=views[True].numpy(),
                 **{f"p:{k}": v.detach().numpy() for k, v in p.items()},
                 **{f"s:{k}": v.numpy() for k, v in new_bn.items()})


def main():
    from electrocardio_panorama_tpu_torch.parallel import ensure_initialized, process_count, process_index

    assert ensure_initialized("cpu"), "the launcher's variables were not picked up"
    assert process_count() == 2, process_count()
    mode = sys.argv[1]
    if mode == "train":
        from electrocardio_panorama_tpu_torch import main as train_main

        train_main.main(make_cfg(sys.argv[2], sys.argv[3]), device="cpu")
    elif mode == "step_render":
        step_render(sys.argv[2])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    import torch.distributed as dist

    rank = process_index()
    dist.destroy_process_group()
    print(f"CHILD_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
