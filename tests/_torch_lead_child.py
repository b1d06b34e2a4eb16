"""One rank of the port's 4-process gloo run of lead tensor parallelism
(tests/test_torch_lead_parallel.py).

Launched by the parent test with RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT set, as torchrun sets them:

    _torch_lead_child.py DIR

reads DIR/inputs.npz (Nef-Net params at 12 leads with a batch of 2 and 8
views; params at 2 leads with a batch of 8) and, on meshes of the 4 ranks:
  * the lead-parallel panorama at 12 leads on (lead 2, view 2) and (lead 4);
  * one float32 3-axis step, dropout off, on (data 1, lead 2, view 2) and
    (data 2, lead 2, view 1), and one bfloat16 step on the first; the params
    and SGD momentum gathered back to full tensors;
  * a lead axis of 4 against lead_num 2 (the step) and 3 (the panorama).
Rank 0 writes DIR/port.npz.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

STEP_MESHES = ((1, 2, 2), (2, 2, 1))
PANORAMA_MESHES = {"lead2_view2": ((2, 2), ("lead", "view"), "view"), "lead4": ((4,), ("lead",), None)}
SHUFFLE = (1, 0)


def step_cfg(dtype: str = "float32"):
    """The JAX package's tests/test_sharding.py recipe: Nef-Net at 2 leads,
    loss factors (0.5, 0.5, 1), SGD at lr 0.01."""
    from electrocardio_panorama_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.model = "model_nefnet"
    cfg.DATA.lead_num = 2
    cfg.SOLVER.loss_factor = [0.5, 0.5, 1]
    cfg.SOLVER.lr = 0.01
    cfg.TPU.compute_dtype = dtype
    return cfg


def main():
    from electrocardio_panorama_tpu_torch.convert import to_tensor
    from electrocardio_panorama_tpu_torch.models import NefNetDef, build_model
    from electrocardio_panorama_tpu_torch.parallel import (
        build_3d_train_step,
        build_lead_parallel_panorama,
        ensure_initialized,
        gather_lead_params,
        make_mesh,
        process_count,
        process_index,
        shard_lead_params,
    )
    from electrocardio_panorama_tpu_torch.training.optim import get_optimizer

    assert ensure_initialized("cpu"), "the launcher's variables were not picked up"
    assert process_count() == 4, process_count()
    work = sys.argv[1]
    z = np.load(f"{work}/inputs.npz")
    load = lambda prefix: {k[len(prefix):]: to_tensor(z[k]) for k in z.files if k.startswith(prefix)}  # noqa: E731
    out = {}

    # the lead-parallel panorama, 12 leads
    p12, s12 = load("p12:"), load("s12:")
    inputs = [torch.tensor(z[f"pano:{k}"]) for k in ("data", "input_theta", "rois", "views")]
    for name, (shape, axes, view_axis) in PANORAMA_MESHES.items():
        mesh = make_mesh(shape, axes, device="cpu")
        render = build_lead_parallel_panorama(NefNetDef(12), mesh, view_axis=view_axis)
        out[f"pano:{name}"] = render(p12, s12, *inputs).numpy()
    mesh = make_mesh((4,), ("lead",), device="cpu")
    for name, build in (("panorama", lambda: build_lead_parallel_panorama(NefNetDef(3), mesh)),
                        ("step", lambda: build_3d_train_step(NefNetDef(2), step_cfg(), None, make_mesh(
                            (1, 4, 1), ("data", "lead", "view"), device="cpu")))):
        try:
            build()
            out[f"raised:{name}"] = np.array("")
        except ValueError as e:
            out[f"raised:{name}"] = np.array(str(e))

    # the 3-axis step, 2 leads, batch 8
    p2, s2 = load("p2:"), load("s2:")
    batch = {k[len("batch:"):]: z[k] for k in z.files if k.startswith("batch:")}
    for dtype, meshes in (("float32", STEP_MESHES), ("bfloat16", STEP_MESHES[:1])):
        cfg = step_cfg(dtype)
        for shape in meshes:
            mesh = make_mesh(shape, ("data", "lead", "view"), device="cpu")
            p = {k: v.requires_grad_(True) for k, v in shard_lead_params(p2, mesh, lead_num=2).items()}
            opt = get_optimizer(cfg, p)
            step = build_3d_train_step(build_model(cfg), cfg, opt, mesh, deterministic=True)
            new_bn, lvec = step(p, s2, epoch=0, step=0, i1=SHUFFLE[0], i2=SHUFFLE[1], batch=batch)
            tag = f"{dtype}:{'x'.join(map(str, shape))}"
            full = gather_lead_params(p, mesh)
            mom = gather_lead_params({k: opt.state[v].get("momentum_buffer", torch.zeros_like(v))
                                      for k, v in p.items()}, mesh)
            out[f"{tag}:loss"] = lvec.numpy()
            out[f"{tag}:local_rows"] = np.array(p["W_encoder.conv1.weight"].shape[0])
            out.update({f"{tag}:p:{k}": v.numpy() for k, v in full.items()})
            out.update({f"{tag}:m:{k}": v.numpy() for k, v in mom.items()})
            out.update({f"{tag}:s:{k}": v.numpy() for k, v in new_bn.items()})
    if process_index() == 0:
        np.savez(f"{work}/port.npz", **out)
    import torch.distributed as dist

    rank = process_index()
    dist.destroy_process_group()
    print(f"CHILD_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
