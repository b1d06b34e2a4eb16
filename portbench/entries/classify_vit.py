"""The classify_vit entry: the window drives the program's `Solver.train_step`
(training/solver.py) on ST-MEM's ViT classifier (MODEL.model
'model_st_mem_vit'), one call per step, on a pool of labelled 12-lead
batches made from the seed, as `Solver.run_one_epoch` drives it.

The pool is the classify entry's (entries/classify.py::pool: the same
synthetic 8 x 5000 records and labels from the seed), each record made into
12 leads x 2,250 samples by `twelve_leads_250hz`, this entry's own copy of
the derivation the program's reader makes under DATA.cls_input
'12lead_250hz'. The weights are drawn from the seed over the reference's
table (`make_weights`); the harness's Nef-Net draw, `ctx.params`, is unused.

Set-up builds the one Solver, its parameters and its Adam state, and drives
them through the first FIRST_STEPS steps on the pool's first batches: those
steps warm up every shape of the cell, and the program's state before and
after each of them (parameters and the step's gradients) is what `check`
holds against the plain reference (reference/stmem.py). The same objects
then go on into the window (entries/classify.py::window). `check` restarts
the reference from the program's state before each step, Adam's moments
made by the reference's rule from the program's earlier gradients, and reads
the worst step: loss_gap, grad_gap and update_gap (compare.train_readings;
the model has no BatchNorm). It prints the program's ATTENTION counter, which
names the form each attention call ran.

A cell of dtype float64 runs weights and records in float64 through the same
code (the CPU tests' tiny cut, where float32 rounding would be read against
limits set at the published size).
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from portbench import compare
from portbench.entries import classify
from portbench.harness import sub_seed
from portbench.reference import stmem as ref

FIRST_STEPS = classify.FIRST_STEPS
READINGS = ("loss_gap", "grad_gap", "update_gap")
KEPT_SAMPLES = 4500  # the first 9 s of a 500 Hz record, taken at every second sample

window = classify.window


def arch_of(config: dict) -> ref.Arch:
    """The reference's shape of the configuration's encoder."""
    w = config["widths"]
    return ref.Arch(width=w["width"], depth=w["depth"], heads=w["heads"], dim_head=w["dim_head"],
                    mlp_dim=w["mlp_dim"], patch=w["patch"], leads=w["leads"], samples=w["samples"],
                    num_classes=w["num_classes"])


def twelve_leads_250hz(data8: np.ndarray) -> np.ndarray:
    """[8, 5000] (I, II, V1..V6 at 500 Hz) -> [12, 2250] float64 in the order
    I, II, III, aVR, aVL, aVF, V1..V6: III = II - I, aVR = -(I + II) / 2,
    aVL = I - II / 2, aVF = II - I / 2; every second sample of the first
    4,500; each lead standardized to mean 0 and standard deviation 1."""
    x = np.asarray(data8, dtype=np.float64)
    lead_1, lead_2 = x[0], x[1]
    limb = [lead_1, lead_2, lead_2 - lead_1, -(lead_1 + lead_2) / 2, lead_1 - lead_2 / 2, lead_2 - lead_1 / 2]
    x12 = np.stack(limb + list(x[2:8]))[:, :KEPT_SAMPLES:2]
    return (x12 - x12.mean(axis=1, keepdims=True)) / x12.std(axis=1, keepdims=True)


def pool(mix: dict, num_classes: int, seed: int, dtype=np.float32) -> list[dict]:
    """classify.pool's batches with every record made into 12 x 2250:
    {'data': [B, 12, 2250], 'label': [B, C] int64}."""
    if mix.get("layout") != "12lead_250hz":
        raise ValueError(f"classify_vit takes the 12lead_250hz layout, not {mix.get('layout')!r}")
    return [{"data": np.stack([twelve_leads_250hz(r) for r in b["data"]]).astype(dtype), "label": b["label"]}
            for b in classify.pool(mix, num_classes, seed)]


def make_weights(a: ref.Arch, seed: int, device, dtype=torch.float32) -> dict:
    """The parameters from the seed, on the device, in two draws as the
    classify entry makes its own: one uniform buffer for the Linear layers
    (torch's default bound) and the LayerNorm affines (scales in [0.75,
    1.25], offsets in [-0.1, 0.1]), one normal buffer for the embeddings."""
    table = ref.param_table(a)
    n_u = sum(int(np.prod(s)) for _, s, init, _ in table if init != "normal")
    n_n = sum(int(np.prod(s)) for _, s, init, _ in table if init == "normal")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, classify.WEIGHTS))
    u = torch.rand(n_u, generator=gen, device=device, dtype=torch.float32) * 2 - 1
    z = torch.randn(n_n, generator=gen, device=device, dtype=torch.float32)
    iu = iz = 0
    params = {}
    for name, shape, init, scale in table:
        n = int(np.prod(shape))
        if init == "normal":
            params[name] = (z[iz:iz + n] * scale).reshape(shape)
            iz += n
            continue
        v = u[iu:iu + n].reshape(shape)
        iu += n
        params[name] = v * scale if init == "uniform" else 1.0 + 0.25 * v if init == "ln_weight" else 0.1 * v
    return {k: v.to(dtype).clone().requires_grad_(True) for k, v in params.items()}


def setup(ctx):
    from electrocardio_panorama_tpu_torch.ops import ATTENTION
    from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
    from electrocardio_panorama_tpu_torch.training.solver import Solver

    cell = ctx.cell
    st = classify.State()
    st.cell, st.seed, st.device = cell, ctx.seed, ctx.device
    st.dtype = getattr(torch, cell.dtype)
    st.arch = arch_of(cell.config)
    st.batch, st.lr = cell.mix["batch"], float(ctx.cfg.SOLVER.lr)
    st.pool = pool(cell.mix, st.arch.num_classes, ctx.seed, np.dtype(cell.dtype))
    st.solver = Solver(ctx.cfg, use_writer=False, device=ctx.device)
    st.params, st.bn_state = make_weights(st.arch, ctx.seed, ctx.device, st.dtype), {}
    st.opt = get_optimizer(ctx.cfg, st.params)
    st.step = 0
    st.trail, losses = [classify._kept(st)], []
    for _ in range(FIRST_STEPS):
        losses.append(classify._step(st))
        st.trail.append(classify._kept(st))
    st.losses = torch.stack(losses)
    classify._sync(st)
    st.attention_setup = dict(ATTENTION)
    return st


def reference_batches(st) -> list[dict]:
    """The first steps' batches as the reference takes them, on the device."""
    return [{"data": torch.as_tensor(b["data"]).to(st.device),
             "label": torch.as_tensor(b["label"]).to(st.device, st.dtype)} for b in st.pool[:FIRST_STEPS]]


def reference_step(st, k: int, batches: list, **kw) -> dict:
    """The reference's step k (0-based) from the program's state before it:
    its parameters, and Adam's moments and step count made by the
    reference's rule from the program's earlier gradients. `kw` goes to
    `ref.train_steps` (lr, tf32, beta1, weight_decay, rows)."""
    kw.setdefault("lr", st.lr)
    return ref.train_steps(st.arch, st.trail[k]["params"], [batches[k]],
                           past_grads=[t["grads"] for t in st.trail[1:k + 1]], **kw)


def program_step(st, k: int, batches: list) -> dict:
    """What the program's step k produced, in the reference's form."""
    after = st.trail[k + 1]
    return {"losses": st.losses[k:k + 1], "grads": after["grads"], "params": after["params"], "bn_state": {}}


def readings_by_step(st, produced=program_step) -> list[dict]:
    """The compared numbers of each first step: what `produced(st, k,
    batches)` gives against the reference's step from the same state."""
    batches = reference_batches(st)
    out = []
    for k in range(FIRST_STEPS):
        want = reference_step(st, k, batches)
        got = produced(st, k, batches)
        r = compare.train_readings(got, want, st.trail[k]["params"], {})
        out.append({name: r[name] for name in READINGS})
        del want, got
    return out


def check(st) -> dict:
    """Free the program's objects, then hold each of the first steps to the
    reference's step from the same state and batch."""
    from electrocardio_panorama_tpu_torch.ops import ATTENTION

    print(f"classify_vit: ATTENTION after set-up {st.attention_setup}, after the window {dict(ATTENTION)}",
          file=sys.stderr)
    for name in ("solver", "opt", "params", "bn_state"):
        delattr(st, name)
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    return classify.worst(readings_by_step(st))
