"""The train entry: the window drives the program's `Solver.train_step`
(training/solver.py), one call per step, on a pool of batches made from the
seed, as `Solver.run_one_epoch` drives it.

Set-up builds the one Solver, its parameters and its SGD state, and drives
them through the first FIRST_STEPS steps, on the pool's first batches (rows
that all differ): those steps warm up every shape of the cell, and what they
produce is what `check` holds against the plain reference. The same objects
then go on into the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare
from portbench.reference import nefnet as ref
from portbench.traffic import generator

FIRST_STEPS = 3


class State:
    pass


def _shuffle_stream(seed: int):
    """The standin shuffle's lead indices, two a step, from the program's
    per-epoch host stream (Solver.run_one_epoch's rule, epoch 0)."""
    return np.random.default_rng(np.random.SeedSequence([seed, 0, 0x5EED]))


def _step(st):
    i1, i2 = int(st.rng.integers(0, st.lead_num)), int(st.rng.integers(0, st.lead_num))
    st.bn_state, lvec = st.solver.train_step(st.params, st.bn_state, st.opt, epoch=0, step=st.step, i1=i1,
                                             i2=i2, batch=st.pool[st.step % len(st.pool)])
    st.step += 1
    return lvec, (i1, i2)


def setup(ctx):
    from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
    from electrocardio_panorama_tpu_torch.training.solver import Solver

    cell = ctx.cell
    st = State()
    st.cell, st.seed, st.device = cell, ctx.seed, ctx.device
    st.lead_num, st.batch, st.lr = cell.lead_num, cell.mix["batch"], float(ctx.cfg.SOLVER.lr)
    st.pool = generator.pool(cell.mix, cell.data_cfg(), ctx.seed)
    st.solver = Solver(ctx.cfg, use_writer=False, device=ctx.device)
    st.params, st.bn_state = ctx.params, ctx.bn_state
    st.opt = get_optimizer(ctx.cfg, st.params)
    st.rng, st.step = _shuffle_stream(ctx.seed), 0
    st.p0 = {k: v.detach().clone() for k, v in st.params.items()}
    st.s0 = {k: v.clone() for k, v in st.bn_state.items()}
    losses, st.shuffles = [], []
    for k in range(FIRST_STEPS):
        lvec, sh = _step(st)
        losses.append(lvec)
        st.shuffles.append(sh)
        if k == 0:  # SGD's momentum buffer after one step is the first gradient
            st.grads = {n: st.opt.state[p]["momentum_buffer"].clone() for n, p in st.params.items()
                        if "momentum_buffer" in st.opt.state.get(p, {})}
    st.first = {"losses": torch.stack(losses), "grads": st.grads,
                "params": {k: v.detach().clone() for k, v in st.params.items()},
                "bn_state": {k: v.clone() for k, v in st.bn_state.items()}}
    _sync(st)
    return st


def _sync(st):
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def window(st, seconds: float) -> dict:
    """Steps until `seconds` have passed, then a synchronize: the rate is the
    window's beats over its whole length."""
    _sync(st)
    t0 = time.perf_counter()
    n, dispatch, losses = 0, 0.0, []
    while True:
        a = time.perf_counter()
        if a - t0 >= seconds:
            break
        lvec, _ = _step(st)
        dispatch += time.perf_counter() - a
        losses.append(lvec)
        n += 1
    _sync(st)
    t = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses)).all(dim=1)).sum()) if losses else 0
    return {"seconds": t, "attempted": n, "failed": failed, "dispatch_s": dispatch,
            "metrics": {"train_samples_per_s": n * st.batch / t}}


def check(st) -> dict:
    """Free the program's state, then run the reference from the same
    weights, BN state, batches, shuffles and dropout rule over the first
    steps, and compare."""
    first, p0, s0 = st.first, st.p0, st.s0
    for name in ("solver", "opt", "params", "bn_state"):
        delattr(st, name)
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    keys = ("data", "input_theta", "target_theta", "rois", "target_view")
    batches = [{k: torch.as_tensor(st.pool[i][k]).to(st.device) for k in keys} for i in range(FIRST_STEPS)]
    want = ref.train_steps(st.cell.model, p0, s0, batches, st.shuffles, st.seed, st.lead_num, st.lr)
    return compare.train_readings(first, want, p0, s0)
