"""The classify entry: the window drives the program's `Solver.train_step`
(training/solver.py) on the 1-D ResNet classifier (MODEL.model
'model_resnet1d'), one call per step, on a pool of labelled batches made from
the seed, as `Solver.run_one_epoch` drives it.

The harness's `make_weights` draws Nef-Net's parameter table; this entry
draws the classifier's own from the seed instead (`make_weights`, the same
recipe over the reference's table) and leaves `ctx.params` unused.

Set-up builds the one Solver, its parameters and its SGD state, and drives
them through the first FIRST_STEPS steps, on the pool's first batches (rows
that all differ): those steps warm up every shape of the cell, and the
program's state before and after each of them (parameters, BatchNorm state,
the step's gradients) is what `check` holds against the plain reference
(reference/resnet1d.py). The same objects then go on into the window.

`check` restarts the reference from the program's state before each step and
compares that one step, so each step is read at the rounding of one step. A
run of several steps from one start cannot be read so: a relu input within
rounding of zero takes the other side on one of the two, the gradient jumps
there, and the learning rate carries that jump into the next step's weights,
so that after three steps the float32 reference stands 10-30% from itself in
float64 in the worst leaf of the update (PERF.md, section 6).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare
from portbench.harness import sub_seed
from portbench.reference import resnet1d as ref
from portbench.traffic import generator

FIRST_STEPS = 3
WEIGHTS, RECORDS, LABELS = 0x7E51, 0x7EC1, 0x1ABE  # sub_seed tags of the run's seed


class State:
    pass


def arch_of(config: dict) -> ref.Arch:
    """The reference's shape of the configuration's classifier."""
    m, d = config["settings"]["MODEL"], config["settings"]["DATA"]
    return ref.Arch(m["arch"], in_channel=d["in_channel"], num_classes=m["num_classes"], lead_num=d["lead_num"],
                    init_channels=config["widths"]["init_channels"])


def make_weights(a: ref.Arch, seed: int, device) -> tuple[dict, dict]:
    """(params, bn_state) from the seed, on the device, as the harness's
    make_weights draws Nef-Net's: one uniform buffer for the Linear head, the
    BatchNorm affines and running statistics, one normal buffer for the
    convolutions at the reference's scales. BatchNorm scales lie in [0.75,
    1.25], offsets and running means in [-0.1, 0.1], running variances in
    [0.5, 1.5]."""
    table, stats = ref.param_table(a), ref.bn_state_table(a)
    n_u = sum(int(np.prod(s)) for _, s, init, _ in table if init != "normal") + 2 * sum(c[0] for _, c in stats)
    n_n = sum(int(np.prod(s)) for _, s, init, _ in table if init == "normal")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    u = torch.rand(n_u, generator=gen, device=device, dtype=torch.float32) * 2 - 1
    z = torch.randn(n_n, generator=gen, device=device, dtype=torch.float32)
    iu = iz = 0
    params = {}
    for name, shape, init, scale in table:
        n = int(np.prod(shape))
        if init == "normal":
            params[name] = (z[iz:iz + n] * scale).reshape(shape).clone()
            iz += n
            continue
        v = u[iu:iu + n].reshape(shape)
        iu += n
        params[name] = (v * scale if init == "uniform" else 1.0 + 0.25 * v if init == "bn_weight" else 0.1 * v).clone()
    bn = {}
    for name, (c,) in stats:
        bn[f"{name}.running_mean"] = (0.1 * u[iu:iu + c]).clone()
        bn[f"{name}.running_var"] = (1.0 + 0.5 * u[iu + c:iu + 2 * c]).clone()
        bn[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
        iu += 2 * c
    return {k: v.requires_grad_(True) for k, v in params.items()}, bn


def labels(seed: int, n: int, num_classes: int, p: float) -> np.ndarray:
    """[n, num_classes] multi-hot int64 labels: each class at probability p,
    and one class drawn uniformly in a record where none came up."""
    rng = np.random.default_rng(sub_seed(seed, LABELS))
    y = (rng.random((n, num_classes)) < p).astype(np.int64)
    empty = np.flatnonzero(y.sum(axis=1) == 0)
    y[empty, rng.integers(0, num_classes, size=empty.size)] = 1
    return y


def pool(mix: dict, num_classes: int, seed: int) -> list[dict]:
    """mix['pool'] batches of mix['batch'] records, each row a record of its
    own (traffic/generator.py's synthetic Tianchi records, 8 leads x
    record_len samples, as float32 as the program's reader gives them) with
    its labels: {'data': [B, 8, T] float32, 'label': [B, C] int64}."""
    n = mix["batch"] * mix["pool"]
    recs = generator.records(sub_seed(seed, RECORDS), n, mix["record_len"])
    data = np.stack([r[0] for r in recs]).astype(np.float32)
    y = labels(seed, n, num_classes, mix["label_p"])
    return [{"data": data[b:b + mix["batch"]], "label": y[b:b + mix["batch"]]} for b in range(0, n, mix["batch"])]


def _step(st):
    st.bn_state, lvec = st.solver.train_step(st.params, st.bn_state, st.opt, epoch=0, step=st.step,
                                             batch=st.pool[st.step % len(st.pool)])
    st.step += 1
    return lvec


def _kept(st) -> dict:
    """The program's state as a step left it: parameters, BatchNorm state and
    that step's gradients (none before the first step)."""
    return {"params": {k: v.detach().clone() for k, v in st.params.items()},
            "bn_state": {k: v.clone() for k, v in st.bn_state.items()},
            "grads": {k: v.grad.clone() for k, v in st.params.items() if v.grad is not None}}


def setup(ctx):
    from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
    from electrocardio_panorama_tpu_torch.training.solver import Solver

    cell = ctx.cell
    st = State()
    st.cell, st.seed, st.device = cell, ctx.seed, ctx.device
    st.arch = arch_of(cell.config)
    st.batch, st.lr = cell.mix["batch"], float(ctx.cfg.SOLVER.lr)
    st.pool = pool(cell.mix, st.arch.num_classes, ctx.seed)
    st.solver = Solver(ctx.cfg, use_writer=False, device=ctx.device)
    st.params, st.bn_state = make_weights(st.arch, ctx.seed, ctx.device)
    st.opt = get_optimizer(ctx.cfg, st.params)
    st.step = 0
    st.trail, losses = [_kept(st)], []
    for _ in range(FIRST_STEPS):
        losses.append(_step(st))
        st.trail.append(_kept(st))
    st.losses = torch.stack(losses)
    _sync(st)
    return st


def _sync(st):
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def window(st, seconds: float) -> dict:
    """Steps until `seconds` have passed, then a synchronize: the rate is the
    window's records over its whole length."""
    _sync(st)
    t0 = time.perf_counter()
    n, dispatch, losses = 0, 0.0, []
    while True:
        a = time.perf_counter()
        if a - t0 >= seconds:
            break
        lvec = _step(st)
        dispatch += time.perf_counter() - a
        losses.append(lvec)
        n += 1
    _sync(st)
    t = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses)).all(dim=1)).sum()) if losses else 0
    return {"seconds": t, "attempted": n, "failed": failed, "dispatch_s": dispatch,
            "metrics": {"train_samples_per_s": n * st.batch / t}}


def reference_batches(st) -> list[dict]:
    """The first steps' batches as the reference takes them, on the device."""
    return [{"data": torch.as_tensor(b["data"]).to(st.device),
             "label": torch.as_tensor(b["label"]).to(st.device, torch.float32)} for b in st.pool[:FIRST_STEPS]]


def reference_step(st, k: int, batches: list, **kw) -> dict:
    """The reference's step k (0-based) from the program's state before it:
    its parameters and BatchNorm state, and SGD's momentum buffer made by the
    reference's rule from the program's earlier gradients. `kw` goes to
    `ref.train_steps` (lr, tf32, momentum, weight_decay, rows)."""
    before = st.trail[k]
    kw.setdefault("lr", st.lr)
    return ref.train_steps(st.arch, before["params"], before["bn_state"], [batches[k]], st.seed,
                           past_grads=[t["grads"] for t in st.trail[1:k + 1]], **kw)


def program_step(st, k: int, batches: list) -> dict:
    """What the program's step k produced, in the reference's form."""
    after = st.trail[k + 1]
    return {"losses": st.losses[k:k + 1], "grads": after["grads"], "params": after["params"],
            "bn_state": after["bn_state"]}


def readings_by_step(st, produced=program_step) -> list[dict]:
    """`compare.train_readings` of each first step: what `produced(st, k,
    batches)` gives against the reference's step from the same state."""
    batches = reference_batches(st)
    out = []
    for k in range(FIRST_STEPS):
        want = reference_step(st, k, batches)
        got = produced(st, k, batches)
        out.append(compare.train_readings(got, want, st.trail[k]["params"], st.trail[k]["bn_state"]))
        del want, got
    return out


def worst(by_step: list[dict]) -> dict:
    """Each compared number's largest reading over the steps."""
    return {name: max(r[name] for r in by_step) for name in by_step[0]}


def check(st) -> dict:
    """Free the program's objects, then hold each of the first steps to the
    reference's step from the same state, with the same batch and dropout
    rule."""
    for name in ("solver", "opt", "params", "bn_state"):
        delattr(st, name)
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    return worst(readings_by_step(st))
