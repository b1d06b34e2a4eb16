"""Readings that the limits of `correct` are set from, for the classifier's
cells (entry `classify`), at a cell's own size, in one process over many
seeds:

    python3 portbench/controls_classify.py --workload NAME --seeds 1,2,3 [--float64] [--witness]

For each seed one JSON line of `compare.train_readings` numbers, each as the
worst over the first steps (`entries/classify.py::check`: every step is
restarted from the program's state before it) with the readings of each step
under `by_step`:

  program     the program against the plain reference (what `check` returns);
  control     the reference computed in the next precision below the
              configuration's (TF32 for float32 with TF32 off) in the
              program's place;
  half_batch  the reference fed the first half of each batch;
  lr_1.3, momentum_0.5, weight_decay_1e-4
              the reference with the learning rate 1.3 times the cell's,
              SGD's momentum at 0.5, or an L2 term of 1e-4: faults a wrong
              optimizer setting would make;
  chain       the program's state after the first steps against the
              reference run through them from the start (no restart), with
              the three worst leaves of the update and of the running
              statistics and each side's losses.

With --float64, `float64`: the float32 reference against the reference in
float64, restarted per step as `check` does, and run through the first steps
from the start (`float64_chain`, with its worst leaves): how far rounding
alone moves each number. With --witness, `relu_witness`: the first step's
gradient of the float32 reference against float64's, once with its own relu
decisions and once with float64's (how many relu inputs take the other side
of zero, and what that does to the gradient). Both are slow on the card.
The benchmark's own runs never run this; controls.py serves the Nef-Net
cells.
"""

import argparse
import contextlib
import importlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = {"lr_1.3": {"lr_scale": 1.3}, "momentum_0.5": {"momentum": 0.5}, "weight_decay_1e-4": {"weight_decay": 1e-4}}


def leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """The three worst leaves of `compare.worst_norm_gap`, as [name, gap,
    the reference's norm of the leaf, the median leaf's]."""
    import torch

    from portbench import compare

    keys = list(keys)
    r = compare.norms({k: ref[k] for k in keys})
    p = compare.norms({k: prog[k] for k in keys})
    med = float(torch.tensor(sorted(r.values())).median())
    gaps = sorted(((abs(p[k] - r[k]) / max(r[k], med, 1e-30), k) for k in keys), reverse=True)
    return [[k, g, r[k], med] for g, k in gaps[:3]]


def chain_readings(prog: dict, ref: dict, p0: dict, s0: dict) -> dict:
    """compare.train_readings over a run from one start, with the worst
    leaves of the update and of the running statistics."""
    from portbench import compare

    out = compare.train_readings(prog, ref, p0, s0)
    moving = compare.moving_leaves(ref["grads"])
    stats = [k for k, v in s0.items() if v.is_floating_point()]
    out["update_leaves"] = leaf_gaps({k: prog["params"][k] - p0[k] for k in moving},
                                     {k: ref["params"][k] - p0[k] for k in moving}, moving)
    out["bn_leaves"] = leaf_gaps({k: prog["bn_state"][k] - s0[k] for k in stats},
                                 {k: ref["bn_state"][k] - s0[k] for k in stats}, stats)
    return out


def summary(by_step: list) -> dict:
    from portbench.entries import classify

    return {**classify.worst(by_step), "by_step": by_step}


def f64(tree: dict) -> dict:
    return {k: v.double() if v.is_floating_point() else v for k, v in tree.items()}


@contextlib.contextmanager
def relu_decisions(record: list, given=None):
    """torch's relu as z * (z > 0), each call's decision appended to
    `record`; with `given`, the decisions are taken from it in call order."""
    import torch.nn.functional as F

    orig = F.relu

    def relu(z, inplace=False):
        keep = (z.detach() > 0) if given is None else given[len(record)]
        record.append(z.detach() > 0)
        return z * keep

    F.relu = relu
    try:
        yield
    finally:
        F.relu = orig


def relu_witness(st, batches) -> dict:
    """The first step's gradient of the float32 reference against float64's
    (`grad_gap`), with its own relu decisions and with float64's."""
    import torch

    from portbench import compare
    from portbench.reference import resnet1d as ref

    def grads(params, state, batch, record, given=None):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        s = {k: v.clone() for k, v in state.items()}
        masks = ref.dropout_masks(st.arch, st.seed, 0, 0, batch["data"].shape[0], batch["data"].shape[-1],
                                  st.device)
        masks = [m.to(batch["data"].dtype) for m in masks]
        with ref.matmul_precision(False), relu_decisions(record, given):
            loss = ref.bce(ref.forward(st.arch, p, s, batch["data"], masks, train=True), batch["label"])
            g = torch.autograd.grad(loss, list(p.values()))
        return dict(zip(p, g))

    p0, s0 = st.trail[0]["params"], st.trail[0]["bn_state"]
    wide_rec, own_rec, pinned_rec = [], [], []
    wide = grads(f64(p0), f64(s0), f64(batches[0]), wide_rec)
    own = grads(p0, s0, batches[0], own_rec)
    pinned = grads(p0, s0, batches[0], pinned_rec, given=wide_rec)
    flipped = sum(int((a != b).sum()) for a, b in zip(own_rec, wide_rec))
    out = {"relu_inputs": sum(r.numel() for r in wide_rec), "flipped": flipped,
           "grad_gap_own": compare.worst_norm_gap(f64(own), wide, wide),
           "grad_gap_float64_decisions": compare.worst_norm_gap(f64(pinned), wide, wide),
           "own_leaves": leaf_gaps(f64(own), wide, wide), "pinned_leaves": leaf_gaps(f64(pinned), wide, wide)}
    del wide, own, pinned, wide_rec, own_rec, pinned_rec
    return out


def classify_controls(st, float64: bool, witness: bool) -> dict:
    import torch

    from portbench import compare
    from portbench.reference import resnet1d as ref

    entry = st.entry
    batches = entry.reference_batches(st)

    def reference_in_place(**kw):
        lr_scale = kw.pop("lr_scale", 1.0)
        return lambda st_, k, b: entry.reference_step(st_, k, b, lr=st_.lr * lr_scale, **kw)

    out = {"program": summary(entry.readings_by_step(st)),
           "control": summary(entry.readings_by_step(st, reference_in_place(tf32=True))),
           "half_batch": summary(entry.readings_by_step(st, reference_in_place(rows=st.batch // 2)))}
    for name, kw in FAULTS.items():
        out[name] = summary(entry.readings_by_step(st, reference_in_place(**kw)))
    p0, s0 = st.trail[0]["params"], st.trail[0]["bn_state"]
    whole = ref.train_steps(st.arch, p0, s0, batches, st.seed, st.lr)
    prog = {"losses": st.losses, "grads": st.trail[1]["grads"], "params": st.trail[-1]["params"],
            "bn_state": st.trail[-1]["bn_state"]}
    out["chain"] = chain_readings(prog, whole, p0, s0)
    out["chain"]["losses"] = {"program": st.losses[:, 0].tolist(), "reference": whole["losses"][:, 0].tolist()}
    if float64:
        def wide_step(st_, k, b):
            before = st_.trail[k]
            return ref.train_steps(st_.arch, f64(before["params"]), f64(before["bn_state"]), [f64(b[k])], st_.seed,
                                   st_.lr, past_grads=[f64(t["grads"]) for t in st_.trail[1:k + 1]])

        def as_f64(d):
            return {"losses": d["losses"].double(), "grads": f64(d["grads"]), "params": f64(d["params"]),
                    "bn_state": f64(d["bn_state"])}

        by_step = []
        for k in range(entry.FIRST_STEPS):
            before = st.trail[k]
            ours = as_f64(entry.reference_step(st, k, batches))
            by_step.append(compare.train_readings(ours, wide_step(st, k, batches), f64(before["params"]),
                                                  f64(before["bn_state"])))
        out["float64"] = summary(by_step)
        wide = ref.train_steps(st.arch, f64(p0), f64(s0), [f64(b) for b in batches], st.seed, st.lr)
        out["float64_chain"] = chain_readings(as_f64(whole), wide, f64(p0), f64(s0))
        del wide
    del whole
    torch.cuda.empty_cache()
    if witness:
        out["relu_witness"] = relu_witness(st, batches)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--float64", action="store_true")
    p.add_argument("--witness", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("controls_classify: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    if cell.spec["entry"] != "classify":
        print(f"controls_classify: {args.workload} is not a classify cell (portbench/controls.py)", file=sys.stderr)
        return 2
    entry = importlib.import_module("portbench.entries.classify")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        device = torch.device("cuda")
        with tempfile.TemporaryDirectory(prefix="portbench-") as out_dir:
            ctx = harness.Context(cell, seed, device, harness.program_cfg(cell, seed, out_dir), None, None)
            st = entry.setup(ctx)
            st.entry = entry
            for name in ("solver", "opt", "params", "bn_state"):  # as `check` frees them
                delattr(st, name)
            torch.cuda.empty_cache()
            extra = classify_controls(st, args.float64, args.witness)
        print(json.dumps({"workload": args.workload, "seed": seed, **extra,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del st, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
