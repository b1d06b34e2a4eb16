"""Readings that the limits of `correct` are set from, at a cell's own size,
in one process over many seeds:

    python3 portbench/controls.py --workload NAME --seeds 1,2,3 [--window 1]

For each seed one JSON line: `program`, the compared numbers of the program
against the plain reference (set-up's first steps, or the requests of a short
window at the cell's load); `control`, the same numbers of the reference
computed in the next precision below the configuration's (TF32 for float32
with TF32 off) put in the program's place; and for train cells `half_batch`,
the reference fed half of each batch, the mean taken over the rest, and
`loss_gaps_by_step`, each step's relative loss gap of the program and of the
control. The benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_controls(st, seed) -> dict:
    from portbench import compare
    from portbench.entries.train import FIRST_STEPS
    from portbench.reference import nefnet as ref

    import torch

    keys = ("data", "input_theta", "target_theta", "rois", "target_view")
    batches = [{k: torch.as_tensor(st.pool[i][k]).to(st.device) for k in keys} for i in range(FIRST_STEPS)]
    args = (st.cell.model, st.p0, st.s0)
    want = ref.train_steps(*args, batches, st.shuffles, seed, st.lead_num, st.lr)
    tf32 = ref.train_steps(*args, batches, st.shuffles, seed, st.lead_num, st.lr, tf32=True)
    half = ref.train_steps(*args, batches, st.shuffles, seed, st.lead_num, st.lr, rows=st.batch // 2)
    return {"control": compare.train_readings(tf32, want, st.p0, st.s0),
            "half_batch": compare.train_readings(half, want, st.p0, st.s0),
            "loss_gaps_by_step": {"program": compare.loss_gaps(st.first, want),
                                  "control": compare.loss_gaps(tf32, want)}}


def render_controls(st) -> dict:
    from portbench import compare
    from portbench.reference import nefnet as ref

    import torch

    views = torch.as_tensor(st.views, device=st.device)
    gap = 0.0
    for r in sorted(st.kept):
        b = st.pool[r % len(st.pool)]
        args = (st.cell.model, st.params, st.bn_state, b, views, st.cell.lead_num)
        gap = max(gap, compare.view_gap(ref.render(*args, tf32=True), ref.render(*args)))
    return {"control": {"view_gap": gap}}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--window", default=1.0, type=float)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    entry = importlib.import_module(f"portbench.entries.{cell.spec['entry']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        device = torch.device("cuda")
        params, bn_state = harness.make_weights(cell, seed, device)
        with tempfile.TemporaryDirectory(prefix="portbench-") as out_dir:
            ctx = harness.Context(cell, seed, device, harness.program_cfg(cell, seed, out_dir), params, bn_state)
            st = entry.setup(ctx)
            if cell.spec["entry"] == "render":
                entry.window(st, args.window)
                extra = render_controls(st)
            else:
                extra = train_controls(st, seed)
            program = entry.check(st)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": program, **extra,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del st, ctx, params, bn_state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
