"""Readings that the limits of `correct` are set from, for ST-MEM's ViT cells
(entry `classify_vit`), at a cell's own size, in one process over many seeds:

    python3 portbench/controls_stmem.py --workload NAME --seeds 1,2,3 [--attention plain|sdpa] [--window S]

For each seed one JSON line of the entry's readings (loss_gap, grad_gap,
update_gap), each as the worst over the first steps (`entries/classify_vit.py::
check`: every step restarted from the program's state before it), with the
readings of each step under `by_step`:

  program     the program against the plain reference (what `check` returns);
  control     the reference computed in TF32, the next precision below the
              configuration's float32 with TF32 off, in the program's place;
  half_batch  the reference fed the first half of each batch;
  lr_1.3, beta1_0.5, weight_decay_1e-4
              the reference's Adam at 1.3 times the cell's learning rate, at
              beta1 0.5, or with an L2 term of 1e-4: faults a wrong optimizer
              setting would make;
  chain       the program's state after the first steps against the
              reference run through them from the start (no restart).

`--attention` sets the program's attention for the run: 'plain' (the default
of ops/attention.py when SDPA_BACKENDS is empty) or 'sdpa' (every SDPA
backend allowed, so that the dispatcher's choice runs); `attention` in the
line is the program's ATTENTION counter after set-up. With `--window S` the
program also steps S seconds after set-up (`window`: records a second and
`ms_per_step`). The benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = {"lr_1.3": {"lr_scale": 1.3}, "beta1_0.5": {"beta1": 0.5}, "weight_decay_1e-4": {"weight_decay": 1e-4}}
ALL_SDPA = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def summary(by_step: list) -> dict:
    from portbench.entries import classify

    return {**classify.worst(by_step), "by_step": by_step}


def stmem_controls(st, entry) -> dict:
    from portbench import compare
    from portbench.reference import stmem as ref

    batches = entry.reference_batches(st)

    def reference_in_place(**kw):
        lr_scale = kw.pop("lr_scale", 1.0)
        return lambda st_, k, b: entry.reference_step(st_, k, b, lr=st_.lr * lr_scale, **kw)

    out = {"program": summary(entry.readings_by_step(st)),
           "control": summary(entry.readings_by_step(st, reference_in_place(tf32=True))),
           "half_batch": summary(entry.readings_by_step(st, reference_in_place(rows=st.batch // 2)))}
    for name, kw in FAULTS.items():
        out[name] = summary(entry.readings_by_step(st, reference_in_place(**kw)))
    whole = ref.train_steps(st.arch, st.trail[0]["params"], batches, st.lr)
    prog = {"losses": st.losses, "grads": st.trail[1]["grads"], "params": st.trail[-1]["params"], "bn_state": {}}
    chain = compare.train_readings(prog, whole, st.trail[0]["params"], {})
    out["chain"] = {k: chain[k] for k in entry.READINGS}
    out["chain"]["losses"] = {"program": st.losses[:, 0].tolist(), "reference": whole["losses"][:, 0].tolist()}
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--attention", default="plain", choices=["plain", "sdpa"])
    p.add_argument("--window", default=0.0, type=float)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from electrocardio_panorama_tpu_torch.ops import ATTENTION
    from electrocardio_panorama_tpu_torch.ops import attention as attention_ops
    from portbench import harness

    if not torch.cuda.is_available():
        print("controls_stmem: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    if cell.spec["entry"] != "classify_vit":
        print(f"controls_stmem: {args.workload} is not a classify_vit cell", file=sys.stderr)
        return 2
    attention_ops.SDPA_BACKENDS = ALL_SDPA if args.attention == "sdpa" else ()
    entry = importlib.import_module("portbench.entries.classify_vit")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        device = torch.device("cuda")
        ATTENTION.clear()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory(prefix="portbench-") as out_dir:
            ctx = harness.Context(cell, seed, device, harness.program_cfg(cell, seed, out_dir), None, None)
            st = entry.setup(ctx)
            extra = {"attention": dict(ATTENTION)}
            if args.window:
                w = entry.window(st, args.window)
                extra["window"] = {**w["metrics"], "ms_per_step": 1e3 * w["seconds"] / max(w["attempted"], 1),
                                   "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
            for name in ("solver", "opt", "params", "bn_state"):  # as `check` frees them
                delattr(st, name)
            torch.cuda.empty_cache()
            extra.update(stmem_controls(st, entry))
        print(json.dumps({"workload": args.workload, "seed": seed, "attention_form": args.attention, **extra,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del st, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
