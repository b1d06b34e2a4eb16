"""The harness: finds a cell and everything it names by name, builds its inputs
from the seed, drives the cell's entry through set-up, the measured window
and (with --trace 1) a traced window, decides `correct` against the plain
reference, and assembles the result line.

Found by name, so that a later change adds files and BENCHMARK.json entries
and edits none:
  BENCHMARK.json               the cell (workloads), its metrics
  portbench/cells/<cell>.json  configuration, traffic, entry, dtype, knobs,
                               the limits of its compared numbers
  portbench/configs/<config>.json   the model configuration as run
  portbench/traffic/<traffic>.json  the traffic mix (traffic/generator.py)
  portbench/entries/<entry>.py      setup / window / check of the timed path
  portbench/counts/<config>.py      the configuration's operation counts
  portbench/metrics/<metric>.py     one reader per per-layer metric
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference import nefnet as ref
from portbench.traffic import generator

TRACE_SECONDS = 3.0  # length of the traced window of a --trace 1 run
FORBIDDEN = ("jax", "jaxlib", "flax", "electrocardio_panorama_tpu")


def read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class Cell:
    root: str
    name: str
    spec: dict        # portbench/cells/<name>.json
    workload: dict    # its BENCHMARK.json entry
    config: dict      # portbench/configs/<config>.json
    mix: dict         # portbench/traffic/<traffic>.json
    metrics: dict = field(default_factory=dict)  # {"end_to_end": [...], "per_layer": [...]} reported here

    @property
    def model(self) -> str:
        return self.config["settings"]["MODEL"]["model"]

    @property
    def lead_num(self) -> int:
        return self.config["settings"]["DATA"]["lead_num"]

    @property
    def dtype(self) -> str:
        return self.spec["dtype"]

    def data_cfg(self) -> dict:
        s = self.config["settings"]
        return {"lead_num": s["DATA"]["lead_num"], "super_mode": s["DATA"]["super_mode"],
                "train_data_mode": s["DATA"]["train_data_mode"], "jitter_factor": s["MODEL"]["jitter_factor"]}

    def counts(self):
        return importlib.import_module(f"portbench.counts.{self.spec['config']}")


def metrics_of(bench: dict, workload: str) -> dict:
    """The end-to-end and per-layer metrics this workload reports: those
    that list it under `workloads`, and those without the key (a per-layer
    metric without it is reported wherever the end-to-end metric it moves
    is)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if workload in m["workloads"] or ("workloads" not in m and m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per}


def load_cell(root: str, workload: str) -> Cell:
    bench = read_json(root, "BENCHMARK.json")
    wl = [w for w in bench["workloads"] if w["name"] == workload]
    if not wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    spec = read_json(root, "portbench", "cells", f"{workload}.json")
    if (spec["config"], spec["traffic"]) != (wl[0]["config"], wl[0]["traffic"]):
        raise ValueError(f"cell {workload}: its file and BENCHMARK.json name another config or traffic")
    return Cell(root, workload, spec, wl[0], read_json(root, "portbench", "configs", f"{spec['config']}.json"),
                generator.load_mix(root, spec["traffic"]), metrics_of(bench, workload))


def program_cfg(cell: Cell, seed: int, out_dir: str):
    """The program's config: its defaults, the configuration's settings, the
    cell's knobs, the run's seed and the traffic's batch."""
    from electrocardio_panorama_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_other(cell.config["settings"])
    cfg.merge_from_other(cell.spec.get("knobs", {}))
    cfg.seed = seed
    cfg.DATA.batch_size = cell.mix["batch"]
    cfg.output_dir = out_dir
    cfg.desc = "portbench"
    return cfg


def make_weights(cell: Cell, seed: int, device) -> tuple[dict, dict]:
    """(params, bn_state) from the seed, on the device, in two draws: one
    uniform buffer for the torch-default layers, the BatchNorm affines and
    running statistics, and one normal buffer for the ResNet tower. BatchNorm
    scales lie in [0.75, 1.25], offsets and running means in [-0.1, 0.1],
    running variances in [0.5, 1.5]."""
    table = ref.param_table(cell.model, cell.lead_num)
    stats = ref.bn_state_table()
    n_u = sum(int(np.prod(s)) for _, s, init, _ in table if init != "normal") + 2 * sum(c[0] for _, c in stats)
    n_n = sum(int(np.prod(s)) for _, s, init, _ in table if init == "normal")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0x3E16))
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
    dt = getattr(torch, cell.dtype)
    return {k: v.to(dt).requires_grad_(True) for k, v in params.items()}, \
        {k: v.to(dt) if v.is_floating_point() else v for k, v in bn.items()}


@dataclass
class Context:
    """What an entry gets: the cell, the run's seed, the device, the
    program's config and the weights made from the seed."""
    cell: Cell
    seed: int
    device: torch.device
    cfg: object
    params: dict
    bn_state: dict


def load_reader(root: str, metric: str):
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a per-layer reader reads: the cell, the measured window's
    counters ('seconds', 'attempted', 'failed', the entry's own) and the
    traced window's, and the trace."""
    cell: Cell
    window: dict
    traced: dict | None = None
    trace: object | None = None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of a cell; returns the result line's object."""
    imported = time.perf_counter() - t_start
    cell = load_cell(root, workload)
    device = torch.device(device)
    entry = importlib.import_module(f"portbench.entries.{cell.spec['entry']}")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="portbench-") as out_dir:
        params, bn_state = make_weights(cell, seed, device)
        ctx = Context(cell, seed, device, program_cfg(cell, seed, out_dir), params, bn_state)
        state = entry.setup(ctx)
        marks = [time.perf_counter()]
        setup_s = marks[0] - t_start
        window = entry.window(state, seconds)
        traced = tr = None
        if trace:
            from portbench import tracing

            traced, tr = tracing.device_window(tracing.timed(entry.window, state, TRACE_SECONDS))
        marks.append(time.perf_counter())
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        readings = entry.check(state)
        del state
        gc.collect()
        marks.append(time.perf_counter())
    print(f"portbench: {workload} set-up {setup_s:.3f} s ({imported:.3f} of it to import torch and the "
          f"harness), window{' and trace' if trace else ''} "
          f"{marks[1] - marks[0]:.3f} s, check {marks[2] - marks[1]:.3f} s", file=sys.stderr)
    limits = cell.spec["limits"]
    correct = all(name in readings and readings[name] <= limit for name, limit in limits.items())
    run = Run(cell, window, traced, tr)
    metrics = {}
    if trace:
        for m in cell.metrics["per_layer"]:
            v = load_reader(root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        measured = dict(window["metrics"], setup_s=setup_s, peak_mem_gib=peak / 2**30)
        for m in cell.metrics["end_to_end"]:
            if m["name"] not in measured:
                raise KeyError(f"entry {cell.spec['entry']!r} measures no {m['name']!r}")
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(window["attempted"]), "failed": int(window["failed"]),
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["check"] = {k: {"value": readings.get(k), "limit": v} for k, v in limits.items()}
    return out
