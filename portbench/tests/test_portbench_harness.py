"""The harness on the CPU at a tiny size: a cell added as files plus a
BENCHMARK.json entry is found and run, the result line holds the contract's
keys, a run without a card or without the program fails, and each fault a
cell can have turns `correct` false. The control (the reference in TF32 in
the program's place) needs the card."""

import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2**33 + 19
TINY = {"train.tiny": {"batch": 2, "pool": 3, "phase": "train", "record_len": 5000},
        "render.tiny": {"batch": 2, "pool": 2, "phase": "test", "record_len": 5000, "n_theta": 2, "n_phi": 3}}
CELLS = {"nefnet.train.tiny": ("nefnet.train.f32.b85", "train.tiny"),
         "nefnet2.train.tiny": ("nefnet2.train.f32.b32", "train.tiny"),
         "nefnet.render.tiny": ("nefnet.render.f32.v336", "render.tiny")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with tiny cells added the way a later change adds one: new
    files under portbench/ and new entries in BENCHMARK.json."""
    r = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(r, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "electrocardio_panorama_tpu_torch"), os.path.join(r, "electrocardio_panorama_tpu_torch"))
    bench = harness.read_json(ROOT, "BENCHMARK.json")
    for name, mix in TINY.items():
        with open(os.path.join(r, "portbench", "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    for cell, (like, traffic) in CELLS.items():
        spec = dict(harness.read_json(ROOT, "portbench", "cells", f"{like}.json"), traffic=traffic)
        with open(os.path.join(r, "portbench", "cells", f"{cell}.json"), "w") as f:
            json.dump(spec, f)
        bench["workloads"].append(dict(next(w for w in bench["workloads"] if w["name"] == like), name=cell,
                                       traffic=traffic))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(r, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return r


def run(root, cell, trace=False):
    return harness.run_cell(root, cell, SEED, 0.5, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_added_cell_is_found_and_run(root, cell):
    out = run(root, cell)
    assert list(out) == CONTRACT_KEYS + ["check"]  # the compared numbers come last
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = harness.read_json(root, "BENCHMARK.json")
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want and "setup_s" in want
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in out["check"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name


def _cli(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "nefnet.train.f32.b85", "--seed",
                           str(SEED), "--seconds", "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure it")
    out = _cli(ROOT)
    assert out.returncode == 2 and not out.stdout.strip(), (out.returncode, out.stdout, out.stderr)
    assert "no CUDA device" in out.stderr


def test_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _cli(str(tmp_path))
    assert out.returncode != 0 and not out.stdout.strip()


def _unchanged_step(orig):
    def step(self, params, bn_state, opt, **kw):
        before = {k: v.detach().clone() for k, v in params.items()}
        _, lvec = orig(self, params, bn_state, opt, **kw)
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(before[k])
        return bn_state, lvec
    return step


def _half_batch_step(orig):
    def step(self, params, bn_state, opt, *, batch, **kw):
        half = {k: v[: len(v) // 2] for k, v in batch.items()}
        return orig(self, params, bn_state, opt, batch=half, **kw)
    return step


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step])
@pytest.mark.parametrize("cell", ["nefnet.train.tiny", "nefnet2.train.tiny"])
def test_a_broken_train_step_is_not_correct(root, cell, fault, monkeypatch):
    from electrocardio_panorama_tpu_torch.training.solver import Solver

    monkeypatch.setattr(Solver, "train_step", fault(Solver.train_step))
    out = run(root, cell)
    assert out["correct"] is False, out["check"]


def test_an_altered_view_is_not_correct(root, monkeypatch):
    from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator

    orig = PanoramaGenerator.render

    def render(self, *a):
        out = orig(self, *a)
        out[0, 0, 100] += 1e-3  # one sample of one view, where it is produced
        return out

    monkeypatch.setattr(PanoramaGenerator, "render", render)
    out = run(root, "nefnet.render.tiny")
    assert out["correct"] is False, out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["nefnet.train.f32.b85", "nefnet2.train.f32.b32", "nefnet.render.f32.v336"])
def test_control_in_tf32_is_not_correct(cell):
    """The reference in TF32 in the program's place fails the cell's limits,
    at the cell's own size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    import tempfile

    from portbench import controls

    c = harness.load_cell(ROOT, cell)
    entry = importlib.import_module(f"portbench.entries.{c.spec['entry']}")
    dev = torch.device("cuda")
    params, bn_state = harness.make_weights(c, SEED, dev)
    with tempfile.TemporaryDirectory() as d:
        st = entry.setup(harness.Context(c, SEED, dev, harness.program_cfg(c, SEED, d), params, bn_state))
        if c.spec["entry"] == "render":
            entry.window(st, 1.0)
            got = controls.render_controls(st)["control"]
        else:
            got = controls.train_controls(st, SEED)["control"]
    limits = c.spec["limits"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)


@pytest.mark.parametrize("cell", ["nefnet.train.f32.b85", "nefnet2.train.f32.b32", "nefnet.render.f32.v336"])
def test_every_per_layer_reader_reads_a_trace(cell):
    """Each per-layer metric of the cell has a reader that reads a trace of
    the cell's shapes; with no trace, the device readers read nothing."""
    from portbench.tracing import OP_PREFIX, Trace

    c = harness.load_cell(ROOT, cell)
    # 3 ms a launch of each train kernel, 20 ms of A1: above every bound
    ops = {OP_PREFIX + op: (0.3, 100) for op in ("encoder_fwd", "encoder_bwd", "decoder_train_fwd",
                                                   "decoder_train_bwd")}
    ops[OP_PREFIX + "decoder_basis"] = (2.0, 100)
    trace = Trace(window_s=12.0, busy_s=10.0, device_s=10.0, by_kernel={"k": 10.0}, ops=ops)
    window = {"seconds": 10.0, "attempted": 400, "failed": 0, "dispatch_s": 4.0}
    run = harness.Run(c, window, {"seconds": 3.0, "attempted": 100, "failed": 0, "dispatch_s": 1.0}, trace)
    assert c.metrics["per_layer"]
    for m in c.metrics["per_layer"]:
        v = harness.load_reader(ROOT, m["name"])(run)
        assert isinstance(v, float) and v > 0, m["name"]
        if m["unit"] == "%":
            assert v <= 100, (m["name"], v)
    bare = harness.Run(c, window)
    for m in c.metrics["per_layer"]:
        if m["source"] == "device_trace":
            assert harness.load_reader(ROOT, m["name"])(bare) is None, m["name"]
