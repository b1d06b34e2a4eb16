"""The port's spans (utils/profiling.py) on the CPU, at a tiny size.

  * off (no profiler, no `recording()`), a span records nothing, and a
    train step with recording on is bit for bit the step with it off;
  * the train step records ecgpan.train_step and its four phases under one
    root id, each inside its parent, the phases covering the root less its
    self time; the render records ecgpan.render > ecgpan.encode,
    ecgpan.basis_planes, and on the CPU no device time;
  * the spans sit on the profiler's clock: under torch.profiler the forward
    span encloses the forward's convolutions and the backward span the
    autograd engine's events, placed by trace_start_ns + time_range; the
    profiler holds no event of a span;
  * the profiler check reads true inside a session and false outside;
  * the buffer keeps at most MAX_SPANS spans and counts the rest;
  * a `main` run with TPU.profile_dir merges the spans into its chrome trace
    on their threads, prints the span summary and empties the recorder.
"""

import json
import os

import numpy as np
import pytest
import torch

from electrocardio_panorama_tpu_torch import main as train_main
from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.models import build_model
from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator
from electrocardio_panorama_tpu_torch.training import solver as S
from electrocardio_panorama_tpu_torch.utils import profiling

PHASES = ("inputs", "forward", "backward", "update")
STEP = "ecgpan.train_step"
MS_NS = 1_000_000  # the clock test's slack: 1 ms


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def base_cfg(tmp_path_factory):
    cfg = get_cfg()
    cfg.desc = "tracing"
    cfg.DATA.dataset = "synthetic"
    cfg.DATA.lead_num = 3
    cfg.DATA.super_mode = "IIv2v5_v4I_372"
    cfg.DATA.train_data_mode = "input_fix"
    cfg.DATA.batch_size = 2
    cfg.MODEL.jitter_factor = 2.5
    cfg.SOLVER.epochs = 1
    cfg.SOLVER.lr = 0.05
    cfg.SOLVER.loss_factor = [0.5, 0.5, 1]
    cfg.TPU.steps_per_epoch = 2
    cfg.DATA.synthetic_root = str(tmp_path_factory.mktemp("synth"))
    cfg.output_dir = str(tmp_path_factory.mktemp("out"))
    return cfg


@pytest.fixture(scope="module")
def batch(base_cfg):
    dl = BeatLoader(build_dataset(base_cfg, "train"), base_cfg.DATA.batch_size, shuffle=True, drop_last=True,
                    seed=1)
    return next(iter(dl))


def model_cfg(base_cfg, model, tmp_path):
    cfg = base_cfg.clone()
    cfg.MODEL.model = model
    cfg.output_dir = str(tmp_path)
    return cfg


def one_step(cfg, batch):
    """A fresh Solver's first step: (params, bn_state, loss vector)."""
    s = S.Solver(cfg, use_writer=False, device="cpu")
    params, bn, opt = s.init_state()
    bn, lvec = s.train_step(params, bn, opt, epoch=0, step=0, i1=1, i2=2, batch=batch)
    return {k: v.detach() for k, v in params.items()}, bn, lvec


def inside(child, parent, slack=0):
    return parent["start_ns"] - slack <= child["start_ns"] <= child["end_ns"] <= parent["end_ns"] + slack


def test_profiler_check_reads_the_session():
    off = profiling.span("ecgpan.x")
    assert not torch.autograd.profiler._is_profiler_enabled
    assert off is profiling.span("ecgpan.y")  # the one shared no-op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert profiling.span("ecgpan.x") is not off
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("ecgpan.x") is off


@pytest.mark.parametrize("model", ["model_nefnet", "model_nefnet2"])
def test_recording_changes_no_bit_and_off_records_nothing(base_cfg, batch, model, tmp_path):
    cfg = model_cfg(base_cfg, model, tmp_path)
    p_off, bn_off, l_off = one_step(cfg, batch)
    assert profiling.snapshot() == {"spans": [], "by_name": {}, "dropped": 0}
    with profiling.recording():
        p_on, bn_on, l_on = one_step(cfg, batch)
    assert profiling.snapshot()["by_name"][STEP]["calls"] == 1
    torch.testing.assert_close(l_on, l_off, rtol=0, atol=0)
    for k in p_off:
        torch.testing.assert_close(p_on[k], p_off[k], rtol=0, atol=0, msg=k)
    assert set(bn_on) == set(bn_off)
    for k in bn_off:
        torch.testing.assert_close(bn_on[k], bn_off[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("model", ["model_nefnet", "model_nefnet2"])
def test_train_step_records_its_four_phases(base_cfg, batch, model, tmp_path):
    cfg = model_cfg(base_cfg, model, tmp_path)
    with profiling.recording():
        one_step(cfg, batch)
    snap = profiling.snapshot()
    spans = {s["name"]: s for s in snap["spans"]}
    assert sorted(spans) == sorted([STEP] + [f"{STEP}.{p}" for p in PHASES])
    root = spans[STEP]
    assert root["parent"] is None and root["root"] == root["id"]
    kids = [spans[f"{STEP}.{p}"] for p in PHASES]
    for k in kids:
        assert k["parent"] == root["id"] and k["root"] == root["id"] and k["thread"] == root["thread"]
        assert inside(k, root)
        assert k["device_ms"] is None
    for a, b in zip(kids, kids[1:]):  # in order, not overlapping
        assert a["end_ns"] <= b["start_ns"]
    by = snap["by_name"]
    children_ms = sum(by[f"{STEP}.{p}"]["host_ms"] for p in PHASES)
    assert by[STEP]["self_ms"] == pytest.approx(by[STEP]["host_ms"] - children_ms, abs=1e-6)
    assert children_ms >= 0.9 * by[STEP]["host_ms"]
    for p in PHASES:  # leaves: self is all of it
        assert by[f"{STEP}.{p}"]["self_ms"] == by[f"{STEP}.{p}"]["host_ms"]


def test_classifier_step_records_the_resnet_spans(tmp_path, monkeypatch):
    """A model_resnet1d step records ecgpan.resnet1d.forward and its six
    children (stem, layer1-4, head), in order, inside
    ecgpan.train_step.forward; on the CPU without device time, at 4 stem
    channels."""
    from electrocardio_panorama_tpu_torch.models import ResNet1dDef

    monkeypatch.setattr(S, "build_model", lambda cfg: ResNet1dDef("resnet50", 8, 5, init_channels=4))
    cfg = get_cfg()
    cfg.MODEL.model, cfg.MODEL.arch, cfg.MODEL.loss = "model_resnet1d", "resnet50", "bce"
    cfg.MODEL.num_classes = 5
    cfg.output_dir, cfg.desc = str(tmp_path), "tracing"
    rng = np.random.default_rng(0)
    batch = {"data": rng.standard_normal((2, 8, 600)).astype(np.float32),
             "label": (rng.random((2, 5)) < 0.3).astype(np.int64)}
    with profiling.recording():
        one_step(cfg, batch)
    spans = {s["name"]: s for s in profiling.snapshot()["spans"]}
    fwd, net = spans[f"{STEP}.forward"], spans["ecgpan.resnet1d.forward"]
    assert net["parent"] == fwd["id"] and inside(net, fwd)
    kids = [spans[f"ecgpan.resnet1d.{k}"] for k in ("stem", "layer1", "layer2", "layer3", "layer4", "head")]
    for k in kids:
        assert k["parent"] == net["id"] and k["root"] == spans[STEP]["id"] and inside(k, net)
        assert k["device_ms"] is None
    for a, b in zip(kids, kids[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert sorted(spans) == sorted([STEP] + [f"{STEP}.{p}" for p in PHASES] + ["ecgpan.resnet1d.forward"]
                                   + [f"ecgpan.resnet1d.{k}" for k in ("stem", "layer1", "layer2", "layer3",
                                                                        "layer4", "head")])


def test_render_records_encode_and_basis_planes(base_cfg, batch, tmp_path):
    cfg = model_cfg(base_cfg, "model_nefnet", tmp_path)
    params, bn, _ = S.Solver(cfg, use_writer=False, device="cpu").init_state()
    gen = PanoramaGenerator(build_model(cfg), {k: v.detach() for k, v in params.items()}, bn, use_fused=True,
                            device="cpu", plain=True)
    views = np.stack(np.meshgrid(np.linspace(0, 3, 2), np.linspace(0, 6, 3)), -1).reshape(-1, 2)
    with profiling.recording():
        gen.render(batch["data"], batch["input_theta"], batch["rois"], views.astype(np.float32))
    spans = {s["name"]: s for s in profiling.snapshot()["spans"]}
    assert sorted(spans) == ["ecgpan.basis_planes", "ecgpan.encode", "ecgpan.render"]
    root = spans["ecgpan.render"]
    assert root["parent"] is None
    for name in ("ecgpan.encode", "ecgpan.basis_planes"):
        assert spans[name]["parent"] == root["id"] and inside(spans[name], root)
        assert spans[name]["device_ms"] is None  # the CPU records no events
    assert spans["ecgpan.encode"]["end_ns"] <= spans["ecgpan.basis_planes"]["start_ns"]


def test_spans_lie_on_the_profilers_clock(base_cfg, batch, tmp_path):
    cfg = model_cfg(base_cfg, "model_nefnet", tmp_path)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        one_step(cfg, batch)
    spans = {s["name"]: s for s in profiling.snapshot()["spans"]}
    fwd, bwd = spans[f"{STEP}.forward"], spans[f"{STEP}.backward"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    assert not [e.name for e in events if e.name.startswith("ecgpan.")]

    def placed(e):
        return {"start_ns": t0 + int(e.time_range.start * 1000), "end_ns": t0 + int(e.time_range.end * 1000)}

    convs = [placed(e) for e in events if e.name == "aten::convolution"]
    engine = [placed(e) for e in events if e.name.startswith("autograd::engine::evaluate_function")]
    assert convs and engine
    assert all(inside(c, fwd, MS_NS) or inside(c, bwd, MS_NS) for c in convs)
    assert any(inside(c, fwd, MS_NS) for c in convs)
    assert all(inside(e, bwd, MS_NS) for e in engine)


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(5):
            with profiling.span("ecgpan.x"):
                pass
    snap = profiling.snapshot()
    assert snap["by_name"]["ecgpan.x"]["calls"] == 3 and snap["dropped"] == 2
    assert any("dropped" in line for line in profiling.summary_lines(snap))


def test_profile_dir_merges_spans_into_the_trace(base_cfg, tmp_path, capsys):
    cfg = model_cfg(base_cfg, "model_nefnet", tmp_path / "out")
    cfg.TPU.profile_dir = str(tmp_path / "trace")
    train_main.main(cfg, device="cpu")
    out = capsys.readouterr().out
    assert f"span {STEP}: 2 calls" in out and f"span {STEP}.forward: 2 calls" in out
    assert "span ecgpan.loader_wait:" in out
    assert profiling.snapshot()["spans"] == []
    trace = json.load(open(os.path.join(cfg.TPU.profile_dir, "train_trace.json")))
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    fwd = [e for e in evs if e.get("cat") == "ecgpan_span" and e["name"] == f"{STEP}.forward"]
    assert len(fwd) == 2
    for f in fwd:
        assert f["pid"] == os.getpid()
        ops = [e for e in evs if e["name"].startswith("aten::") and e["tid"] == f["tid"]
               and f["ts"] - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= f["ts"] + f["dur"] + 1e3]
        assert ops, f
