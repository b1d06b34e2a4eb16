"""The plain reference against the program's eager path on the CPU at small
sizes, piece by piece and end to end; and what portbench imports."""

import ast
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from portbench import harness
from portbench.entries import train
from portbench.reference import nefnet as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORTBENCH = os.path.join(ROOT, "portbench")
PROGRAM = "electrocardio_panorama_tpu_torch"


@pytest.mark.parametrize("model,lead_num", [("model_nefnet", 3), ("model_nefnet2", 3), ("model_nefnet", 1)])
def test_param_table_is_the_programs_tree(model, lead_num):
    from electrocardio_panorama_tpu_torch.models import build_model
    from electrocardio_panorama_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.model, cfg.DATA.lead_num = model, lead_num
    params, state = build_model(cfg).init(torch.Generator().manual_seed(0))
    table = ref.param_table(model, lead_num)
    assert [(n, tuple(s)) for n, s, _, _ in table] == [(k, tuple(v.shape)) for k, v in params.items()]
    assert sorted(f"{n}.{s}" for n, _ in ref.bn_state_table()
                  for s in ("running_mean", "running_var", "num_batches_tracked")) == sorted(state)


def test_roi_ops_equal_the_programs():
    from electrocardio_panorama_tpu_torch.ops import roi_align_1d, roi_reverse_1d

    cell = harness.load_cell(ROOT, "nefnet.train.f32.b85")
    from portbench.traffic import generator

    batch = generator.pool({"batch": 6, "pool": 1, "phase": "train", "record_len": 5000}, cell.data_cfg(), 3)[0]
    rois = torch.as_tensor(batch["rois"])
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 40, 128, generator=g)
    torch.testing.assert_close(ref.roi_align(x, rois), roi_align_1d(x, rois), rtol=1e-6, atol=1e-7)
    grid = torch.randn(6, 40, 7, 32, generator=g)
    # the lerp weights agree to rounding (1e-6), times values up to about 5
    torch.testing.assert_close(ref.roi_reverse(grid, ref.roi_reverse_matrices(rois, "cpu")),
                               roi_reverse_1d(grid, rois), rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", ["model_nefnet", "model_nefnet2"])
def test_masks_are_the_programs_rule(model):
    from electrocardio_panorama_tpu_torch.models.nefnet2 import draw_masks as masks2
    from electrocardio_panorama_tpu_torch.ops.kernels.encoder_fused import draw_masks
    from electrocardio_panorama_tpu_torch.training.solver import step_seed

    seed, B, L = 2**33 + 5, 3, 3
    gen = torch.Generator().manual_seed(step_seed(seed, 0, 2))
    want = masks2(gen, B, lead_num=L) if model == "model_nefnet2" else draw_masks(gen, B, L)
    got = ref.dropout_masks(model, seed, 0, 2, B, L, "cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _ctx(cell_name, tmp, batch, knobs=None, seed=2**33 + 7, **mix):
    cell = harness.load_cell(ROOT, cell_name)
    cell.mix = dict(cell.mix, batch=batch, pool=3, **mix)
    if knobs:
        cell.spec = dict(cell.spec, knobs=knobs)
    params, bn_state = harness.make_weights(cell, seed, torch.device("cpu"))
    return harness.Context(cell, seed, torch.device("cpu"), harness.program_cfg(cell, seed, tmp), params, bn_state)


@pytest.mark.parametrize("cell,knobs", [
    ("nefnet.train.f32.b85", {"TPU": {"train_encoder": "xla", "train_decoder": "xla"}}),
    ("nefnet2.train.f32.b32", {"TPU": {"train_encoder": "xla", "train_decoder": "xla"}}),
])
def test_train_steps_match_the_programs_eager_path(cell, knobs):
    with tempfile.TemporaryDirectory() as tmp:
        st = train.setup(_ctx(cell, tmp, 2, knobs))
        got = train.check(st)
    assert got["loss_gap"] < 1e-6 and got["bn_gap"] < 1e-5, got
    assert got["grad_gap"] < 1e-4 and got["update_gap"] < 1e-4, got


@pytest.mark.parametrize("use_fused", [False, True])
def test_render_matches_the_programs(use_fused):
    from electrocardio_panorama_tpu_torch.models import build_model
    from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator
    from portbench.traffic import generator

    with tempfile.TemporaryDirectory() as tmp:
        ctx = _ctx("nefnet.render.f32.v336", tmp, 2, n_theta=2, n_phi=3)
    b = generator.pool(ctx.cell.mix, ctx.cell.data_cfg(), ctx.seed)[0]
    b = {k: torch.as_tensor(b[k]) for k in ("data", "input_theta", "rois")}
    views = generator.view_grid(2, 3)
    params = {k: v.detach() for k, v in ctx.params.items()}
    gen = PanoramaGenerator(build_model(ctx.cfg), params, ctx.bn_state, use_fused=use_fused, device="cpu")
    got = gen.render(b["data"], b["input_theta"], b["rois"], views)
    want = ref.render("model_nefnet", params, ctx.bn_state, b, torch.as_tensor(views), 3)
    assert got.shape == want.shape == (2, 6, 512)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_program():
    top = {m: m.split(".")[0] for p in _sources(PORTBENCH) for m in _imports(p)}
    assert not set(top.values()) & set(harness.FORBIDDEN), sorted(set(top.values()) & set(harness.FORBIDDEN))
    assert PROGRAM in top.values()  # the names are compared whole: the program's starts with the JAX package's
    for p in _sources(os.path.join(PORTBENCH, "reference")):
        mods = [m.split(".")[0] for m in _imports(p)]
        assert PROGRAM not in mods and not [m for m in _imports(p) if m.startswith("portbench")], (p, mods)


def test_loading_the_harness_loads_no_jax():
    code = ("import sys, glob, os, importlib.util; sys.path.insert(0, %r)\n"
            "import portbench.harness, portbench.entries.train, portbench.entries.render, portbench.controls\n"
            "for p in glob.glob(os.path.join(%r, 'metrics', '*.py')):\n"
            "    s = importlib.util.spec_from_file_location('m' + str(abs(hash(p))), p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "import electrocardio_panorama_tpu_torch.training.solver, electrocardio_panorama_tpu_torch.synthesis\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'electrocardio_panorama_tpu'}))") % (ROOT, PORTBENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
