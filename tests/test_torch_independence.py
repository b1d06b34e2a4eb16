"""The port stands alone: no jax, nothing of the JAX package, no silent CPU.

Rules checked:
  * importing every module of `electrocardio_panorama_tpu_torch` (in a fresh
    interpreter), the annotation, parallel and utils modules among them,
    loads neither `jax` nor `electrocardio_panorama_tpu`, nor matplotlib or
    sklearn (the card's machine has neither; they load inside the plot
    helpers only);
  * no module of the port, and not chip_smoke.py, imports either (AST scan);
  * a checkpoint the JAX package wrote with optimizer state loads in the port
    without importing jax or optax;
  * the entry points (render, main, val_net) default to the card and raise
    without one, from Python and from the command line, unless the CPU is
    named (`device='cpu'`, `--device cpu`);
  * chip_smoke.py fails, printing no result, without a card or without the repo.
"""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import electrocardio_panorama_tpu_torch as port
from electrocardio_panorama_tpu_torch import main as train_main
from electrocardio_panorama_tpu_torch import render, val_net
from electrocardio_panorama_tpu_torch.config import load_cfg
from electrocardio_panorama_tpu_torch.models import NefNetDef, init_nefnet
from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator
from electrocardio_panorama_tpu_torch.utils import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "jaxlib", "optax", "electrocardio_panorama_tpu")
LAZY = ("matplotlib", "sklearn")
NEW_MODULES = ("annotation", "annotation.auto_segment", "annotation.cli", "annotation.interactive",
               "annotation.schema", "parallel", "parallel.mesh", "parallel.multihost", "parallel.sharding",
               "utils.flops", "utils.transforms")


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG_DIR], prefix=port.__name__ + "."))


def forbidden(name: str) -> bool:
    """True for jax* and the JAX package itself, not for the port's `_torch`."""
    return name.split(".")[0] in FORBIDDEN


def run_clean(code: str, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": REPO})


def test_importing_every_port_module_loads_no_jax():
    mods = port_modules()
    assert len(mods) >= 25
    for kernel_module in ("decoder_fused", "decoder_train", "encoder_fused", "build"):
        assert f"{port.__name__}.ops.kernels.{kernel_module}" in mods
    for module in NEW_MODULES:
        assert f"{port.__name__}.{module}" in mods
    code = (f"import importlib, sys, json\nfor m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN + LAZY!r})))")
    proc = run_clean(code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_no_jax_import_in_port_sources():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path}:{node.lineno} {n}" for n in names if forbidden(n)]
    assert len(files) > 25 and bad == []


def test_jax_checkpoint_with_optimizer_loads_without_jax(tmp_path):
    import jax
    import optax
    from electrocardio_panorama_tpu.models.nefnet import init_nefnet as jax_init
    from electrocardio_panorama_tpu.training.checkpoint import CheckPointer as JaxCheckPointer

    params, state = jax_init(jax.random.PRNGKey(1), lead_num=1)
    opt_state = optax.sgd(0.1, momentum=0.9).init(params)
    JaxCheckPointer(str(tmp_path)).save("epoch_3", params=params, bn_state=state,
                                        opt_state=opt_state, epoch=3, psnr_gen=21.5)
    code = (
        "import sys, json\n"
        "from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer\n"
        f"p, s, opt, ex = CheckPointer({str(tmp_path)!r}).load()\n"
        "print(json.dumps([len(p), len(s), opt is not None, ex, float(p['mlp2.bias'].sum()),\n"
        f"  sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})]))")
    proc = run_clean(code)
    assert proc.returncode == 0, proc.stderr
    n_p, n_s, has_opt, extras, bias_sum, loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (n_p, n_s, has_opt, loaded) == (len(params), len(state), True, [])
    assert extras == {"epoch": 3, "psnr_gen": 21.5}
    assert abs(bias_sum - float(np.asarray(params["mlp2.bias"]).sum())) < 1e-5


def test_entry_points_need_the_card_unless_cpu_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    params, state = init_nefnet(torch.Generator().manual_seed(0), lead_num=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PanoramaGenerator(NefNetDef(3), params, state)
    cfg = load_cfg(os.path.join(REPO, "configs", "nef_net_synthetic.yml"),
                   ["output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        render.main(cfg)
    for entry in (train_main.main, val_net.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            entry(cfg)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_train_cli_needs_the_card_unless_cpu_is_named(tmp_path):
    base = [sys.executable, "-m", "electrocardio_panorama_tpu_torch.main", "--config-file",
            os.path.join(REPO, "configs", "nef_net_synthetic.yml")]
    opts = ["output_dir", str(tmp_path / "out"), "DATA.synthetic_root", str(tmp_path / "synth"),
            "DATA.synthetic_n_train", "4", "DATA.synthetic_n_test", "4", "SOLVER.epochs", "0"]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(base + opts, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
    proc = subprocess.run(base + ["--device", "cpu"] + opts, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    val = [sys.executable, "-m", "electrocardio_panorama_tpu_torch.val_net", "--config-file",
           os.path.join(REPO, "configs", "nef_net_synthetic.yml"), "--epoch", "0"]
    proc = subprocess.run(val + opts, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone / "chip_smoke.py")
    for cwd in (REPO, str(lone)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                              text=True, timeout=300, env={k: v for k, v in os.environ.items()
                                                           if k != "PYTHONPATH"})
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
