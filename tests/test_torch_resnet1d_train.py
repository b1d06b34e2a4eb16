"""The 1-D ResNet classifier (MODEL.model 'model_resnet1d') on the port's
training path, against the benchmark's plain reference
(portbench/reference/resnet1d.py), on the CPU at a small size: init_channels
4, records of 8 leads x 600 samples, batch 4, 5 classes, seeded random
weights drawn as the benchmark draws them (portbench/entries/classify.py).

  * `Solver.train_step` against the reference, for both block kinds
    (resnet50's Bottleneck, resnet18's BasicBlock), with the same dropout
    masks: in float64 (params, records and state; the step's code is the
    float32 one), the losses of 3 SGD steps, the first gradients, the
    parameters after the 3 steps and the BatchNorm running statistics, at
    1e-9; in float32, the first step's loss and running statistics at the
    port's f32 bars (1e-5). A float32 run of several steps from one start is
    not compared here: a relu input within rounding of zero takes the other
    side on one of the two, the gradient jumps there, and the learning rate
    carries the jump into the next step's weights (the float32 reference
    against itself in float64 reads 0.06-0.9 in the update's norm gap after
    3 steps at these sizes). The benchmark's check restarts the reference
    from the program's state at each step instead (`entries/classify.py`),
    and the reference's restart continues its own run bit for bit;
  * the blocks' dropout mask shapes (program and reference) and the
    counts' forward and train-step operations against
    `torch.utils.flop_counter.FlopCounterMode`;
  * the labelled corpus, its 80/20 split (sklearn's, written out), the BCE
    and the micro-averaged F1;
  * one epoch of `main.py` and `val_net.py` on the synthetic labelled corpus,
    2 steps, writing checkpoints under the reference's state_dict keys;
  * the knobs the classifier does not take raise;
  * the benchmark's classify entry through the harness at a tiny size: a
    sound run is correct; an unchanged state, a step on half of each batch,
    and a learning rate, momentum or weight decay other than the
    reference's are not; on the card, the reference in TF32 in the
    program's place fails the cell's own limits at the cell's own size;
  * the two new per-layer readers on a recorded snapshot.

The classifier runs here at init_channels 4 (`narrow`); the model path's
stem width is the reference's 64.
"""

import json
import os
import pickle
import shutil
import time

import numpy as np
import pytest
import torch

from electrocardio_panorama_tpu_torch import main as train_main
from electrocardio_panorama_tpu_torch import val_net
from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.data import build_dataset
from electrocardio_panorama_tpu_torch.data.tianchi import split_80_20
from electrocardio_panorama_tpu_torch.models import ResNet1dDef
from electrocardio_panorama_tpu_torch.models.losses import bce
from electrocardio_panorama_tpu_torch.models.resnet1d import LAYER_SPECS, mask_shapes, resnet1d_plan
from electrocardio_panorama_tpu_torch.training import metrics as M
from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
from electrocardio_panorama_tpu_torch.training import solver as solver_module
from electrocardio_panorama_tpu_torch.training.solver import Solver
from electrocardio_panorama_tpu_torch.utils import profiling
from portbench import compare, harness
from portbench.counts import resnet1d50 as counts
from portbench.entries import classify as entry
from portbench.reference import resnet1d as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, C, IC, LR = 600, 4, 5, 4, 0.1
SEED = 2**33 + 23
F64_BAR = 1e-9   # float64 on both sides, the same equations: rounding at 1e-16 amplified over 3 steps
F32_BAR = 1e-5   # the port's float32 bar for a loss and running statistics after one step


@pytest.fixture
def narrow(monkeypatch):
    """The Solver builds the classifier at init_channels IC."""
    build = solver_module.build_model

    def narrow_build(cfg):
        if cfg.MODEL.model != "model_resnet1d":
            return build(cfg)
        return ResNet1dDef(cfg.MODEL.arch, cfg.DATA.in_channel, cfg.MODEL.num_classes, cfg.DATA.lead_num,
                           init_channels=IC)

    monkeypatch.setattr(solver_module, "build_model", narrow_build)


def classifier_cfg(arch, tmp_path, **data):
    cfg = get_cfg()
    cfg.MODEL.model, cfg.MODEL.arch, cfg.MODEL.loss = "model_resnet1d", arch, "bce"
    cfg.MODEL.num_classes = C
    cfg.DATA.in_channel, cfg.DATA.lead_num = 8, 1
    cfg.SOLVER.lr, cfg.seed = LR, SEED
    cfg.output_dir, cfg.desc = str(tmp_path), "cls"
    for k, v in data.items():
        cfg.DATA[k] = v
    return cfg


def arch_of(arch):
    return ref.Arch(arch, in_channel=8, num_classes=C, init_channels=IC)


def batches(dtype):
    pool = entry.pool({"batch": B, "pool": 3, "record_len": T, "label_p": 0.3}, C, SEED)
    return [{"data": b["data"].astype(dtype), "label": b["label"]} for b in pool]


def program_steps(cfg, a, dtype, steps):
    """(first, p0, s0): the Solver's first `steps` steps from the entry's
    weights, with the state both sides start from."""
    s = Solver(cfg, use_writer=False, device="cpu")
    params, bn = entry.make_weights(a, SEED, torch.device("cpu"))
    tdt = getattr(torch, dtype)
    params = {k: v.detach().to(tdt).requires_grad_(True) for k, v in params.items()}
    bn = {k: v.to(tdt) if v.is_floating_point() else v for k, v in bn.items()}
    p0 = {k: v.detach().clone() for k, v in params.items()}
    s0 = {k: v.clone() for k, v in bn.items()}
    opt = get_optimizer(cfg, params)
    losses, grads = [], None
    for k, b in enumerate(batches(dtype)[:steps]):
        bn, lvec = s.train_step(params, bn, opt, epoch=0, step=k, batch=b)
        losses.append(lvec)
        if k == 0:
            grads = {n: opt.state[p]["momentum_buffer"].clone() for n, p in params.items()}
    return {"losses": torch.stack(losses), "grads": grads, "params": {k: v.detach() for k, v in params.items()},
            "bn_state": bn}, p0, s0


def reference_steps(a, p0, s0, dtype, steps):
    rb = [{"data": torch.as_tensor(b["data"]), "label": torch.as_tensor(b["label"]).to(getattr(torch, dtype))}
          for b in batches(dtype)[:steps]]
    return ref.train_steps(a, p0, s0, rb, SEED, LR)


def max_rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("arch", ["resnet50", "resnet18"])
def test_train_step_matches_reference_float64(arch, tmp_path, narrow):
    a = arch_of(arch)
    got, p0, s0 = program_steps(classifier_cfg(arch, tmp_path), a, "float64", 3)
    want = reference_steps(a, p0, s0, "float64", 3)
    assert got["losses"].shape == (3, 1) and got["losses"].dtype == torch.float32
    # the step returns its loss vector in float32: one rounding of the float64 loss
    torch.testing.assert_close(got["losses"].double(), want["losses"].double(), rtol=2**-23, atol=0)
    assert set(got["grads"]) == set(want["grads"]) == set(p0)
    for k in p0:
        assert max_rel(got["grads"][k], want["grads"][k]) < F64_BAR, k
        assert max_rel(got["params"][k] - p0[k], want["params"][k] - p0[k]) < F64_BAR, k
    assert set(got["bn_state"]) == set(s0)
    for k, v in s0.items():
        if v.is_floating_point():
            assert max_rel(got["bn_state"][k] - v, want["bn_state"][k] - v) < F64_BAR, k
        else:
            assert int(got["bn_state"][k]) == int(want["bn_state"][k]) == 3, k
    readings = compare.train_readings(got, want, p0, s0)
    assert readings["loss_gap"] < 2**-23 and max(readings[k] for k in ("grad_gap", "update_gap", "bn_gap")) < F64_BAR


@pytest.mark.parametrize("arch", ["resnet50", "resnet18"])
def test_train_step_matches_reference_float32_first_step(arch, tmp_path, narrow):
    a = arch_of(arch)
    got, p0, s0 = program_steps(classifier_cfg(arch, tmp_path), a, "float32", 1)
    want = reference_steps(a, p0, s0, "float32", 1)
    assert compare.loss_gaps(got, want)[0] < F32_BAR
    for k, v in s0.items():
        if v.is_floating_point():
            torch.testing.assert_close(got["bn_state"][k], want["bn_state"][k], rtol=F32_BAR, atol=F32_BAR,
                                       msg=k)


@pytest.mark.parametrize("arch", list(LAYER_SPECS))
def test_mask_shapes_are_the_blocks_dropout_inputs(arch):
    meta = resnet1d_plan(arch, init_channels=IC)
    a = ref.Arch(arch, in_channel=8, num_classes=C, init_channels=IC)
    for length in (600, 601, 5000):
        assert mask_shapes(meta, 3, length) == ref.dropout_shapes(a, 3, length)
    model = ResNet1dDef(arch, 8, C, init_channels=IC)
    params, state = model.init(torch.Generator().manual_seed(0))
    masks = model.draw_masks(torch.Generator().manual_seed(1), 2, T)
    assert [tuple(m.shape) for m in masks] == mask_shapes(meta, 2, T)
    assert all(set(torch.unique(m).tolist()) <= {0.0, 1.25} for m in masks)
    probs, _ = model.apply(params, state, torch.randn(2, 8, T), train=True, masks=masks)  # shapes fit
    assert probs.shape == (2, C)


@pytest.mark.parametrize("arch", ["resnet50", "resnet18"])
def test_weights_and_reference_keys_match_the_program(arch):
    a = arch_of(arch)
    params, state = ResNet1dDef(arch, 8, C, init_channels=IC).init(torch.Generator().manual_seed(0))
    table = {name: shape for name, shape, _, _ in ref.param_table(a)}
    assert {k: tuple(v.shape) for k, v in params.items()} == table
    stats = {f"{n}.{s}" for n, _ in ref.bn_state_table(a) for s in ("running_mean", "running_var",
                                                                      "num_batches_tracked")}
    assert set(state) == stats
    p, s = entry.make_weights(a, SEED, torch.device("cpu"))
    assert set(p) == set(params) and set(s) == stats
    p2, _ = entry.make_weights(a, SEED, torch.device("cpu"))
    assert all(torch.equal(p[k], p2[k]) for k in p)


def test_forward_and_step_counts_match_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    a = ref.Arch("resnet50", in_channel=8, num_classes=C, init_channels=IC)
    p, s = entry.make_weights(a, SEED, torch.device("cpu"))
    x = torch.randn(2, 8, T)
    sizes = {"length": T, "init_channels": IC, "num_classes": C}
    with FlopCounterMode(display=False) as fc:
        probs = ref.forward(a, p, s, x)
    assert fc.get_total_flops() == counts.forward_flops(2, "all", **sizes)
    with FlopCounterMode(display=False) as fc:
        ref.bce(ref.forward(a, p, s, x), torch.zeros(2, C)).backward()
    assert fc.get_total_flops() == counts.train_step_flops(2, taps="all", **sizes)
    assert probs.shape == (2, C)
    assert counts.forward_flops(1) == pytest.approx(41.298e9, rel=1e-4)
    assert counts.train_step_flops(64) == pytest.approx(7.9268e12, rel=1e-4)


def test_corpus_split_and_metrics(tmp_path):
    cfg = classifier_cfg("resnet50", tmp_path, dataset="tianchi_cls", synthetic_root=str(tmp_path / "syn"),
                         synthetic_n_train=16, synthetic_n_test=4)
    train, test = build_dataset(cfg, "train"), build_dataset(cfg, "test")
    assert (len(train), len(test)) == (16, 4)
    ex = train.__getitem__(0)
    assert ex["data"].shape == (8, 5000) and ex["data"].dtype == np.float32
    assert ex["label"].shape == (C,) and train.label.sum(axis=1).min() >= 1
    assert set(train.files).isdisjoint(test.files)
    assert train.get_label_weight().shape == (16,)
    sk = pytest.importorskip("sklearn.model_selection")
    for n, seed in ((20, 123), (101, 7), (5, 2**31 - 1)):
        tr, te = sk.train_test_split(np.arange(n), shuffle=True, test_size=0.2, random_state=seed)
        got_tr, got_te = split_80_20(n, seed)
        assert got_tr.tolist() == tr.tolist() and got_te.tolist() == te.tolist()
    skm = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(3)
    probs = torch.tensor(rng.random((16, C)), dtype=torch.float32)
    labels = torch.tensor(rng.random((16, C)) < 0.3)
    counts3 = M.multilabel_counts(probs, labels.long())
    want = skm.f1_score(labels.numpy(), (probs >= 0.5).numpy(), average="micro")
    assert float(M.micro_f1(counts3)) == pytest.approx(want, rel=1e-6)
    assert float(M.micro_f1(torch.zeros(3))) == 0.0
    torch.testing.assert_close(bce(probs, labels.long()), torch.nn.BCELoss()(probs, labels.float()))
    torch.testing.assert_close(ref.bce(probs, labels.float()), bce(probs, labels), rtol=1e-6, atol=0)


def test_main_trains_and_val_reads_the_classifier(tmp_path, capsys, narrow):
    cfg = classifier_cfg("resnet50", tmp_path, dataset="tianchi_cls", synthetic_root=str(tmp_path / "syn"),
                         synthetic_n_train=12, synthetic_n_test=3, batch_size=2)
    cfg.SOLVER.epochs, cfg.TPU.steps_per_epoch = 1, 2
    cfg.seed = 7  # seed_everything seeds numpy's legacy stream, which takes 32 bits
    solver = train_main.main(cfg, device="cpu")
    assert solver.history[0]["train_steps"] == 2 and solver.history[0]["train_losses"].shape == (2, 1)
    assert set(solver.history[0]["scalars"]) == {"train_loss_all", "test_loss_all", "f1"}
    with open(os.path.join(str(tmp_path), "cls", "epoch_0.pkl"), "rb") as f:
        ck = pickle.load(f)
    a = arch_of("resnet50")
    state_dict = {name for name, _, _, _ in ref.param_table(a)} | {
        f"{n}.{s}" for n, _ in ref.bn_state_table(a) for s in ("running_mean", "running_var", "num_batches_tracked")}
    assert set(ck["model"]) | set(ck["bn_state"]) == state_dict
    assert ck["epoch"] == 0 and ck["best_test_f1"] == ck["f1"] and 0.0 <= ck["f1"] <= 1.0
    assert all(int(v) == 2 for k, v in ck["bn_state"].items() if k.endswith("num_batches_tracked"))
    assert os.path.exists(os.path.join(str(tmp_path), "cls", "best_valid.pkl"))
    out = val_net.main(cfg, device="cpu")
    assert set(out) == {"loss", "f1"} and out["f1"] == pytest.approx(ck["f1"])
    assert "best_test_f1" in capsys.readouterr().out


@pytest.mark.parametrize("knob,value", [("train_encoder", "fused"), ("eval_encoder", "fused"),
                                        ("train_decoder", "fused"), ("mesh_shape", [1]),
                                        ("compute_dtype", "bfloat16")])
def test_knobs_the_classifier_does_not_take_raise(knob, value, tmp_path, narrow):
    cfg = classifier_cfg("resnet50", tmp_path)
    cfg.TPU[knob] = value
    with pytest.raises((ValueError, NotImplementedError), match="model_resnet1d"):
        Solver(cfg, use_writer=False, device="cpu")


def test_no_fused_function_is_built_for_the_classifier(tmp_path, narrow):
    s = Solver(classifier_cfg("resnet50", tmp_path), use_writer=False, device="cpu")
    assert s.model.classifier and s.model.score == "f1" and s.model.loss_widths == (1, 1)
    assert s._train_enc_fn is None and s._train_dec_fn is None and s._eval_enc_fn is None
    assert s.train_step == s._classify_train_step and s.eval_step == s._classify_eval_step


@pytest.fixture
def tiny_root(tmp_path, narrow):
    """A checkout whose classify cell is cut to the CPU's size (init_channels
    4, batch 2 of 600-sample records)."""
    r = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(r, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), r)
    os.symlink(os.path.join(REPO, "electrocardio_panorama_tpu_torch"),
               os.path.join(r, "electrocardio_panorama_tpu_torch"))
    path = os.path.join(r, "portbench", "configs", "resnet1d50.json")
    cfg = harness.read_json(path)
    cfg["widths"]["init_channels"] = IC
    with open(path, "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(r, "portbench", "traffic", "classify.b64.json"), "w") as f:
        json.dump({"batch": 2, "pool": 4, "phase": "train", "record_len": T, "label_p": 0.05}, f)
    return r


def test_classify_entry_runs_through_the_harness(tiny_root):
    w = "resnet1d50.train.f32.b64"
    out = harness.run_cell(tiny_root, w, SEED, 0.5, False, "cpu", time.perf_counter())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"setup_s", "train_samples_per_s", "peak_mem_gib"}
    assert set(out["check"]) == {"loss_gap", "grad_gap", "update_gap", "bn_gap"}
    assert out["check"]["loss_gap"]["value"] < F32_BAR
    cell = harness.load_cell(tiny_root, w)
    names = {m["name"] for m in cell.metrics["per_layer"]}
    assert {"resnet_forward_device_ms.train", "resnet_forward_roofline", "train_mfu"} <= names
    assert not any(n.startswith(("a1_", "a2_", "a3_", "a4")) for n in names)


def test_classify_entry_catches_an_unchanged_state(tiny_root, monkeypatch):
    orig = Solver._classify_train_step

    def unchanged(self, params, bn_state, opt, **kw):
        before = {k: v.detach().clone() for k, v in params.items()}
        _, lvec = orig(self, params, bn_state, opt, **kw)
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(before[k])
        return bn_state, lvec

    monkeypatch.setattr(Solver, "_classify_train_step", unchanged)
    out = harness.run_cell(tiny_root, "resnet1d50.train.f32.b64", SEED, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"] is False
    assert out["check"]["update_gap"]["value"] == pytest.approx(1.0)
    assert out["check"]["bn_gap"]["value"] == pytest.approx(1.0)


def test_reference_restart_continues_its_run():
    """Steps restarted from the run's own state and earlier gradients
    (`past_grads`) reproduce the run bit for bit: the check's restarts
    change what is compared, not the reference's arithmetic."""
    a = arch_of("resnet50")
    p0, s0 = entry.make_weights(a, SEED, torch.device("cpu"))
    rb = [{"data": torch.as_tensor(b["data"]), "label": torch.as_tensor(b["label"]).float()}
          for b in batches("float32")]
    run = ref.train_steps(a, p0, s0, rb, SEED, LR)
    one = ref.train_steps(a, p0, s0, rb[:1], SEED, LR)
    two = ref.train_steps(a, one["params"], one["bn_state"], rb[1:2], SEED, LR, past_grads=[one["grads"]])
    three = ref.train_steps(a, two["params"], two["bn_state"], rb[2:], SEED, LR,
                            past_grads=[one["grads"], two["grads"]])
    assert torch.equal(torch.cat([one["losses"], two["losses"], three["losses"]]), run["losses"])
    assert all(torch.equal(three["params"][k], run["params"][k]) for k in p0)
    assert all(torch.equal(three["bn_state"][k], run["bn_state"][k]) for k in s0)


def _half_batch(monkeypatch):
    orig = Solver._classify_train_step

    def half(self, params, bn_state, opt, *, batch, **kw):
        rows = len(batch["data"]) // 2
        return orig(self, params, bn_state, opt, batch={k: v[:rows] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(Solver, "_classify_train_step", half)


def _optimizer(monkeypatch, lr_scale=1.0, momentum=0.9, weight_decay=0.0):
    from electrocardio_panorama_tpu_torch.training import optim

    def sgd(cfg, params):
        return torch.optim.SGD(list(params.values()), lr=cfg.SOLVER.lr * lr_scale, momentum=momentum,
                               weight_decay=weight_decay)

    monkeypatch.setattr(optim, "get_optimizer", sgd)


@pytest.mark.parametrize("fault", ["half_batch", "lr_1.3", "momentum_0.5", "weight_decay_5e-4"])
def test_classify_entry_catches_a_fault(fault, tiny_root, monkeypatch):
    """Each fault, planted in the program, turns `correct` false through the
    harness's comparison at the cell's limits."""
    if fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        _optimizer(monkeypatch, **{"lr_1.3": {"lr_scale": 1.3}, "momentum_0.5": {"momentum": 0.5},
                                   "weight_decay_5e-4": {"weight_decay": 5e-4}}[fault])
    out = harness.run_cell(tiny_root, "resnet1d50.train.f32.b64", SEED, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"] is False, out["check"]


@pytest.mark.cuda
def test_control_in_tf32_fails_the_cells_limits():
    """The reference in TF32 in the program's place, at the cell's own size
    (the published widths, 64 records of 8 x 5000), exceeds one of the
    cell's limits, where the program's own steps stay within all."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    import tempfile

    cell = harness.load_cell(REPO, "resnet1d50.train.f32.b64")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as d:
        st = entry.setup(harness.Context(cell, SEED, dev, harness.program_cfg(cell, SEED, d), None, None))
    for name in ("solver", "opt", "params", "bn_state"):
        delattr(st, name)
    limits = cell.spec["limits"]
    sound = entry.worst(entry.readings_by_step(st))
    tf32 = entry.worst(entry.readings_by_step(st, lambda st_, k, b: entry.reference_step(st_, k, b, tf32=True)))
    assert all(sound[k] <= limits[k] for k in limits), (sound, limits)
    assert any(tf32[k] > limits[k] for k in limits), (tf32, limits)


def test_resnet_readers_read_the_forward_span(tiny_root, monkeypatch):
    cell = harness.load_cell(tiny_root, "resnet1d50.train.f32.b64")
    spans = [{"name": "ecgpan.train_step", "parent": None}] * 4
    by_name = {"ecgpan.resnet1d.forward": {"calls": 4, "host_ms": 8.0, "self_ms": 1.0, "device_ms": 40.0}}
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": spans, "by_name": by_name, "dropped": 0})
    run = harness.Run(cell, {"attempted": 0}, {"attempted": 4}, trace=object())
    ms = harness.load_reader(tiny_root, "resnet_forward_device_ms.train")(run)
    assert ms == pytest.approx(10.0)
    share = harness.load_reader(tiny_root, "resnet_forward_roofline")(run)
    assert share == pytest.approx(100 * counts.forward_flops(2) / 0.010 / 67e12)
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": spans, "by_name": {}, "dropped": 0})
    assert harness.load_reader(tiny_root, "resnet_forward_roofline")(run) is None
    assert harness.load_reader(tiny_root, "resnet_forward_device_ms.train")(harness.Run(cell, {})) is None
