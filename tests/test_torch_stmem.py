"""ST-MEM's ViT classifier (MODEL.model 'model_st_mem_vit') on the port's
training path, against the benchmark's plain reference
(portbench/reference/stmem.py), on the CPU at a tiny cut: width 64, 2
blocks, 4 heads of 16, MLP 256, 3 leads x 300 samples in patches of 25, 5
labels, seeded random weights drawn as the benchmark draws them
(portbench/entries/classify_vit.py).

  * `Solver.train_step` against the reference: the forward, the loss, every
    gradient and the parameters after two Adam steps, in float64 (params,
    records; the step's code is the float32 one) at 1e-9 and in float32 at
    the port's f32 bars; the reference restarted from a run's own state
    continues that run bit for bit;
  * the plain attention against SDPA's math backend, and the ATTENTION
    counter;
  * the embedding's layout: moving one lead's samples changes only that
    lead's tokens before the first block;
  * the data layer's 12-lead, 250 Hz records against the entry's own
    derivation;
  * the counts against the published figures and
    `torch.utils.flop_counter.FlopCounterMode`;
  * build_model's and check_knobs' errors; the classifier definitions share
    their eval readings;
  * one epoch of `main.py` and `val_net.py` from configs/stmem_vit_b_synthetic.yml
    on the synthetic labelled corpus, at the narrow widths;
  * the benchmark's classify_vit entry through the harness at the narrow
    widths on the cell's own 12 x 2250 input, the cell run in float64 so that
    its published limits read rounding of float64 at any thread count: a
    sound run is correct; a step on half of each batch, and Adam at 1.3 times
    the learning rate, at beta1 0.5 or with a weight decay of 1e-4, are not;
    on the card, the reference in TF32 in the program's place fails the
    cell's own limits at the cell's own size;
  * the four new per-layer readers on a recorded snapshot, and the spans.
"""

import json
import os
import pickle
import shutil
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from electrocardio_panorama_tpu_torch import main as train_main
from electrocardio_panorama_tpu_torch import val_net
from electrocardio_panorama_tpu_torch.config import get_cfg, load_cfg
from electrocardio_panorama_tpu_torch.data import build_dataset
from electrocardio_panorama_tpu_torch.data.tianchi import twelve_leads_250hz
from electrocardio_panorama_tpu_torch.models import ResNet1dDef, STMEMViTDef, build_model
from electrocardio_panorama_tpu_torch.models.stmem import embed, param_shapes, stmem_meta
from electrocardio_panorama_tpu_torch.ops import attention as attention_ops
from electrocardio_panorama_tpu_torch.training import solver as solver_module
from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
from electrocardio_panorama_tpu_torch.training.solver import Solver
from electrocardio_panorama_tpu_torch.utils import profiling
from portbench import compare, harness
from portbench.counts import stmem_vit_b as counts
from portbench.entries import classify
from portbench.entries import classify_vit as entry
from portbench.reference import stmem as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "stmem_vit_b.train.f32.b128"
NARROW = {"width": 64, "depth": 2, "heads": 4, "dim_head": 16, "mlp_dim": 256}
LEADS, T, PATCH, C, B, LR = 3, 300, 25, 5, 4, 1e-4
SEED = 2**33 + 27
F64_BAR = 1e-9   # float64 on both sides, the same equations: rounding at 1e-16 amplified over the steps
F32_LOSS_BAR = 1e-6
F32_GRAD_BAR = 1e-5    # the worst leaf's norm gap of a float32 gradient (8e-8 read)
F32_UPDATE_BAR = 1e-3  # Adam's first steps move each weight by about lr * sign(g): a gradient within
#                        rounding of 0 may take the other sign on either side (2e-5 read)


def tiny_arch(leads=LEADS, samples=T, patch=PATCH):
    return ref.Arch(patch=patch, leads=leads, samples=samples, num_classes=C, **NARROW)


def tiny_def(dtype=torch.float32):
    return STMEMViTDef("vit_base", LEADS, C, dtype, seq_len=T, patch=PATCH, **NARROW)


@pytest.fixture
def narrow(monkeypatch):
    """The Solver builds the ViT at the narrow widths, on vit_base's input
    (the config's leads of 2,250 samples, in patches of 75)."""
    build = solver_module.build_model

    def narrow_build(cfg):
        if cfg.MODEL.model != "model_st_mem_vit":
            return build(cfg)
        return STMEMViTDef(cfg.MODEL.arch, cfg.DATA.in_channel, cfg.MODEL.num_classes, **NARROW)

    monkeypatch.setattr(solver_module, "build_model", narrow_build)


@pytest.fixture
def tiny(monkeypatch):
    """The Solver builds the ViT at the tiny cut: the narrow widths over
    LEADS leads of T samples in patches of PATCH."""
    monkeypatch.setattr(solver_module, "build_model", lambda cfg: tiny_def())


def vit_cfg(tmp_path, leads=LEADS):
    cfg = get_cfg()
    cfg.MODEL.model, cfg.MODEL.arch, cfg.MODEL.loss = "model_st_mem_vit", "vit_base", "bce"
    cfg.MODEL.num_classes, cfg.DATA.in_channel = C, leads
    cfg.SOLVER.optim, cfg.SOLVER.lr, cfg.seed = "adam", LR, SEED
    cfg.output_dir, cfg.desc = str(tmp_path), "vit"
    return cfg


def records(dtype, steps=3):
    """`steps` batches of B records [B, LEADS, T] and labels."""
    rng = np.random.default_rng(SEED)
    return [{"data": rng.standard_normal((B, LEADS, T)).astype(dtype),
             "label": (rng.random((B, C)) < 0.3).astype(np.int64)} for _ in range(steps)]


def program_steps(cfg, dtype, steps):
    """The Solver's first `steps` Adam steps from the entry's weights:
    ({'losses', 'grads' (first step), 'params'}, the start, each step's
    gradients)."""
    s = Solver(cfg, use_writer=False, device="cpu")
    tdt = getattr(torch, dtype)
    params = entry.make_weights(tiny_arch(), SEED, torch.device("cpu"), tdt)
    p0 = {k: v.detach().clone() for k, v in params.items()}
    opt = get_optimizer(cfg, params)
    losses, grads = [], []
    for k, b in enumerate(records(dtype, steps)):
        state, lvec = s.train_step(params, {}, opt, epoch=0, step=k, batch=b)
        assert state == {}
        losses.append(lvec)
        grads.append({n: p.grad.clone() for n, p in params.items()})
    return {"losses": torch.stack(losses), "grads": grads[0], "params": {k: v.detach() for k, v in params.items()},
            "bn_state": {}}, p0, grads


def reference_batches(dtype, steps=3):
    tdt = getattr(torch, dtype)
    return [{"data": torch.as_tensor(b["data"]), "label": torch.as_tensor(b["label"]).to(tdt)}
            for b in records(dtype, steps)]


def rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def test_train_steps_match_reference_float64(tmp_path, tiny):
    got, p0, _ = program_steps(vit_cfg(tmp_path), "float64", 2)
    want = ref.train_steps(tiny_arch(), p0, reference_batches("float64", 2), LR)
    assert got["losses"].shape == (2, 1) and got["losses"].dtype == torch.float32
    # the step returns its loss vector in float32: one rounding of the float64 loss
    torch.testing.assert_close(got["losses"].double(), want["losses"].double(), rtol=2**-23, atol=0)
    assert set(got["grads"]) == set(want["grads"]) == set(p0)
    for k in p0:
        assert rel(got["grads"][k], want["grads"][k]) < F64_BAR, k
        assert rel(got["params"][k] - p0[k], want["params"][k] - p0[k]) < F64_BAR, k
    readings = compare.train_readings(got, want, p0, {})
    assert readings["loss_gap"] < 2**-23 and max(readings["grad_gap"], readings["update_gap"]) < F64_BAR


def test_train_steps_match_reference_float32(tmp_path, tiny):
    got, p0, _ = program_steps(vit_cfg(tmp_path), "float32", 2)
    want = ref.train_steps(tiny_arch(), p0, reference_batches("float32", 2), LR)
    r = compare.train_readings(got, want, p0, {})
    assert compare.loss_gaps(got, want)[1] < F32_LOSS_BAR
    assert r["loss_gap"] < F32_LOSS_BAR and r["grad_gap"] < F32_GRAD_BAR and r["update_gap"] < F32_UPDATE_BAR, r


def test_forward_matches_reference():
    model = tiny_def(dtype=torch.float64)
    p = entry.make_weights(tiny_arch(), SEED, torch.device("cpu"), torch.float64)
    x = torch.as_tensor(records("float64", 1)[0]["data"])
    probs, state = model.apply(p, {}, x, train=True, masks=model.draw_masks(torch.Generator(), B, T))
    assert state == {} and probs.shape == (B, C)
    assert rel(probs, ref.forward(tiny_arch(), p, x)) < 1e-14


def test_reference_restart_continues_its_run():
    """Steps restarted from the run's own state and earlier gradients
    (`past_grads`) reproduce the run bit for bit: the check's restarts
    change what is compared, not the reference's arithmetic."""
    a = tiny_arch()
    p0 = entry.make_weights(a, SEED, torch.device("cpu"))
    rb = reference_batches("float32")
    run = ref.train_steps(a, p0, rb, LR)
    one = ref.train_steps(a, p0, rb[:1], LR)
    two = ref.train_steps(a, one["params"], rb[1:2], LR, past_grads=[one["grads"]])
    three = ref.train_steps(a, two["params"], rb[2:], LR, past_grads=[one["grads"], two["grads"]])
    assert torch.equal(torch.cat([one["losses"], two["losses"], three["losses"]]), run["losses"])
    assert all(torch.equal(three["params"][k], run["params"][k]) for k in p0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_attention_matches_sdpa_math(dtype):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, 42, 16, generator=g, dtype=dtype, requires_grad=True) for _ in range(3))
    got = attention_ops.attention_plain(q, k, v, 0.25)
    with sdpa_kernel(SDPBackend.MATH):
        want = F.scaled_dot_product_attention(q, k, v, scale=0.25)
    bar = 1e-13 if dtype == torch.float64 else 1e-6
    assert rel(got, want) < bar
    w = torch.randn(got.shape, generator=g, dtype=dtype)
    for a, b in zip(torch.autograd.grad((got * w).sum(), (q, k, v)), torch.autograd.grad((want * w).sum(), (q, k, v))):
        assert rel(a, b) < bar


def test_attention_counts_the_plain_form_on_the_cpu():
    assert attention_ops.SDPA_BACKENDS == ("EFFICIENT_ATTENTION",)
    before = dict(attention_ops.ATTENTION)
    q = torch.randn(3, 2, 7, 8)
    out = attention_ops.attention(q, q, q, 8 ** -0.5)
    assert torch.equal(out, attention_ops.attention_plain(q, q, q, 8 ** -0.5))
    assert attention_ops.ATTENTION["plain"] - before.get("plain", 0) == 1
    assert attention_ops.ATTENTION["tokens"] - before.get("tokens", 0) == 21
    assert not any(k.startswith("sdpa.") and attention_ops.ATTENTION[k] != before.get(k, 0)
                   for k in attention_ops.ATTENTION)


def test_embedding_keeps_each_leads_tokens_apart():
    """Moving one lead's samples moves only that lead's n + 2 tokens, and
    its SEP tokens not at all (they carry no sample), before the first
    block."""
    model = tiny_def()
    p = entry.make_weights(tiny_arch(), SEED, torch.device("cpu"))
    x = torch.as_tensor(records("float32", 1)[0]["data"])
    n = T // PATCH
    base = embed(p, model.meta, x).reshape(B, LEADS, n + 2, NARROW["width"])
    for lead in range(LEADS):
        moved = x.clone()
        moved[:, lead] += 1.0
        got = embed(p, model.meta, moved).reshape(B, LEADS, n + 2, NARROW["width"])
        changed = (got != base).any(dim=(0, 3))  # [leads, n + 2]
        want = torch.zeros(LEADS, n + 2, dtype=torch.bool)
        want[lead, 1:n + 1] = True
        assert torch.equal(changed, want), lead
    # SEP tokens: sep + pos at the lead's two ends, plus the lead's embedding
    w = p["sep_embedding"] + p["lead_embeddings.1"]
    torch.testing.assert_close(base[0, 1, 0], w + p["pos_embedding"][0, 0])
    torch.testing.assert_close(base[0, 1, -1], w + p["pos_embedding"][0, -1])


def cls_cfg(tmp_path, n_train=6, n_test=2):
    cfg = vit_cfg(tmp_path, leads=12)
    cfg.DATA.dataset, cfg.DATA.cls_input = "tianchi_cls", "12lead_250hz"
    cfg.DATA.synthetic_root = str(tmp_path / "syn")
    cfg.DATA.synthetic_n_train, cfg.DATA.synthetic_n_test = n_train, n_test
    return cfg


def test_reader_gives_the_entrys_twelve_leads(tmp_path):
    cfg = cls_cfg(tmp_path)
    ds = build_dataset(cfg, "train")
    for i in range(3):
        ex = ds.__getitem__(i)
        assert ex["data"].shape == (12, 2250) and ex["data"].dtype == np.float32
        raw = np.load(os.path.join(ds.data_root, ds.files[i]))
        mine = twelve_leads_250hz(raw)
        np.testing.assert_allclose(mine, entry.twelve_leads_250hz(raw), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(ex["data"], mine.astype(np.float32))
        np.testing.assert_allclose(mine.mean(axis=1), 0, atol=1e-12)
        np.testing.assert_allclose(mine.std(axis=1), 1, atol=1e-12)
        # lead order I, II, III, aVR, aVL, aVF, V1..V6; every second sample
        d = raw.astype(np.float64)[:, :4500:2]
        for row, lead in ((0, d[0]), (2, d[1] - d[0]), (3, -(d[0] + d[1]) / 2), (6, d[2]), (11, d[7])):
            np.testing.assert_allclose(mine[row], (lead - lead.mean()) / lead.std(), atol=1e-12)
    cfg.DATA.cls_input = "raw"
    assert build_dataset(cfg, "train").__getitem__(0)["data"].shape == (8, 5000)
    cfg.DATA.cls_input = "12lead"
    with pytest.raises(ValueError, match="cls_input"):
        build_dataset(cfg, "train")
    mix = {"batch": 2, "pool": 2, "record_len": 5000, "label_p": 0.05, "layout": "12lead_250hz"}
    pool = entry.pool(mix, C, SEED)
    assert pool[0]["data"].shape == (2, 12, 2250) and pool[0]["data"].dtype == np.float32
    with pytest.raises(ValueError, match="layout"):
        entry.pool({**mix, "layout": "raw"}, C, SEED)


def test_counts_hold_the_published_figures():
    from torch.utils.flop_counter import FlopCounterMode

    assert counts.forward_flops(1) == pytest.approx(70.71e9, rel=1e-4)
    assert counts.attention_flops(1) == pytest.approx(5.44e9, rel=1e-3)
    assert counts.train_step_flops(128) == pytest.approx(27.146e12, rel=1e-4)
    assert counts.attention_bytes(128) == 4 * 128 * 12 * 384 * 64 * 4 * 12
    published = ref.Arch()
    assert sum(int(np.prod(s)) for _, s, _, _ in ref.param_table(published)) == 85_191_223
    assert published.tokens == 384
    a = tiny_arch()
    sizes = {"patch": PATCH, "leads": LEADS, "samples": T, "num_classes": C, **NARROW}
    p = entry.make_weights(a, SEED, torch.device("cpu"))
    x = torch.randn(2, LEADS, T)
    with FlopCounterMode(display=False) as fc:
        probs = ref.forward(a, p, x)
    assert fc.get_total_flops() == counts.forward_flops(2, **sizes)
    with FlopCounterMode(display=False) as fc:
        ref.bce(ref.forward(a, p, x), torch.zeros(2, C)).backward()
    assert fc.get_total_flops() == counts.train_step_flops(2, **sizes)
    assert probs.shape == (2, C)


def test_weights_and_reference_keys_match_the_program():
    model = tiny_def()
    params, state = model.init(torch.Generator().manual_seed(0))
    assert state == {}
    table = {name: shape for name, shape, _, _ in ref.param_table(tiny_arch())}
    assert {k: tuple(v.shape) for k, v in params.items()} == table == param_shapes(model.meta)
    assert all(torch.equal(params[f"block{i}.{n}.norm.weight"], torch.ones(64)) for i in range(2) for n in ("attn", "ff"))
    p = entry.make_weights(tiny_arch(), SEED, torch.device("cpu"))
    p2 = entry.make_weights(tiny_arch(), SEED, torch.device("cpu"))
    assert set(p) == set(params) and all(torch.equal(p[k], p2[k]) for k in p)
    assert all(v.requires_grad and v.is_leaf for v in p.values())


def test_build_model_and_knobs_raise_by_name(tmp_path, narrow):
    cfg = vit_cfg(tmp_path, leads=12)
    assert isinstance(build_model(cfg), STMEMViTDef)
    assert {k: build_model(cfg).meta[k] for k in ("width", "depth", "seq_len", "patch", "num_patches")} == {
        "width": 768, "depth": 12, "seq_len": 2250, "patch": 75, "num_patches": 30}
    bad = vit_cfg(tmp_path)
    bad.MODEL.arch = "vit_small"
    with pytest.raises(ValueError, match="vit_base"):
        build_model(bad)
    with pytest.raises(ValueError, match="multiple"):
        STMEMViTDef("vit_base", 12, C, patch=7)
    model = tiny_def()
    p = entry.make_weights(tiny_arch(), SEED, torch.device("cpu"))
    for shape in ((B, LEADS + 1, T), (B, LEADS, 2 * T)):  # another lead count, the raw 500 Hz record's length
        with pytest.raises(ValueError, match="cls_input"):
            model.apply(p, {}, torch.zeros(shape))
    bad = vit_cfg(tmp_path)
    bad.MODEL.model = "model_st_mem"
    with pytest.raises(ValueError, match="model_st_mem_vit"):
        build_model(bad)
    for knob, value in (("train_encoder", "fused"), ("eval_encoder", "fused"), ("train_decoder", "fused"),
                        ("mesh_shape", [1]), ("compute_dtype", "bfloat16")):
        bad = vit_cfg(tmp_path)
        bad.TPU[knob] = value
        with pytest.raises((ValueError, NotImplementedError), match="model_st_mem_vit"):
            Solver(bad, use_writer=False, device="cpu")
    s = Solver(vit_cfg(tmp_path), use_writer=False, device="cpu")
    assert s.model.classifier and s.train_step == s._classify_train_step and s.eval_step == s._classify_eval_step
    assert s._train_enc_fn is None and s._train_dec_fn is None and s._eval_enc_fn is None


def test_the_classifiers_share_their_eval_readings():
    for reading in ("epoch_scalars", "val_summary", "check_knobs"):
        assert getattr(STMEMViTDef, reading) is getattr(ResNet1dDef, reading), reading
    assert (STMEMViTDef.score, STMEMViTDef.loss_widths) == (ResNet1dDef.score, ResNet1dDef.loss_widths) == ("f1", (1, 1))
    assert stmem_meta("vit_base")["width"] == 768


def test_main_trains_and_val_reads_the_vit(tmp_path, capsys, narrow):
    cfg = load_cfg(os.path.join(REPO, "configs", "stmem_vit_b_synthetic.yml"), [])
    assert (cfg.MODEL.model, cfg.MODEL.arch, cfg.SOLVER.optim, cfg.SOLVER.lr) == ("model_st_mem_vit", "vit_base",
                                                                                 "adam", 1e-4)
    assert (cfg.DATA.in_channel, cfg.DATA.cls_input) == (12, "12lead_250hz")
    cfg.merge_from_list(["output_dir", str(tmp_path), "desc", "vit", "DATA.synthetic_root", str(tmp_path / "syn"),
                         "DATA.synthetic_n_train", 8, "DATA.synthetic_n_test", 3, "DATA.batch_size", 2,
                         "MODEL.num_classes", C, "SOLVER.epochs", 1, "TPU.steps_per_epoch", 2, "seed", 7])
    solver = train_main.main(cfg, device="cpu")
    assert solver.history[0]["train_steps"] == 2 and solver.history[0]["train_losses"].shape == (2, 1)
    assert set(solver.history[0]["scalars"]) == {"train_loss_all", "test_loss_all", "f1"}
    with open(os.path.join(str(tmp_path), "vit", "epoch_0.pkl"), "rb") as f:
        ck = pickle.load(f)
    assert set(ck["model"]) == set(param_shapes(solver.model.meta)) and not ck["bn_state"]
    assert ck["epoch"] == 0 and ck["best_test_f1"] == ck["f1"] and 0.0 <= ck["f1"] <= 1.0
    assert os.path.exists(os.path.join(str(tmp_path), "vit", "best_valid.pkl"))
    out = val_net.main(cfg, device="cpu")
    assert set(out) == {"loss", "f1"} and out["f1"] == pytest.approx(ck["f1"])
    assert "best_test_f1" in capsys.readouterr().out


@pytest.fixture
def tiny_root(tmp_path, narrow):
    """A checkout whose ViT cell runs at the narrow widths, 5 labels, batch
    2, on the cell's own 12 x 2250 records, in float64."""
    r = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(r, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), r)
    os.symlink(os.path.join(REPO, "electrocardio_panorama_tpu_torch"),
               os.path.join(r, "electrocardio_panorama_tpu_torch"))

    def rewrite(path, change):
        d = harness.read_json(path)
        change(d)
        with open(path, "w") as f:
            json.dump(d, f)

    def config(d):
        d["widths"].update(NARROW, num_classes=C)
        d["settings"]["MODEL"]["num_classes"] = C

    rewrite(os.path.join(r, "portbench", "configs", "stmem_vit_b.json"), config)
    rewrite(os.path.join(r, "portbench", "traffic", "classify12.b128.json"), lambda d: d.update(batch=2))
    rewrite(os.path.join(r, "portbench", "cells", f"{CELL}.json"), lambda d: d.update(dtype="float64"))
    return r


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_classify_vit_entry_runs_through_the_harness(threads, tiny_root, capsys):
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        out = harness.run_cell(tiny_root, CELL, SEED, 0.5, False, "cpu", time.perf_counter())
    finally:
        torch.set_num_threads(saved)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"setup_s", "train_samples_per_s", "peak_mem_gib"}
    assert set(out["check"]) == {"loss_gap", "grad_gap", "update_gap"}
    assert "classify_vit: ATTENTION after set-up" in capsys.readouterr().err
    cell = harness.load_cell(tiny_root, CELL)
    names = {m["name"] for m in cell.metrics["per_layer"]}
    assert {"stmem_forward_device_ms.train", "stmem_forward_roofline", "stmem_attention_device_ms.train",
            "stmem_attention_roofline", "train_mfu", "device_idle_share.train"} <= names
    assert not any(n.startswith(("a1_", "a2_", "a3_", "a4", "resnet_")) for n in names)


def _half_batch(monkeypatch):
    orig = Solver._classify_train_step

    def half(self, params, bn_state, opt, *, batch, **kw):
        rows = len(batch["data"]) // 2
        return orig(self, params, bn_state, opt, batch={k: v[:rows] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(Solver, "_classify_train_step", half)


def _adam(monkeypatch, lr_scale=1.0, beta1=0.9, weight_decay=0.0):
    from electrocardio_panorama_tpu_torch.training import optim

    def adam(cfg, params):
        return torch.optim.Adam(list(params.values()), lr=cfg.SOLVER.lr * lr_scale, betas=(beta1, 0.999),
                                weight_decay=weight_decay)

    monkeypatch.setattr(optim, "get_optimizer", adam)


@pytest.mark.parametrize("fault", ["half_batch", "lr_1.3", "beta1_0.5", "weight_decay_1e-4"])
def test_classify_vit_entry_catches_a_fault(fault, tiny_root, monkeypatch):
    """Each fault, planted in the program, turns `correct` false through the
    harness's comparison at the cell's limits."""
    if fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        _adam(monkeypatch, **{"lr_1.3": {"lr_scale": 1.3}, "beta1_0.5": {"beta1": 0.5},
                              "weight_decay_1e-4": {"weight_decay": 1e-4}}[fault])
    out = harness.run_cell(tiny_root, CELL, SEED, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"] is False, out["check"]


@pytest.mark.cuda
def test_control_in_tf32_fails_the_cells_limits():
    """The reference in TF32 in the program's place, at the cell's own size
    (the published widths, 128 records of 12 x 2250), exceeds one of the
    cell's limits, where the program's own steps stay within all."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    import tempfile

    cell = harness.load_cell(REPO, CELL)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as d:
        st = entry.setup(harness.Context(cell, SEED, dev, harness.program_cfg(cell, SEED, d), None, None))
    for name in ("solver", "opt", "params", "bn_state"):
        delattr(st, name)
    torch.cuda.empty_cache()
    limits = cell.spec["limits"]
    sound = classify.worst(entry.readings_by_step(st))
    tf32 = classify.worst(entry.readings_by_step(st, lambda st_, k, b: entry.reference_step(st_, k, b, tf32=True)))
    assert all(sound[k] <= limits[k] for k in limits), (sound, limits)
    assert any(tf32[k] > limits[k] for k in limits), (tf32, limits)


def test_stmem_readers_read_the_spans(monkeypatch):
    cell = harness.load_cell(REPO, CELL)
    spans = [{"name": "ecgpan.train_step", "parent": None}] * 4
    by_name = {"ecgpan.stmem.forward": {"calls": 4, "host_ms": 8.0, "self_ms": 1.0, "device_ms": 800.0},
               "ecgpan.stmem.attention": {"calls": 48, "host_ms": 1.0, "self_ms": 1.0, "device_ms": 160.0}}
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": spans, "by_name": by_name, "dropped": 0})
    run = harness.Run(cell, {"attempted": 0}, {"attempted": 4}, trace=object())
    assert harness.load_reader(REPO, "stmem_forward_device_ms.train")(run) == pytest.approx(200.0)
    assert harness.load_reader(REPO, "stmem_attention_device_ms.train")(run) == pytest.approx(40.0)
    share = harness.load_reader(REPO, "stmem_forward_roofline")(run)
    assert share == pytest.approx(100 * 128 * 70.707190272e9 / 0.200 / 67e12)
    bound = max(counts.attention_flops(128) / 67e12, counts.attention_bytes(128) / 3.35e12)
    assert bound == counts.attention_flops(128) / 67e12  # float32 attention is bound by arithmetic
    assert harness.load_reader(REPO, "stmem_attention_roofline")(run) == pytest.approx(100 * bound / 0.040)
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": spans, "by_name": {}, "dropped": 0})
    for name in ("stmem_forward_device_ms.train", "stmem_forward_roofline", "stmem_attention_device_ms.train",
                 "stmem_attention_roofline"):
        assert harness.load_reader(REPO, name)(run) is None
        assert harness.load_reader(REPO, name)(harness.Run(cell, {})) is None


def test_forward_records_its_spans():
    model = tiny_def()
    p = entry.make_weights(tiny_arch(), SEED, torch.device("cpu"))
    x = torch.as_tensor(records("float32", 1)[0]["data"])
    profiling.reset()
    with profiling.recording():
        model.apply(p, {}, x)
    calls = {name: v["calls"] for name, v in profiling.snapshot()["by_name"].items()}
    profiling.reset()
    assert calls == {"ecgpan.stmem.forward": 1, "ecgpan.stmem.embed": 1, "ecgpan.stmem.blocks": 1,
                     "ecgpan.stmem.head": 1, "ecgpan.stmem.attention": 2, "ecgpan.stmem.mlp": 2}
