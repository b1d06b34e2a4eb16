"""The port's Nef-Net2 against the JAX package and the reference golden, on the CPU.

Same numpy inputs and the same weights (JAX init, handed over through
`convert.params_from_jax`) go through both packages. Tolerances:
  * eval outputs and gen means against the golden
    (tests/goldens/nefnet2_lead3.npz, from the PyTorch reference): atol 3e-5,
    the JAX package's own bar (tests/test_nefnet2.py);
  * against the JAX package: atol 5e-5, the bar of tests/test_torch_nefnet.py
    (the encode chains a dozen convs and two ROI ops, summed in other orders);
  * the train branch (outputs and BN running statistics): atol 1e-5;
    `num_batches_tracked` exactly;
  * the grouped train decode through the fused pair's plain version against
    the eager grouped decode: out and updates atol 1e-6
    (tests/test_torch_decoder_train.py); every parameter gradient L2
    relative 5e-3 and corr > 0.9999, the A4 gradient bars of PERF.md
    section 2: a relu whose pre-activation sits within rounding of 0 may
    fall either way between two summation orders, and one flip moves a
    whole term of a per-channel sum (about 1e-3 of a gradient's L2 norm
    here, from the decoder down through the encoder);
  * two Solver steps and an eval epoch against the JAX Solver with dropout
    off on both sides: losses and eval metrics rtol 1e-4; the params apart
    by at most 1e-3 of the update's L2 size, chip_smoke.py's float32 train
    bar, and each parameter by at most 5e-3 of its own update (a few float32
    ulps of the params, and a relu flip, on updates of 1e-4).
The JAX side takes the port's dropout masks through a `dropout` that
multiplies by them in call order, which is what its own dropout computes
for a mask of 0 or 1/keep (tests/test_torch_train_ops.py).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.config import get_cfg as jax_get_cfg
from electrocardio_panorama_tpu.models import NefNet2Def as JaxNefNet2Def
from electrocardio_panorama_tpu.models import blocks as JB
from electrocardio_panorama_tpu.training.checkpoint import CheckPointer as JaxCheckPointer
from electrocardio_panorama_tpu.training.solver import Solver as JaxSolver
from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.models import NefNet2, NefNet2Def, ResNet1dDef, decoder_apply
from electrocardio_panorama_tpu_torch.models import nefnet2 as N2
from electrocardio_panorama_tpu_torch.ops import MEASURED, conv1d
from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as dt
from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as ef
from electrocardio_panorama_tpu_torch.training import solver as S
from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer
from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
from electrocardio_panorama_tpu_torch.training.torch_import import split_params_state

L = 3
# conv biases right before a train-mode BN: the batch mean cancels them, so
# their gradient is rounding noise on both sides
BN_CANCELLED = tuple(f"decoder.{i}.double_conv.{j}.bias" for i in (1, 3) for j in (0, 3))
ATOL, GOLDEN_ATOL, TRAIN_ATOL = 5e-5, 3e-5, 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "nefnet2_lead3.npz")


def make_inputs(rng, B, V):
    rois = []
    for _ in range(B):
        cuts = np.sort(rng.choice(np.arange(8, 504, 4), size=6, replace=False))
        pts = np.concatenate([[0], cuts, [512]])
        rois.append(np.stack([pts[:-1], pts[1:]], 1))
    return dict(
        x=rng.uniform(0, 1, (B, L, 512)).astype(np.float32),
        thetas=rng.uniform(-np.pi, np.pi, (B, L, 2)).astype(np.float32),
        query=rng.uniform(-np.pi, np.pi, (B, 2)).astype(np.float32),
        rois=np.stack(rois).astype(np.int64),
        views=rng.uniform(-np.pi, np.pi, (B, V, 2)).astype(np.float32),
    )


def args(inp, to):
    return [to(inp[k]) for k in ("x", "thetas", "query", "rois")]


@pytest.fixture(scope="module")
def weights():
    params, state = JaxNefNet2Def(L).init(jax.random.PRNGKey(3))
    tp, ts = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                             {k: np.asarray(v) for k, v in state.items()})
    return params, state, tp, ts


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    named = {k[len("param::"):]: torch.from_numpy(z[k]) for k in z.files if k.startswith("param::")}
    params, state = split_params_state(named)
    return z, params, state


def test_nefnet2_keys_and_shapes_match_jax_and_the_golden(golden):
    jp, js = JaxNefNet2Def(L).init(jax.random.PRNGKey(0))
    tp, ts = NefNet2Def(L).init(torch.Generator().manual_seed(0))
    assert set(tp) == set(jp) and set(ts) == set(js)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
    assert all(v.dtype == torch.int64 for k, v in ts.items() if k.endswith("num_batches_tracked"))
    # the module tree's keys are the reference checkpoint's, whatever the lead count
    _, gp, gs = golden
    NefNet2().load_state_dict({**gp, **gs}, strict=True)
    p1, _ = NefNet2Def(1).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p1[k], tp[k]) for k in tp)


def test_nefnet2_eval_and_gen_match_the_golden(golden):
    z, params, state = golden
    m = NefNet2Def(L)
    inp = [torch.from_numpy(z[k]) for k in ("x", "input_thetas", "query_theta", "rois")]
    (out, sp, sl, rest), s2 = m.apply(params, state, *inp, torch.from_numpy(z["rest_theta"]), phase="test",
                                      shuffle_idx=tuple(int(i) for i in z["shuffle_idx"]))
    assert s2 is state
    for name, v in (("out", out), ("shuffle_p", sp), ("shuffle_l", sl), ("rest_out", rest)):
        np.testing.assert_allclose(v.numpy(), z[f"eval.{name}"], atol=GOLDEN_ATOL, rtol=0, err_msg=name)
    (z1m, z2m), _ = m.apply(params, state, *inp, phase="gen")
    np.testing.assert_allclose(z1m.numpy(), z["gen.z1_mean"], atol=GOLDEN_ATOL, rtol=0)
    np.testing.assert_allclose(z2m.numpy(), z["gen.z2_mean"], atol=GOLDEN_ATOL, rtol=0)


@pytest.mark.parametrize("phase", ["test", "gen"])
def test_nefnet2_eval_phases_and_encode_match_jax(weights, rng, phase):
    jp, js, tp, ts = weights
    inp = make_inputs(rng, 2, 5)
    jm, tm = JaxNefNet2Def(L), NefNet2Def(L)
    jout, _ = jm.apply(jp, js, *args(inp, jnp.asarray), jnp.asarray(inp["views"]), phase=phase,
                       shuffle_idx=(2, 1))
    tout, _ = tm.apply(tp, ts, *args(inp, torch.tensor), torch.tensor(inp["views"]), phase=phase,
                       shuffle_idx=(2, 1))
    assert len(tout) == len(jout) == (2 if phase == "gen" else 4)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    if phase == "gen":
        jl = jm.encode(jp, *(jnp.asarray(inp[k]) for k in ("x", "thetas", "rois")))
        tl = tm.encode(tp, *(torch.tensor(inp[k]) for k in ("x", "thetas", "rois")))
        for name in jl._fields:
            np.testing.assert_allclose(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)), atol=ATOL,
                                       rtol=0, err_msg=name)
        # the decode of the latent is Nef-Net's
        np.testing.assert_allclose(
            tm.decode_views(tp, ts, tl.latent_all, torch.tensor(inp["views"])).numpy(),
            np.asarray(jm.decode_views(jp, js, jl.latent_all, jnp.asarray(inp["views"]))), atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError, match="pre-reverse"):
        tm.encode(tp, *(torch.tensor(inp[k]) for k in ("x", "thetas", "rois")), stop_before_reverse=True)
    with pytest.raises(NotImplementedError, match="gen_ecg"):
        tm.gen_ecg(tp, ts)
    with pytest.raises(KeyError, match="phase"):
        tm.apply(tp, ts, *args(inp, torch.tensor), phase="other")


def masked_jax_dropout(masks, monkeypatch):
    """The JAX blocks' dropout, replaced by `x * mask` over `masks` in call order."""
    queue = iter([jnp.asarray(m.numpy()) for m in masks])
    monkeypatch.setattr(JB, "dropout", lambda x, rate, rng, train: x * next(queue) if train and rng is not None
                        else x)


@pytest.mark.parametrize("dropout", [False, True], ids=["dropout_off", "port_masks"])
def test_nefnet2_train_branch_matches_jax(weights, rng, monkeypatch, dropout):
    """Outputs and BN state of phase 'train'. With the port's masks, the JAX
    blocks take them in call order: the tower's three blocks, w_conv,
    z1_conv, z2_conv1, z2_conv2.0 and z2_conv2.2, which is the order and
    layout of `draw_masks` over the folded batch."""
    jp, js, tp, ts = weights
    B = 2
    inp = make_inputs(rng, B, 5)
    tm = NefNet2Def(L)
    masks = tm.draw_masks(torch.Generator().manual_seed(7), B) if dropout else None
    if dropout:
        m6, mc20, mc22 = masks
        assert (m6.shape, mc20.shape, mc22.shape) == ((6, B * L, 128, 128), (B * L, 896, 16), (B * L, 896, 32))
        masked_jax_dropout([*m6, mc20, mc22], monkeypatch)
    (o1, o2, o3), new_s = tm.apply(tp, ts, *args(inp, torch.tensor), phase="train", masks=masks,
                                   shuffle_idx=(1, 2))
    (j1, j2, j3), jnew = JaxNefNet2Def(L).apply(jp, js, *args(inp, jnp.asarray), phase="train",
                                                rng=jax.random.PRNGKey(0) if dropout else None, shuffle_idx=(1, 2))
    for a, b in ((o1, j1), (o2, j2), (o3, j3)):
        assert a.shape == (B, 1, 512)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=TRAIN_ATOL, rtol=0)
    assert set(new_s) == set(jnew)
    for k, v in new_s.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ts[k]) + 3 == int(jnew[k]), k
        else:
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jnew[k]), atol=TRAIN_ATOL, rtol=0,
                                       err_msg=k)
    if dropout:  # the masks changed the result
        (e1, _, _), _ = tm.apply(tp, ts, *args(inp, torch.tensor), phase="train", shuffle_idx=(1, 2))
        assert not torch.allclose(e1, o1, atol=1e-3)


def test_nefnet2_fused_train_decode_plain_matches_eager_grouped(weights, rng):
    """The train branch through `make_train_decode_fn` (on the CPU the fused
    pair's plain version) against the eager `decoder_apply(bn_groups=3)`:
    the same three groups of B, BN statistics per group, running statistics
    chained in group order, num_batches_tracked + 3."""
    _, _, tp, ts = weights
    B = 2
    inp = make_inputs(rng, B, 5)
    tm = NefNet2Def(L)
    masks = tm.draw_masks(torch.Generator().manual_seed(8), B)
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    seen = {}

    def eager(p_, s_, stacked):
        seen["stacked"] = stacked
        o, u = decoder_apply(p_, s_, stacked, train=True, bn_groups=3)
        return torch.sigmoid(o / 3.0).reshape(3, B, 1, 512), u

    runs = {}
    for name, fn in (("eager", eager), ("fused", dt.make_train_decode_fn(torch.float32))):
        outs, new_s = tm.apply(p, ts, *args(inp, torch.tensor), phase="train", masks=masks, shuffle_idx=(0, 2),
                               train_decode_fn=fn)
        loss = sum((o * (i + 1)).mean() for i, o in enumerate(outs))
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        # unused: w_feature_extractor and the 1x1 residual convs of blocks whose widths match
        runs[name] = (outs, new_s, {k: g for k, g in zip(p, grads) if g is not None})
    assert seen["stacked"].shape == (3 * B, 256, 128)
    (eo, es, eg), (fo, fs, fg) = runs["eager"], runs["fused"]
    for a, b in zip(fo, eo):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert set(fs) == set(es)
    for k in es:
        torch.testing.assert_close(fs[k], es[k], rtol=1e-6, atol=1e-6, msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(fs[k]) == int(ts[k]) + 3
    assert set(fg) == set(eg) and len(eg) == len(p) - 6
    for k, g in eg.items():
        if k in BN_CANCELLED:
            assert float(fg[k].abs().max()) < 1e-4 and float(g.abs().max()) < 1e-4, k
            continue
        a, b = fg[k].flatten().double(), g.flatten().double()
        assert float((a - b).norm() / b.norm()) <= 5e-3, k
        assert a.numel() == 1 or float(torch.corrcoef(torch.stack([a, b]))[0, 1]) > 0.9999, k


# ---------------------------------------------------------------------- Solver
def configure(cfg, root):
    cfg.desc = "n2"
    cfg.output_dir = str(root / "out")
    cfg.DATA.dataset = "synthetic"
    cfg.DATA.synthetic_root = str(root / "synth")
    cfg.DATA.lead_num = L
    cfg.DATA.super_mode = "IIv2v5_v4I_372"
    cfg.DATA.train_data_mode = "input_fix"
    cfg.DATA.batch_size = 4
    cfg.MODEL.model = "model_nefnet2"
    cfg.MODEL.jitter_factor = 2.5
    cfg.SOLVER.lr = 0.05
    cfg.SOLVER.loss_factor = [0.5, 0.5, 1]
    cfg.TPU.steps_per_epoch = 2
    return cfg


def test_nefnet2_solver_steps_and_eval_match_jax_solver(tmp_path, monkeypatch):
    """Two train steps and an eval epoch of `model_nefnet2` through the
    port's Solver (train_decoder 'fused': the pair's plain version) and the
    JAX Solver, from the same init on the same batches, dropout off on both
    sides (JAX: no dropout key; the port: no masks)."""
    cfg = configure(get_cfg(), tmp_path)
    cfg.TPU.train_decoder = "fused"
    jcfg = configure(jax_get_cfg(), tmp_path)
    train = [b for _, b in zip(range(2), BeatLoader(build_dataset(cfg, "train"), 4, shuffle=True,
                                                      drop_last=True, seed=1))]
    test = [b for _, b in zip(range(2), BeatLoader(build_dataset(cfg, "test"), 4, shuffle=False,
                                                     drop_last=True, seed=2))]
    jsolver = JaxSolver(jcfg, use_writer=False)
    jp, js = jsolver.model.init(jax.random.PRNGKey(5))
    p0 = {k: np.asarray(v).copy() for k, v in jp.items()}
    s0 = {k: np.asarray(v).copy() for k, v in js.items()}  # the step donates its inputs
    jtr = jsolver.run_one_epoch(train, "train", epoch=0, params=jp, bn_state=js, opt_state=jsolver.tx.init(jp))
    jte = jsolver.run_one_epoch(test, "test", epoch=0, params=jtr["params"], bn_state=jtr["bn_state"])

    solver = S.Solver(cfg, use_writer=False, device="cpu")
    assert (solver.train_encoder, solver.train_decoder, solver.eval_decoder) == ("xla", "fused", "xla")
    monkeypatch.setattr(solver, "draw_masks", lambda gen, B: None)
    tp, ts = params_from_jax(p0, s0)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tr = solver.run_one_epoch(train, "train", epoch=0, params=tp, bn_state=ts, opt=get_optimizer(cfg, tp))
    te = solver.run_one_epoch(test, "test", epoch=0, params=tp, bn_state=tr["bn_state"])

    np.testing.assert_allclose(tr["losses"], jtr["losses"], rtol=1e-4, atol=1e-6)
    diff = {k: v.detach().numpy() - np.asarray(jtr["params"][k]) for k, v in tp.items()}
    upd = {k: np.asarray(jtr["params"][k]) - p0[k] for k in tp}
    flat = lambda d: np.concatenate([v.ravel() for v in d.values()])  # noqa: E731
    assert np.linalg.norm(flat(diff)) <= 1e-3 * np.linalg.norm(flat(upd))
    for k in tp:
        if k in BN_CANCELLED:
            assert np.abs(diff[k]).max() <= 1e-7, k
        else:
            assert np.linalg.norm(diff[k]) <= 5e-3 * np.linalg.norm(upd[k]) or not upd[k].any(), k
    for k, v in tr["bn_state"].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(jtr["bn_state"][k]) == 2 * 3, k
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(jtr["bn_state"][k]), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(te["losses"], jte["losses"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(te["metrics"], jte["metrics"], rtol=1e-4, atol=1e-5)


# encode_latents2's convolutions, counted from the code: conv1 and the
# tower's three BasicBlocks (1 + 3 x 2); w_conv (2: 128 -> 128 skips the
# residual conv); z1_conv and z2_conv1 (3 each: 64 -> 128 takes it);
# single_conv_z1; z2_conv2.0 (2: 896 -> 896); z2_conv2.2 (3: 448 -> 896);
# single_conv_z2. The ConvTranspose stays on the heuristic.
ENCODE_CONVS = 1 + 3 * 2 + 2 + 3 + 3 + 1 + 2 + 3 + 1


def one_train_step(solver, p0, s0, batch, **shuffle):
    """(loss vector, gradients, parameters after, BN state, MEASURED) of one
    Solver.train_step from copies of (p0, s0)."""
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    opt = get_optimizer(solver.cfg, p)
    MEASURED.clear()
    s, lvec = solver.train_step(p, {k: v.clone() for k, v in s0.items()}, opt, epoch=0, step=0, batch=batch,
                                **shuffle)
    return lvec, {k: v.grad for k, v in p.items()}, {k: v.detach() for k, v in p.items()}, s, dict(MEASURED)


def test_nefnet2_step_through_measured_convs_is_the_conv1d_step_bitwise(tmp_path, monkeypatch):
    """One Solver step of the cell's form (eager encoder, the fused decoder
    pair's plain version, dropout on) with the encode's convolutions through
    `conv1d_measured` against the same step with `conv1d` everywhere: the
    same loss, gradients, parameters and BN state, bit for bit; MEASURED
    counts each encode convolution once forward and once backward."""
    cfg = configure(get_cfg(), tmp_path)
    cfg.TPU.train_decoder = "fused"
    batch = next(iter(BeatLoader(build_dataset(cfg, "train"), 2, shuffle=True, drop_last=True, seed=1)))
    solver = S.Solver(cfg, use_writer=False, device="cpu")
    p0, s0 = NefNet2Def(L).init(torch.Generator().manual_seed(6))
    measured = one_train_step(solver, p0, s0, batch, i1=1, i2=2)
    monkeypatch.setattr(N2, "conv1d_measured", conv1d)
    plain = one_train_step(solver, p0, s0, batch, i1=1, i2=2)
    assert measured[4] == {"fwd": ENCODE_CONVS, "bwd": ENCODE_CONVS} and plain[4] == {}
    assert torch.equal(measured[0], plain[0])
    for ours, want in zip(measured[1:4], plain[1:4]):
        assert set(ours) == set(want)
        for k in want:
            assert (ours[k] is None and want[k] is None) or torch.equal(ours[k], want[k]), k


@pytest.mark.parametrize("model", ["nefnet_eager", "nefnet_fused_plain", "resnet1d"])
def test_other_models_steps_leave_measured_at_zero(tmp_path, monkeypatch, model):
    """Nef-Net's convolutions (eager, and the fused pairs' plain versions) and
    the classifier's keep `conv1d` under the heuristic."""
    cfg = configure(get_cfg(), tmp_path)
    shuffle = dict(i1=0, i2=1)
    if model == "resnet1d":
        cfg.MODEL.model, cfg.MODEL.arch, cfg.MODEL.loss = "model_resnet1d", "resnet50", "bce"
        cfg.MODEL.num_classes, cfg.DATA.in_channel, cfg.DATA.lead_num = 5, 8, 1
        narrow = ResNet1dDef("resnet50", 8, 5, 1, init_channels=4)
        monkeypatch.setattr(S, "build_model", lambda c: narrow)
        rng = np.random.default_rng(0)
        batch = {"data": rng.standard_normal((2, 8, 300)).astype(np.float32),
                 "label": (rng.uniform(size=(2, 5)) < 0.3).astype(np.float32)}
        p0, s0 = narrow.init(torch.Generator().manual_seed(6))
        shuffle = {}
    else:
        cfg.MODEL.model = "model_nefnet"
        if model == "nefnet_fused_plain":
            cfg.TPU.train_encoder = cfg.TPU.train_decoder = "fused"
        batch = next(iter(BeatLoader(build_dataset(cfg, "train"), 2, shuffle=True, drop_last=True, seed=1)))
    solver = S.Solver(cfg, use_writer=False, device="cpu")
    if model != "resnet1d":
        assert solver.train_encoder == ("fused" if model == "nefnet_fused_plain" else "xla")
        p0, s0 = solver.model.init(torch.Generator().manual_seed(6))
    lvec, grads, *_, counts = one_train_step(solver, p0, s0, batch, **shuffle)
    assert bool(torch.isfinite(lvec).all()) and any(g is not None for g in grads.values())
    assert counts == {}


@pytest.mark.parametrize("knob", ["train_encoder", "eval_encoder"])
def test_nefnet2_fused_encoder_raises(tmp_path, knob):
    cfg = configure(get_cfg(), tmp_path)
    cfg.TPU[knob] = "fused"
    with pytest.raises(ValueError, match="model_nefnet only: kernels A2/A3 compute Nef-Net's encoder"):
        S.Solver(cfg, use_writer=False, device="cpu")
    cfg.TPU[knob] = "xla" if knob == "eval_encoder" else "auto"
    assert S.Solver(cfg, use_writer=False, device="cpu").train_encoder == "xla"


def test_nefnet2_masks_and_nefnet_masks_unchanged(tmp_path):
    """The Solver asks Nef-Net2 for its own layout; Nef-Net's masks are the
    fused encoder's draw, bit for bit, from the same generator calls."""
    cfg = configure(get_cfg(), tmp_path)
    n2 = S.Solver(cfg, use_writer=False, device="cpu").draw_masks(torch.Generator().manual_seed(4), 2)
    assert [tuple(m.shape) for m in n2] == [(6, 6, 128, 128), (6, 896, 16), (6, 896, 32)]
    cfg.MODEL.model = "model_nefnet"
    n1 = S.Solver(cfg, use_writer=False, device="cpu").draw_masks(torch.Generator().manual_seed(4), 2)
    ref = ef.draw_masks(torch.Generator().manual_seed(4), 2, L)
    assert [tuple(m.shape) for m in n1] == [(6, 2, 384, 128), (2, 2688, 16), (2, 2688, 32)]
    assert all(torch.equal(a, b) for a, b in zip(n1, ref))
    # the same draws in another layout: Nef-Net2's counts equal Nef-Net's
    assert [m.numel() for m in n1] == [m.numel() for m in n2]


def test_nefnet2_checkpoints_cross_between_packages(weights, tmp_path):
    jp, js, tp, ts = weights
    ts = {k: (v + 5 if k.endswith("num_batches_tracked") else v + 0.25) for k, v in ts.items()}
    CheckPointer(str(tmp_path / "port")).save("best_valid", params=tp, bn_state=ts, epoch=2)
    p, s, _, extras = JaxCheckPointer(str(tmp_path / "port")).load(best_valid=True)
    assert extras["epoch"] == 2 and set(p) == set(tp) and set(s) == set(ts)
    for k in tp:
        np.testing.assert_array_equal(np.asarray(p[k]), tp[k].numpy())
    for k in ts:
        np.testing.assert_array_equal(np.asarray(s[k]), ts[k].numpy())
    JaxCheckPointer(str(tmp_path / "jax")).save("epoch_0", params=jp, bn_state=js, epoch=0)
    p, s, _, extras = CheckPointer(str(tmp_path / "jax")).load()
    assert extras["epoch"] == 0
    for k in jp:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    for k in js:
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))
    # and the loaded weights run the port's model
    NefNet2().load_state_dict({**p, **s}, strict=True)
