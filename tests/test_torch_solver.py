"""The port's Solver and entry points on the CPU, on a tiny synthetic corpus
(B=4, 3 leads, two steps per epoch): train two epochs, resume, validate;
the run lock, the empty-epoch warning, the NaN guard, the explicit-resume
check, best tracking across resume, the knobs that raise; a step with the
fused train decoder against the eager one; and the on-device PSNR/SSIM
against the JAX package's.
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.training import metrics as JM
from electrocardio_panorama_tpu_torch import main as train_main
from electrocardio_panorama_tpu_torch import val_net
from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.data import BeatLoader, build_dataset
from electrocardio_panorama_tpu_torch.training import metrics as M
from electrocardio_panorama_tpu_torch.training import solver as S
from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer


@pytest.fixture(scope="module")
def base_cfg(tmp_path_factory):
    cfg = get_cfg()
    cfg.desc = "smoke"
    cfg.DATA.dataset = "synthetic"
    cfg.DATA.lead_num = 3
    cfg.DATA.super_mode = "IIv2v5_v4I_372"
    cfg.DATA.train_data_mode = "input_fix"
    cfg.DATA.batch_size = 4
    cfg.MODEL.model = "model_nefnet"
    cfg.MODEL.jitter_factor = 2.5
    cfg.SOLVER.epochs = 2
    cfg.SOLVER.lr = 0.05
    cfg.SOLVER.scheduler = "MultiStep"
    cfg.SOLVER.lr_step = [50, 100]
    cfg.SOLVER.loss_factor = [0.5, 0.5, 1]
    cfg.TPU.steps_per_epoch = 2
    cfg.DATA.synthetic_root = str(tmp_path_factory.mktemp("synth"))
    cfg.output_dir = str(tmp_path_factory.mktemp("out"))
    return cfg


def loaders(cfg):
    return (BeatLoader(build_dataset(cfg, "train"), cfg.DATA.batch_size, shuffle=True, drop_last=True, seed=1),
            BeatLoader(build_dataset(cfg, "test"), cfg.DATA.batch_size, shuffle=False, drop_last=True, seed=2))


def test_train_resume_and_val(base_cfg, capsys):
    cfg = base_cfg.clone()
    cfg.TPU.train_encoder = "fused"  # the fused pair's plain version on the CPU
    train_main.main(cfg, device="cpu")
    out_dir = os.path.join(cfg.output_dir, cfg.desc)
    for name in ("epoch_0.pkl", "epoch_1.pkl", "best_valid.pkl", "last_checkpoint"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    params, bn, opt, extras = CheckPointer(out_dir).load()
    assert extras["epoch"] == 1 and set(extras) == {"epoch", "psnr_gen", "psnr_reg", "best_test_psnr_gen"}
    assert extras["best_test_psnr_gen"] >= extras["psnr_gen"] > 0
    assert opt["name"] == "sgd" and set(opt["state"]) == set(params)
    assert int(bn["decoder.1.double_conv.1.num_batches_tracked"]) == 2 * 2 * 3  # epochs x steps x groups
    rows = [json.loads(line) for line in open(os.path.join(cfg.output_dir, "tf_logs", "scalars.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1]

    # resume: a third epoch picks up at epoch 2, with the best carried over
    cfg.SOLVER.epochs = 3
    best = extras["best_test_psnr_gen"]
    solver = train_main.main(cfg, device="cpu")
    assert "resumed from epoch 2" in capsys.readouterr().out
    assert list(solver.history) == [2]
    _, bn3, _, ex3 = CheckPointer(out_dir).load()
    assert ex3["epoch"] == 2 and ex3["best_test_psnr_gen"] >= best
    assert int(bn3["decoder.1.double_conv.1.num_batches_tracked"]) == 3 * 2 * 3
    rows = [json.loads(line) for line in open(os.path.join(cfg.output_dir, "tf_logs", "scalars.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1, 2]

    # validation entry point: best_valid and an explicit epoch
    m = val_net.main(cfg, device="cpu")
    assert set(m) == {"psnr_gen", "psnr_reg", "ssim_gen", "ssim_reg"}
    assert all(np.isfinite(v) for v in m.values())
    assert np.isfinite(val_net.main(cfg, epoch=1, device="cpu")["psnr_gen"])


def test_resume_reproduces_the_uninterrupted_run(base_cfg, tmp_path):
    """Masks and shuffles are functions of (seed, epoch, step), so epochs
    0-1 in one run equal epoch 0, then a resumed epoch 1."""
    runs = {}
    for name, splits in (("whole", [2]), ("resumed", [1, 2])):
        cfg = base_cfg.clone()
        cfg.output_dir = str(tmp_path / name)
        for epochs in splits:
            cfg.SOLVER.epochs = epochs
            train_main.main(cfg, device="cpu")
        runs[name] = CheckPointer(os.path.join(cfg.output_dir, cfg.desc)).load()
    (pa, ba, oa, ea), (pb, bb, ob, eb) = runs["whole"], runs["resumed"]
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)
        np.testing.assert_array_equal(oa["state"][k]["momentum_buffer"], ob["state"][k]["momentum_buffer"])
    for k in ba:
        torch.testing.assert_close(ba[k], bb[k], rtol=0, atol=0)
    assert ea == eb


def test_run_lock_rejects_second_trainer(base_cfg, tmp_path):
    c = base_cfg.clone()
    c.output_dir = str(tmp_path)
    a, b = S.Solver(c, use_writer=False, device="cpu"), S.Solver(c, use_writer=False, device="cpu")
    lock = a._acquire_run_lock()
    with pytest.raises(RuntimeError, match="another trainer"):
        b._acquire_run_lock()
    lock.close()
    b._acquire_run_lock().close()


def test_run_lock_refusal_keeps_the_holders_pid(base_cfg, tmp_path, monkeypatch):
    """A refused trainer leaves the holder's `pid N` line: the file is opened
    without truncating and takes a pid only once its lock is held. Under a
    mesh only rank 0 takes the lock."""
    c = base_cfg.clone()
    c.output_dir = str(tmp_path)
    a, b = S.Solver(c, use_writer=False, device="cpu"), S.Solver(c, use_writer=False, device="cpu")
    path = tmp_path / ".train.lock"
    path.write_text("pid 1\nstale line\n")
    lock = a._acquire_run_lock()
    holder = f"pid {os.getpid()}\n"
    assert path.read_text() == holder
    monkeypatch.setattr(S.os, "getpid", lambda: 999999)  # the second trainer's pid
    with pytest.raises(RuntimeError, match="another trainer"):
        b._acquire_run_lock()
    assert path.read_text() == holder
    lock.close()
    b.rank0 = False
    assert b._acquire_run_lock() is None


def test_empty_epoch_warns(base_cfg, tmp_path, capsys):
    c = base_cfg.clone()
    c.DATA.batch_size = 10_000
    c.output_dir = str(tmp_path)
    dl, _ = loaders(c)
    s = S.Solver(c, use_writer=False, device="cpu")
    params, bn, opt = s.init_state()
    out = s.run_one_epoch(dl, "train", epoch=0, params=params, bn_state=bn, opt=opt)
    assert out["losses"].size == 0 and out["steps"] == 0
    assert "produced 0 batches" in capsys.readouterr().out


def test_nan_guard_names_the_step(base_cfg, tmp_path, monkeypatch):
    c = base_cfg.clone()
    c.TPU.steps_per_epoch = 3
    c.output_dir = str(tmp_path)
    dl, _ = loaders(c)
    s = S.Solver(c, use_writer=False, device="cpu")
    calls = {"n": 0}

    def poisoned(params, bn_state, opt, **kw):
        calls["n"] += 1
        return bn_state, torch.full((4,), float("nan") if calls["n"] == 2 else 0.0)

    monkeypatch.setattr(s, "train_step", poisoned)
    params, bn, opt = s.init_state()
    with pytest.raises(FloatingPointError, match="epoch 0 step 1"):
        s.run_one_epoch(dl, "train", epoch=0, params=params, bn_state=bn, opt=opt)
    c.TPU.check_nans = False
    s.run_one_epoch(dl, "train", epoch=0, params=params, bn_state=bn, opt=opt)


def test_explicit_resume_path_must_exist(base_cfg, tmp_path):
    c = base_cfg.clone()
    c.output_dir = str(tmp_path)
    c.MODEL.resume = str(tmp_path / "nope" / "epoch_7.pkl")
    with pytest.raises(FileNotFoundError, match="MODEL.resume"):
        train_main.main(c, device="cpu")


@pytest.mark.parametrize("key,value,err", [
    ("mesh_shape", [2], ValueError),
    ("checkpoint_backend", "orbax", NotImplementedError),
    ("train_decoder", "pallas", ValueError),
    ("train_decoder", "auto", ValueError),
    ("checkpoint_backend", "npz", ValueError),
    ("train_encoder", "pallas", ValueError),
    ("eval_decoder", "fast", ValueError),
    ("eval_encoder", "pallas", ValueError),
])
def test_unported_and_unknown_knobs_raise(base_cfg, tmp_path, key, value, err):
    c = base_cfg.clone()
    c.output_dir = str(tmp_path)
    c.TPU[key] = value
    with pytest.raises(err, match=key if err is ValueError else "ROADMAP"):
        S.Solver(c, use_writer=False, device="cpu")


def test_orbax_backend_raise_names_its_reason(base_cfg, tmp_path):
    """The orbax backend stays out of the port: the raise says that orbax
    imports jax, that tensorstore is not there, and that pickle crosses both
    packages."""
    c = base_cfg.clone()
    c.output_dir = str(tmp_path)
    c.TPU.checkpoint_backend = "orbax"
    with pytest.raises(NotImplementedError) as e:
        S.Solver(c, use_writer=False, device="cpu")
    msg = str(e.value)
    assert "orbax.checkpoint imports jax" in msg and "tensorstore" in msg, msg
    assert "'pickle', the checkpoint format that both packages read and write" in msg, msg


def test_knob_resolution(base_cfg, tmp_path):
    c = base_cfg.clone()
    c.output_dir = str(tmp_path)
    for dtype in ("float32", "bfloat16"):
        c.TPU.compute_dtype = dtype
        s = S.Solver(c, use_writer=False, device="cpu")
        assert (s.train_encoder, s.eval_decoder) == ("xla", "xla")  # 'auto' on the CPU
    c.TPU.train_encoder, c.TPU.eval_encoder, c.TPU.eval_decoder = "fused", "fused", "fused_bf16"
    s = S.Solver(c, use_writer=False, device="cpu")
    assert (s.train_encoder, s.eval_decoder) == ("fused", "fused_bf16") and s._eval_enc_fn is not None
    assert s.train_decoder == "xla" and s._train_dec_fn is None  # 'fused' is explicit: there is no 'auto'
    c.MODEL.model = "modelv2"
    with pytest.raises(ValueError):
        S.Solver(c, use_writer=False, device="cpu")
    assert S.step_seed(1, 2, 3) == S.step_seed(1, 2, 3) != S.step_seed(1, 2, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_fused_decoder_matches_xla(base_cfg, tmp_path, dtype):
    """TPU.train_decoder 'fused' (the pair's plain version on the CPU): one
    Solver step from the same init on the same batch equals the 'xla' step.
    float32: losses rtol 1e-4, params rtol 2e-4 / atol 2e-6, BN state rtol
    1e-4 / atol 1e-5 (the bars of tests/test_pallas_train_decoder.py:126-132).
    bfloat16: the eager path rounds after every op, the fused one only at
    the kernel's points, so losses rtol 2e-2 and the update of every
    parameter correlates at > 0.98 (biases before a train-mode BN, whose
    gradient is noise, left out)."""
    c = base_cfg.clone()
    c.output_dir = str(tmp_path)
    c.TPU.compute_dtype = dtype
    dl, _ = loaders(c)
    batch = next(iter(dl))
    results = {}
    for dec in ("xla", "fused"):
        c.TPU.train_decoder = dec
        s = S.Solver(c, use_writer=False, device="cpu")
        assert s.train_decoder == dec and (s._train_dec_fn is not None) == (dec == "fused")
        params, bn, opt = s.init_state()
        p0 = {k: v.detach().clone() for k, v in params.items()}
        bn, lvec = s.train_step(params, bn, opt, epoch=0, step=0, i1=1, i2=2, batch=batch)
        results[dec] = ({k: v.detach() for k, v in params.items()}, bn, lvec)
    (px, bx, lx), (pf, bf, lf) = results["xla"], results["fused"]
    assert set(bf) == set(bx)
    if dtype == "float32":
        torch.testing.assert_close(lf, lx, rtol=1e-4, atol=1e-6)
        for k in px:
            torch.testing.assert_close(pf[k], px[k], rtol=2e-4, atol=2e-6, msg=k)
        for k in bx:
            torch.testing.assert_close(bf[k].float(), bx[k].float(), rtol=1e-4, atol=1e-5, msg=k)
        return
    torch.testing.assert_close(lf, lx, rtol=2e-2, atol=1e-4)
    assert all(v.dtype == torch.float32 for k, v in bf.items() if "num_batches" not in k)
    for k in bx:
        torch.testing.assert_close(bf[k].float(), bx[k].float(), rtol=2e-2, atol=2e-3, msg=k)
    cancelled = tuple(f"decoder.{i}.double_conv.{j}.bias" for i in (1, 3) for j in (0, 3))
    for k in px:
        a, b = (pf[k] - p0[k]).flatten().numpy(), (px[k] - p0[k]).flatten().numpy()
        if k in cancelled or np.abs(b).max() == 0 or a.size == 1:
            continue
        assert np.corrcoef(a, b)[0, 1] > 0.98, k


def test_eval_step_fused_encoder_and_decoder_match_eager(base_cfg, tmp_path):
    """TPU.eval_encoder / eval_decoder 'fused' (their plain versions on the
    CPU) give the eager eval step's outputs and metrics."""
    c = base_cfg.clone()
    c.output_dir = str(tmp_path)
    _, dl = loaders(c)
    batch = next(iter(dl))
    eager = S.Solver(c, use_writer=False, device="cpu")
    params, bn, _ = eager.init_state()
    params = {k: v.detach() for k, v in params.items()}
    c.TPU.eval_encoder, c.TPU.eval_decoder = "fused", "fused"
    fused = S.Solver(c, use_writer=False, device="cpu")
    for a, b in zip(eager.eval_step(params, bn, batch), fused.eval_step(params, bn, batch)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=3e-5)


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 1, (4, 6, 512)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0, 1).astype(np.float32)
    gt[0, 0] = pred[0, 0]  # rmse 0 -> 100
    rois = np.zeros((4, 7, 2), np.float32)
    rois[:, -1, 0] = [512, 300, 97, 450]
    for ours_fn, jax_fn, tol in ((M.psnr_values, JM.psnr_values, 1e-4), (M.ssim_values, JM.ssim_values, 1e-5)):
        ours = ours_fn(torch.tensor(pred), torch.tensor(gt), torch.tensor(rois)).numpy()
        theirs = np.asarray(jax_fn(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(rois)))
        assert ours.shape == (4, 6)
        np.testing.assert_allclose(ours, theirs, atol=tol, rtol=1e-5)
    assert M.psnr_values(torch.tensor(pred), torch.tensor(gt), torch.tensor(rois))[0, 0] == 100.0
    # the scalar forms against the float64 oracles
    assert float(M.psnr_masked(torch.tensor(pred), torch.tensor(gt), torch.tensor(rois))) == pytest.approx(
        M.psnr(pred, gt, rois), rel=1e-5)
    assert float(M.ssim_masked(torch.tensor(pred), torch.tensor(gt), torch.tensor(rois))) == pytest.approx(
        M.ssim(pred, gt, rois), abs=1e-4)


def test_profile_dir_writes_a_trace(base_cfg, tmp_path):
    c = base_cfg.clone()
    c.output_dir = str(tmp_path / "out")
    c.SOLVER.epochs = 1
    c.TPU.steps_per_epoch = 1
    c.TPU.profile_dir = str(tmp_path / "trace")
    train_main.main(c, device="cpu")
    trace = json.load(open(tmp_path / "trace" / "train_trace.json"))
    assert trace["traceEvents"]
