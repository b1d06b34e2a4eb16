"""The port's render slice end to end on the CPU, against the JAX package.

A tiny synthetic corpus, a checkpoint written by the JAX package, then the
JAX `render.main` (XLA decoder) and the port's `render.main` (streamed-basis
decode, plain version on the CPU) on the same config. Tolerance: atol 5e-5
on `rest_out` in float32 (the whole encode + decode chain, summed in other
orders); the rois are identical because both packages draw the same beats.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from electrocardio_panorama_tpu import render as jax_render
from electrocardio_panorama_tpu.config import load_cfg as jax_load_cfg
from electrocardio_panorama_tpu.data import build_dataset as jax_build_dataset
from electrocardio_panorama_tpu.models.nefnet import init_nefnet as jax_init_nefnet
from electrocardio_panorama_tpu.training.checkpoint import CheckPointer as JaxCheckPointer
from electrocardio_panorama_tpu_torch import render
from electrocardio_panorama_tpu_torch.config import load_cfg
from electrocardio_panorama_tpu_torch.data import build_dataset
from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator, theta_grid
from electrocardio_panorama_tpu_torch.models import NefNet2Def, NefNetDef, init_nefnet, init_nefnet2
from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as TE
from electrocardio_panorama_tpu_torch.parallel import build_sharded_panorama, make_mesh
from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer

from _torch_ranks import no_group  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, "configs", "nef_net_synthetic.yml")


def overrides(tmp):
    return ["DATA.synthetic_root", str(tmp / "synth"), "DATA.synthetic_n_train", "2",
            "DATA.synthetic_n_test", "2", "output_dir", str(tmp / "out")]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("render")
    jcfg = jax_load_cfg(YML, overrides(tmp))
    params, state = jax_init_nefnet(jax.random.PRNGKey(0), lead_num=3)
    JaxCheckPointer(os.path.join(jcfg.output_dir, jcfg.desc)).save(
        "best_valid", params=params, bn_state=state, epoch=7)
    return tmp, jcfg


def test_render_main_matches_jax(corpus):
    tmp, jcfg = corpus
    ref, ref_rois = jax_render.main(jcfg, n_theta=3, n_phi=4, out_path=str(tmp / "jax.npz"))
    cfg = load_cfg(YML, overrides(tmp))
    out, rois = render.main(cfg, n_theta=3, n_phi=4, out_path=str(tmp / "port.npz"),
                            use_fused=True, device="cpu")
    z = np.load(tmp / "port.npz")
    assert set(z.files) == {"rest_out", "rois"}
    assert z["rest_out"].shape == (2, 12, 512) and z["rest_out"].dtype == np.float32
    np.testing.assert_allclose(z["rest_out"], np.load(tmp / "jax.npz")["rest_out"], atol=5e-5)
    np.testing.assert_array_equal(z["rois"], ref_rois)
    np.testing.assert_array_equal(rois, ref_rois)
    assert ((out > 0) & (out < 1)).all()


def test_render_cli_on_cpu_writes_npz_and_png(corpus):
    tmp, _ = corpus
    out, png = tmp / "cli.npz", tmp / "cli.png"
    proc = subprocess.run(
        [sys.executable, "-m", "electrocardio_panorama_tpu_torch.render", "--config-file", YML,
         "--fused", "--device", "cpu", "--n-theta", "3", "--n-phi", "4",
         "--out", str(out), "--plot", str(png), *overrides(tmp)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert np.load(out)["rest_out"].shape == (2, 12, 512)
    assert os.path.getsize(png) > 1000


def test_bf16_render_tracks_f32(corpus):
    """compute_dtype bfloat16 (bf16 encode, bf16-storage decode) stays within
    the bf16 bar of 1e-4 of float32. Random weights render nearly flat
    panoramas (std ~5e-5), so correlation says little here; the decode's
    correlation bar is held on encoder latents in test_torch_decoder_fused."""
    tmp, _ = corpus
    cfg = load_cfg(YML, overrides(tmp))
    f32, _ = render.main(cfg, n_theta=3, n_phi=4, out_path=str(tmp / "f32.npz"), use_fused=True,
                         device="cpu")
    cfg.TPU.compute_dtype = "bfloat16"
    bf16, _ = render.main(cfg, n_theta=3, n_phi=4, out_path=str(tmp / "bf16.npz"), use_fused=True,
                          device="cpu")
    assert bf16.dtype == np.float32 and np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16, f32, atol=1e-4)


def test_dataset_metas_identical_to_jax(corpus):
    tmp, jcfg = corpus
    cfg = load_cfg(YML, overrides(tmp))
    for phase in ("train", "test"):
        ours, ref = build_dataset(cfg, phase), jax_build_dataset(jcfg, phase)
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            a = ours.__getitem__(i, rng=np.random.default_rng(i))
            b = ref.__getitem__(i, rng=np.random.default_rng(i))
            assert a.keys() == b.keys()
            for k in a:
                assert pickle.dumps(a[k]) == pickle.dumps(b[k]), (phase, i, k)


def test_checkpointer_roundtrip_and_resolution(corpus, tmp_path):
    tmp, jcfg = corpus
    # a checkpoint the JAX package wrote loads unchanged
    loaded = CheckPointer(os.path.join(jcfg.output_dir, jcfg.desc)).load(best_valid=True)
    params, state, opt, extras = loaded
    assert extras == {"epoch": 7} and opt is None
    assert params["mlp2.weight"].dtype == torch.float32
    # save -> pointer -> load, and best_valid resolution
    ck = CheckPointer(str(tmp_path / "run"))
    path = ck.save("epoch_1", params=params, bn_state=state, epoch=1)
    assert open(tmp_path / "run" / "last_checkpoint").read() == path
    p2, s2, _, ex2 = ck.load()
    assert ex2 == {"epoch": 1}
    assert all(torch.equal(p2[k], params[k]) for k in params)
    assert all(torch.equal(s2[k], state[k]) for k in state)
    assert ck.load(best_valid=True) is None
    with pytest.raises(FileNotFoundError, match="MODEL.resume"):
        ck.load(resume=str(tmp_path / "missing.pkl"))
    # a reference torch.save checkpoint (DataParallel prefix) loads by name
    ref_path = tmp_path / "ref.pkl"
    torch.save({"model": {f"module.{k}": v for k, v in {**params, **state}.items()}, "epoch": 3},
               ref_path)
    p3, s3, _, ex3 = ck.load(resume=str(ref_path))
    assert ex3 == {"epoch": 3} and set(p3) == set(params) and set(s3) == set(state)


def test_generator_render_without_fused_decoder(corpus):
    tmp, _ = corpus
    params, state, _, _ = CheckPointer(os.path.join(str(tmp / "out"), "nef_net_synthetic")).load(
        best_valid=True)
    rng = np.random.default_rng(0)
    pts = np.array([0, 64, 128, 192, 256, 320, 448, 512])
    rois = np.broadcast_to(np.stack([pts[:-1], pts[1:]], 1), (2, 7, 2)).copy()
    data = rng.uniform(0, 1, (2, 3, 512)).astype(np.float32)
    it = rng.uniform(-np.pi, np.pi, (2, 3, 2)).astype(np.float32)
    views = theta_grid(3, 4)
    xla = PanoramaGenerator(NefNetDef(3), params, state, device="cpu").render(data, it, rois, views)
    fused = PanoramaGenerator(NefNetDef(3), params, state, device="cpu", use_fused=True).render(
        data, it, rois, views)
    assert xla.shape == (2, 12, 512)
    torch.testing.assert_close(fused, xla, rtol=0, atol=2e-5)


def test_render_full_record_renders_every_beat(corpus):
    from electrocardio_panorama_tpu_torch.synthesis import render_full_record

    tmp, _ = corpus
    cfg = load_cfg(YML, overrides(tmp))
    params, state, _, _ = CheckPointer(os.path.join(cfg.output_dir, cfg.desc)).load(best_valid=True)
    ds = build_dataset(cfg, "test")
    gen = PanoramaGenerator(NefNetDef(3), params, state, device="cpu", use_fused=True)
    pano, batch = render_full_record(gen, ds, 0, theta_grid(3, 4))
    assert pano.shape == (ds.num_beats(0), 12, 512)
    assert batch["rois"].shape == (ds.num_beats(0), 7, 2)


def few_view_batch(B=2):
    rng = np.random.default_rng(0)
    pts = np.array([0, 64, 128, 192, 256, 320, 448, 512])
    rois = np.broadcast_to(np.stack([pts[:-1], pts[1:]], 1), (B, 7, 2)).copy()
    return (rng.uniform(0, 1, (B, 3, 512)).astype(np.float32),
            rng.uniform(-np.pi, np.pi, (B, 3, 2)).astype(np.float32), rois)


@pytest.fixture
def a2_calls(monkeypatch):
    """Spy on encoder_fused.encode_fused: the masks argument of each call
    (None is the eval form)."""
    calls, real = [], TE.encode_fused

    def spy(w, x, gate, ramp, masks=None, **kw):
        calls.append(masks)
        return real(w, x, gate, ramp, masks, **kw)

    monkeypatch.setattr(TE, "encode_fused", spy)
    return calls


@pytest.mark.parametrize("model,use_fused,through_a2", [
    ("nefnet", True, True), ("nefnet", False, False), ("nefnet2", True, False), ("nefnet2", False, False)])
def test_render_encode_route(a2_calls, model, use_fused, through_a2):
    """A Nef-Net generator under use_fused encodes through the fused encoder
    A2 in eval form (its plain version on the CPU), one call a render, and
    its latents match the eager encode's within float32 rounding; Nef-Net2,
    and any generator without use_fused, keep the eager encode."""
    model_def, init = (NefNetDef(3), init_nefnet) if model == "nefnet" else (NefNet2Def(3), init_nefnet2)
    params, state = init(torch.Generator().manual_seed(0), lead_num=3)
    data, it, rois = few_view_batch()
    gen = PanoramaGenerator(model_def, params, state, device="cpu", use_fused=use_fused)
    out = gen.render(data, it, rois, theta_grid(3, 4))
    assert out.shape == (2, 12, 512) and a2_calls == ([None] if through_a2 else [])
    latent = gen.encode(data, it, rois)
    want = model_def.encode(params, torch.as_tensor(data), torch.as_tensor(it), torch.as_tensor(rois)).latent_all
    torch.testing.assert_close(latent, want, rtol=0, atol=1e-6)


def test_sharded_panorama_encodes_as_the_generator(a2_calls, no_group):
    """build_sharded_panorama(use_fused=True) takes the generator's encode
    route (A2's eval form for Nef-Net), bitwise the generator's render on a
    (1, 1) mesh."""
    params, state = init_nefnet(torch.Generator().manual_seed(0), lead_num=3)
    data, it, rois = few_view_batch()
    views = theta_grid(3, 4)
    render = build_sharded_panorama(NefNetDef(3), make_mesh((1, 1), ("data", "view"), device="cpu"),
                                    use_fused=True)
    out = render(params, state, *(torch.as_tensor(a) for a in (data, it, rois, views)))
    assert a2_calls == [None]
    ref = PanoramaGenerator(NefNetDef(3), params, state, device="cpu", use_fused=True).render(data, it, rois, views)
    assert a2_calls == [None, None] and torch.equal(out, ref)
