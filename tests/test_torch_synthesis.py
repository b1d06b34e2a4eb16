"""Synthesis from scratch in the port against the JAX package, on the CPU:
the Gaussian latent prior (fit, save, load; samples bit for bit equal to
the JAX prior's from the same moments and seed), `synthesize_from_scratch`
on the same checkpoint, and the `synth_cli` workflow (export-latents ->
fit-prior -> generate) of both packages on one tiny synthetic corpus.

Tolerances: the decode atol 5e-5, the bar of tests/test_torch_nefnet.py.
The two CLIs fit their priors on their own encodes, which differ by float32
rounding (the encode is held at 5e-5 there): the prior's moments within
atol 1e-4, and the generated waveforms, which also carry the prior's
difference times a unit normal draw, within atol 2e-4.
"""

import os

import numpy as np
import pytest
import jax
import torch

from electrocardio_panorama_tpu import synth_cli as jax_cli
from electrocardio_panorama_tpu.config import get_cfg as jax_get_cfg
from electrocardio_panorama_tpu.models import NefNetDef as JaxNefNetDef
from electrocardio_panorama_tpu.synthesis import GaussianLatentPrior as JaxPrior
from electrocardio_panorama_tpu.synthesis import synthesize_from_scratch as jax_synthesize
from electrocardio_panorama_tpu.training.checkpoint import CheckPointer as JaxCheckPointer
from electrocardio_panorama_tpu_torch import synth_cli
from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models import NefNetDef
from electrocardio_panorama_tpu_torch.synthesis import GaussianLatentPrior, synthesize_from_scratch, theta_grid

ATOL, PRIOR_ATOL, CLI_ATOL = 5e-5, 1e-4, 2e-4


def make_batch(rng, B, L=3):
    rois = []
    for _ in range(B):
        cuts = np.sort(rng.choice(np.arange(8, 504, 4), size=6, replace=False))
        pts = np.concatenate([[0], cuts, [512]])
        rois.append(np.stack([pts[:-1], pts[1:]], 1))
    return dict(
        data=rng.uniform(0, 1, (B, L, 512)).astype(np.float32),
        input_theta=rng.uniform(-np.pi, np.pi, (B, L, 2)).astype(np.float32),
        rois=np.stack(rois).astype(np.int64),
    )


@pytest.fixture(scope="module")
def weights():
    params, state = JaxNefNetDef(3).init(jax.random.PRNGKey(1))
    tp, ts = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                             {k: np.asarray(v) for k, v in state.items()})
    return params, state, tp, ts


def test_latent_prior_fit_save_load_and_sample(weights, tmp_path):
    jp, _, tp, _ = weights
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, 2) for _ in range(3)]
    prior = GaussianLatentPrior.fit(NefNetDef(3), tp, iter(batches), max_batches=2)
    assert prior.mean_z1.shape == prior.std_z1.shape == (384, 128)
    assert prior.mean_z2.shape == prior.std_z2.shape == (384, 7, 32)
    assert (prior.std_z1 > 0).all() and (prior.std_z2 > 0).all()
    np.testing.assert_array_equal(prior.rois_template, batches[0]["rois"][0])
    # the moments of the first two batches' encodes, as the JAX prior fits them
    jprior = JaxPrior.fit(JaxNefNetDef(3), jp, iter(batches), max_batches=2)
    for name in ("mean_z1", "std_z1", "mean_z2", "std_z2"):
        np.testing.assert_allclose(getattr(prior, name), getattr(jprior, name), atol=ATOL, rtol=0, err_msg=name)

    path = str(tmp_path / "sub" / "prior.npz")
    prior.save(path)
    back = GaussianLatentPrior.load(path)
    for name in ("mean_z1", "std_z1", "mean_z2", "std_z2", "rois_template"):
        np.testing.assert_array_equal(getattr(back, name), getattr(prior, name))
    z1, z2, rois = back.sample(np.random.default_rng(3), 4, temperature=0.5)
    assert z1.shape == (4, 384, 128) and z2.shape == (4, 384, 7, 32) and rois.shape == (4, 7, 2)
    assert z1.dtype == z2.dtype == np.float32 and rois.flags.writeable


def test_prior_samples_bitwise_equal_to_jax_prior():
    rng = np.random.default_rng(11)
    moments = (rng.normal(size=(384, 128)), rng.uniform(0.1, 1, (384, 128)),
               rng.normal(size=(384, 7, 32)), rng.uniform(0.1, 1, (384, 7, 32)))
    rois = np.array([[0, 40], [40, 90], [90, 200], [200, 260], [260, 300], [300, 420], [420, 512]])
    ours, theirs = GaussianLatentPrior(*moments, rois), JaxPrior(*moments, rois)
    for seed, temp in ((0, 1.0), (5, 0.7)):
        a = ours.sample(np.random.default_rng(seed), 3, temperature=temp)
        b = theirs.sample(np.random.default_rng(seed), 3, temperature=temp)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_synthesize_from_scratch_matches_jax(weights):
    jp, js, tp, ts = weights
    rng = np.random.default_rng(2)
    moments = (rng.normal(0, 0.1, (384, 128)).astype(np.float32), rng.uniform(0.01, 0.1, (384, 128)).astype(np.float32),
               rng.normal(0, 0.1, (384, 7, 32)).astype(np.float32),
               rng.uniform(0.01, 0.1, (384, 7, 32)).astype(np.float32))
    rois = make_batch(rng, 1)["rois"][0]
    views = theta_grid(3, 4)
    ours = synthesize_from_scratch(NefNetDef(3), tp, ts, GaussianLatentPrior(*moments, rois), views, n=2, seed=4)
    theirs = jax_synthesize(JaxNefNetDef(3), jp, js, JaxPrior(*moments, rois), views, n=2, seed=4)
    assert ours.shape == (2, 12, 512)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=0)


def cli_cfg(cfg, root, latents):
    cfg.desc = "synth"
    cfg.output_dir = str(root / "out")
    cfg.latent_save_dir = str(root / latents)
    cfg.DATA.dataset = "synthetic"
    cfg.DATA.synthetic_root = str(root / "corpus")
    cfg.DATA.synthetic_n_train = 2
    cfg.DATA.synthetic_n_test = 6
    cfg.DATA.lead_num = 3
    cfg.DATA.super_mode = "IIv2v5_v4I_372"
    cfg.DATA.train_data_mode = "input_fix"
    cfg.MODEL.model = "model_nefnet"
    return cfg


def test_synth_cli_workflow_matches_jax_cli(weights, tmp_path, capsys):
    """export-latents (at most 2 batches) -> fit-prior -> generate (3 beats x
    12 views) through both CLIs from one checkpoint that the JAX package
    wrote; the port runs its command line with --device cpu."""
    jp, js, _, _ = weights
    jcfg = cli_cfg(jax_get_cfg(), tmp_path, "jax_latents")
    JaxCheckPointer(os.path.join(jcfg.output_dir, jcfg.desc)).save("best_valid", params=jp, bn_state=js, epoch=0)
    n = jax_cli.export_latents(jcfg, max_batches=2)
    jax_cli.fit_prior(jcfg)
    jecg = np.asarray(jax_cli.generate(jcfg, n=3, n_views=12, seed=7))

    opts = ["output_dir", str(tmp_path / "out"), "latent_save_dir", str(tmp_path / "latents"),
            "desc", "synth", "DATA.dataset", "synthetic", "DATA.synthetic_root", str(tmp_path / "corpus"),
            "DATA.synthetic_n_train", "2", "DATA.synthetic_n_test", "6", "DATA.lead_num", "3",
            "DATA.super_mode", "IIv2v5_v4I_372", "DATA.train_data_mode", "input_fix",
            "MODEL.model", "model_nefnet"]
    synth_cli.main(["export-latents", "--device", "cpu", "--max-batches", "2", *opts])
    assert f"exported {n} latents" in capsys.readouterr().out
    shards = sorted(f for f in os.listdir(tmp_path / "jax_latents") if f.startswith("latents_"))
    assert shards and sorted(f for f in os.listdir(tmp_path / "latents")) == shards
    for name in shards:
        ours, theirs = np.load(tmp_path / "latents" / name), np.load(tmp_path / "jax_latents" / name)
        assert ours["z1"].shape[1:] == (384, 128) and ours["z2"].shape[1:] == (384, 7, 32)
        np.testing.assert_array_equal(ours["rois"], theirs["rois"])
        for k in ("z1", "z2"):
            np.testing.assert_allclose(ours[k], theirs[k], atol=ATOL, rtol=0, err_msg=k)
    synth_cli.main(["fit-prior", "--device", "cpu", *opts])
    synth_cli.main(["generate", "--device", "cpu", "--n", "3", "--views", "12", "--seed", "7", *opts])
    assert "generated 3 beats x 12 views" in capsys.readouterr().out
    ours, theirs = np.load(tmp_path / "latents" / "prior.npz"), np.load(tmp_path / "jax_latents" / "prior.npz")
    for k in ("mean_z1", "std_z1", "mean_z2", "std_z2"):
        np.testing.assert_allclose(ours[k], theirs[k], atol=PRIOR_ATOL, rtol=0, err_msg=k)
    np.testing.assert_array_equal(ours["rois"], theirs["rois"])
    gen, jgen = np.load(tmp_path / "latents" / "generated.npz"), np.load(tmp_path / "jax_latents" / "generated.npz")
    assert gen["ecg"].shape == (3, 12, 512) and np.isfinite(gen["ecg"]).all()
    np.testing.assert_array_equal(gen["views"], jgen["views"])
    np.testing.assert_array_equal(gen["rois"], jgen["rois"])
    np.testing.assert_allclose(gen["ecg"], jgen["ecg"], atol=CLI_ATOL, rtol=0)
    np.testing.assert_array_equal(jgen["ecg"], jecg)


def test_synth_cli_needs_the_card_unless_cpu_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cli_cfg(get_cfg(), tmp_path, "latents")
    for fn in (synth_cli.export_latents, synth_cli.fit_prior, synth_cli.generate):
        with pytest.raises(RuntimeError, match="--device cpu"):
            fn(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        synth_cli.main(["generate", "output_dir", str(tmp_path)])
    assert synth_cli._grid_dims(24) == (4, 6) and synth_cli._grid_dims(7) == (1, 7)
    with pytest.raises(ValueError, match="--views"):
        synth_cli._grid_dims(0)
