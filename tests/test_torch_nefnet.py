"""The port's Nef-Net (eval path) against the JAX package and the reference goldens.

Same numpy inputs and the same weights (JAX init, handed over through
`convert.params_from_jax`) go through both packages on the CPU.
Tolerance: atol 5e-5 in float32 — the encode chains ten grouped convs and
two ROI ops, and the two frameworks sum in different orders.
The goldens (tests/goldens/nefnet_lead{1,3}.npz, recorded from the PyTorch
reference) are held at the JAX package's own bar (tests/test_model_parity.py):
atol 3e-5 and correlation > 0.999999.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from electrocardio_panorama_tpu.models import NefNetDef as JaxNefNetDef
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.models import NefNet, NefNet2Def, NefNetDef, build_model, init_nefnet
from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.training.torch_import import split_params_state

ATOL = 5e-5
GOLDEN_ATOL = 3e-5
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def make_inputs(rng, B, L, V):
    rois = []
    for _ in range(B):
        cuts = np.sort(rng.choice(np.arange(8, 504, 4), size=6, replace=False))
        pts = np.concatenate([[0], cuts, [512]])
        rois.append(np.stack([pts[:-1], pts[1:]], 1))
    return dict(
        x=rng.uniform(0, 1, (B, L, 512)).astype(np.float32),
        thetas=rng.uniform(-np.pi, np.pi, (B, L, 2)).astype(np.float32),
        rois=np.stack(rois).astype(np.int64),
        views=rng.uniform(-np.pi, np.pi, (B, V, 2)).astype(np.float32),
    )


def jax_weights(lead_num, seed=0):
    params, state = JaxNefNetDef(lead_num).init(jax.random.PRNGKey(seed))
    return params, state, params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                          {k: np.asarray(v) for k, v in state.items()})


@pytest.mark.parametrize("lead_num", [3, 1])
def test_encode_and_decode_views_match_jax(rng, lead_num):
    jp, js, (tp, ts) = jax_weights(lead_num)
    inp = make_inputs(rng, 2, lead_num, 5)
    jm, tm = JaxNefNetDef(lead_num), NefNetDef(lead_num)

    jlat = jm.encode(jp, jnp.asarray(inp["x"]), jnp.asarray(inp["thetas"]), jnp.asarray(inp["rois"]))
    tlat = tm.encode(tp, torch.tensor(inp["x"]), torch.tensor(inp["thetas"]), torch.tensor(inp["rois"]))
    for name in ("z1", "z2", "latent_all"):
        np.testing.assert_allclose(getattr(tlat, name).numpy(), np.asarray(getattr(jlat, name)),
                                   atol=ATOL, err_msg=name)

    jout = jm.decode_views(jp, js, jlat.latent_all, jnp.asarray(inp["views"]))
    tout = tm.decode_views(tp, ts, tlat.latent_all, torch.tensor(inp["views"]))
    assert tout.shape == (2, 5, 512)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)


@pytest.mark.parametrize("lead_num", [3, 1])
def test_eval_outputs_match_reference_goldens(lead_num):
    path = os.path.join(GOLDEN_DIR, f"nefnet_lead{lead_num}.npz")
    g = np.load(path)
    named = {k[len("param::"):]: torch.from_numpy(g[k]) for k in g.files if k.startswith("param::")}
    params, state = split_params_state(named)
    # the module tree's keys are exactly the reference checkpoint's
    NefNet(lead_num).load_state_dict({**params, **state}, strict=True)

    m = NefNetDef(lead_num)
    lat = m.encode(params, torch.from_numpy(g["x"]), torch.from_numpy(g["input_thetas"]),
                   torch.from_numpy(g["rois"]))
    rest = m.decode_views(params, state, lat.latent_all, torch.from_numpy(g["rest_theta"])).numpy()
    np.testing.assert_allclose(rest, g["eval.rest_out"], atol=GOLDEN_ATOL)
    assert np.corrcoef(rest.ravel(), g["eval.rest_out"].ravel())[0, 1] > 0.999999
    # the query-view prediction is a one-view decode of the same latent
    out = m.decode_views(params, state, lat.latent_all, torch.from_numpy(g["query_theta"])[:, None])
    np.testing.assert_allclose(out.numpy(), g["eval.out"], atol=GOLDEN_ATOL)


def test_init_draws_from_generator_with_reference_shapes():
    jp, js = JaxNefNetDef(3).init(jax.random.PRNGKey(0))
    p1, s1 = init_nefnet(torch.Generator().manual_seed(5), lead_num=3)
    p2, _ = init_nefnet(torch.Generator().manual_seed(5), lead_num=3)
    p3, _ = init_nefnet(torch.Generator().manual_seed(6), lead_num=3)
    assert set(p1) == set(jp) and set(s1) == set(js)
    for k in jp:
        assert tuple(p1[k].shape) == tuple(jp[k].shape), k
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not torch.equal(p1["mlp2.weight"], p3["mlp2.weight"])
    # same distributions: torch-default uniform bound sqrt(1/fan_in), ResNet normal
    assert float(p1["mlp2.weight"].abs().max()) <= (1 / 12) ** 0.5
    std = float(p1["W_encoder.conv1.weight"].std())
    assert abs(std - (2 / (15 * 15 * 384)) ** 0.5) < 0.1 * std
    assert torch.equal(s1["decoder.1.double_conv.1.running_var"], torch.ones(128))


def test_build_model_registry():
    cfg = get_cfg()
    cfg.MODEL.model = "model_nefnet"
    cfg.DATA.lead_num = 3
    assert build_model(cfg).lead_num == 3
    cfg.MODEL.model = "model_nefnet2"
    m2 = build_model(cfg)
    assert isinstance(m2, NefNet2Def) and m2.lead_num == 3
    cfg.MODEL.model = "modelv2"
    with pytest.raises(ValueError, match="registered: 'model_nefnet', 'model_nefnet2'"):
        build_model(cfg)


@pytest.mark.parametrize("phase", ["val", "test", "gen"])
def test_nefnet_apply_eval_phases_and_gen_ecg_match_jax(rng, phase):
    """nefnet_apply in phases val/test (the three decodes and the rest views)
    and gen (the pre-reverse latents), then gen_ecg, against the JAX package."""
    jp, js, (tp, ts) = jax_weights(3, seed=1)
    inp = make_inputs(rng, 2, 3, 5)
    jm, tm = JaxNefNetDef(3), NefNetDef(3)
    query = inp["views"][:, 0]
    args_j = [jnp.asarray(inp[k]) for k in ("x", "thetas")] + [jnp.asarray(query), jnp.asarray(inp["rois"])]
    args_t = [torch.tensor(inp[k]) for k in ("x", "thetas")] + [torch.tensor(query), torch.tensor(inp["rois"])]
    jout, js2 = jm.apply(jp, js, *args_j, jnp.asarray(inp["views"]), phase=phase, shuffle_idx=(1, 2))
    tout, ts2 = tm.apply(tp, ts, *args_t, torch.tensor(inp["views"]), phase=phase, shuffle_idx=(1, 2))
    assert len(tout) == len(jout) == (2 if phase == "gen" else 4) and ts2 is ts
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    if phase == "gen":
        g_t = tm.gen_ecg(tp, ts, *tout, torch.tensor(inp["views"]), torch.tensor(inp["rois"]))
        g_j = jm.gen_ecg(jp, js, *jout, jnp.asarray(inp["views"]), jnp.asarray(inp["rois"]))
        assert g_t.shape == (2, 5, 512)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL, rtol=0)
    with pytest.raises(KeyError, match="phase"):
        tm.apply(tp, ts, *args_t, phase="other")
