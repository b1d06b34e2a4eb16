"""The port's lead tensor parallelism and 3-axis (data x lead x view) train
step over torch.distributed, on the CPU with gloo, against the JAX package
(tests/test_sharding.py:297-480 holds the JAX functions the same way):

  * `lead_param_specs` shards exactly the leaves that the JAX package's marks
    P("lead"), at 12 and 3 leads; `opt_state_specs` marks the optimizer state
    of a lead-sharded leaf as sharded;
  * a lead axis that does not divide lead_num raises "not divisible";
  * the lead-parallel panorama (12 leads, B = 2, 8 views) on (lead 2, view 2)
    and (lead 4) equals the JAX package's unsharded encode + decode_views
    within 2e-5;
  * one float32 3-axis step, dropout off, on (data 1, lead 2, view 2) and
    (data 2, lead 2, view 1) equals the JAX Solver's single-device step on the
    JAX test's own params and batch at its bars: losses atol 2e-6, params, BN
    state and SGD momentum atol 5e-6. lr x |grad| of the lead-sharded leaves
    is at least 20 times the params bar, so a gradient n_lead times too large,
    or too small, cannot pass. (The momentum bar is one of gradients: on the
    port's seeded init the port's single-process step itself lies up to
    1.74e-5 from JAX's there, on 0.12% of decoder.1.double_conv.0.weight's
    gradient, rounding at relu edges, while its params lie within 1.8e-7);
  * the bfloat16 step is finite, keeps float32 masters, and its losses track
    the float32 step's to bfloat16 resolution (rtol 0.05, atol 5e-3);
  * `gather_lead_params` after the step equals the port's single-process
    step (atol 5e-6), and in-process a (1, 1, 1) mesh step is bit for bit the
    single-process step.

The 4 ranks (tests/_torch_lead_child.py) run once for the module, under one
deadline, while this process computes the JAX references.
"""

import os
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from electrocardio_panorama_tpu.config import get_cfg as jax_get_cfg
from electrocardio_panorama_tpu.models import NefNetDef as JaxNefNetDef
from electrocardio_panorama_tpu.models import build_model as jax_build_model
from electrocardio_panorama_tpu.parallel import lead_param_specs as jax_lead_param_specs
from electrocardio_panorama_tpu.parallel import opt_state_specs as jax_opt_state_specs
from electrocardio_panorama_tpu.training.optim import get_optimizer as jax_get_optimizer
from electrocardio_panorama_tpu.training.solver import Solver as JaxSolver
from electrocardio_panorama_tpu_torch.convert import optimizer_from_optax, params_from_jax
from electrocardio_panorama_tpu_torch.models import NefNet, build_model, init_nefnet
from electrocardio_panorama_tpu_torch.parallel import (
    LEAD_PREFIXES,
    build_3d_train_step,
    lead_param_specs,
    make_mesh,
    opt_state_specs,
    shard_lead_params,
)
from electrocardio_panorama_tpu_torch.training.optim import get_optimizer
from electrocardio_panorama_tpu_torch.training.solver import Solver

from _torch_lead_child import PANORAMA_MESHES, SHUFFLE, STEP_MESHES, step_cfg
from _torch_ranks import REPO, no_group, start_ranks, wait_ranks  # noqa: F401 (no_group is a fixture)

CHILD = os.path.join(REPO, "tests", "_torch_lead_child.py")
RANKS_TIMEOUT_S = 150
LOSS_ATOL, STATE_ATOL = 2e-6, 5e-6


def make_batch(rng, B, L):
    rois = []
    for _ in range(B):
        cuts = np.sort(rng.choice(np.arange(8, 504, 4), size=6, replace=False))
        pts = np.concatenate([[0], cuts, [512]])
        rois.append(np.stack([pts[:-1], pts[1:]], 1))
    return dict(
        data=rng.uniform(0, 1, (B, L, 512)).astype(np.float32),
        input_theta=rng.uniform(-np.pi, np.pi, (B, L, 2)).astype(np.float32),
        target_theta=rng.uniform(-np.pi, np.pi, (B, 2)).astype(np.float32),
        rois=np.stack(rois).astype(np.int64),
        target_view=rng.uniform(0, 1, (B, 512)).astype(np.float32),
        noise=np.zeros((B, 512), np.float32),
    )


def jax_step_cfg():
    cfg = jax_get_cfg()
    cfg.MODEL.model = "model_nefnet"
    cfg.DATA.lead_num = 2
    cfg.SOLVER.loss_factor = [0.5, 0.5, 1]
    cfg.SOLVER.lr = 0.01
    return cfg


def numpy_tree(tree: dict) -> dict:
    return {k: np.asarray(v) for k, v in tree.items()}


def port_init(lead_num: int, seed: int) -> tuple[dict, dict]:
    """Nef-Net's (params, BN state) as numpy from the port's seeded init: both
    packages take the same reference-keyed arrays."""
    params, state = init_nefnet(torch.Generator().manual_seed(seed), lead_num=lead_num)
    return ({k: v.numpy() for k, v in params.items()},
            {k: v.numpy().astype(np.int32) if not v.is_floating_point() else v.numpy() for k, v in state.items()})


def port_single_step(params: dict, state: dict, batch: dict, out_dir: str, dtype: str = "float32"):
    """The port's single-process Solver step, dropout off: (params, BN
    state, momentum by key, losses)."""
    cfg = step_cfg(dtype)
    cfg.output_dir, cfg.desc = out_dir, "debug"
    solver = Solver(cfg, use_writer=False, device="cpu")
    solver.draw_masks = lambda gen, b: None
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = get_optimizer(cfg, p)
    new_bn, lvec = solver.train_step(p, state, opt, epoch=0, step=0, i1=SHUFFLE[0], i2=SHUFFLE[1], batch=batch)
    return ({k: v.detach() for k, v in p.items()}, new_bn, momentum(opt, p), lvec)


def momentum(opt, params: dict) -> dict:
    """SGD's momentum by key; zeros for a leaf with no gradient yet (the dead
    w_feature_extractor), as the optax state holds."""
    return {k: opt.state[v].get("momentum_buffer", torch.zeros_like(v)) for k, v in params.items()}


@pytest.fixture(scope="module")
def lead_run(tmp_path_factory):
    """Starts the 4 ranks on the inputs, computes the references meanwhile,
    and returns the ranks' port.npz with the references."""
    work = tmp_path_factory.mktemp("lead")
    p12, s12 = port_init(12, seed=3)
    rng = np.random.default_rng(5)
    pano = make_batch(rng, B=2, L=12)
    views = rng.uniform(-np.pi, np.pi, (8, 2)).astype(np.float32)
    jcfg = jax_step_cfg()
    model2, tx = jax_build_model(jcfg), jax_get_optimizer(jcfg)
    p2, s2 = model2.init(jax.random.PRNGKey(4))  # the JAX package's own test inputs (test_sharding.py:363-366)
    p2, s2 = numpy_tree(p2), numpy_tree(s2)
    batch = make_batch(np.random.default_rng(5), B=8, L=2)
    np.savez(work / "inputs.npz", **{f"p12:{k}": v for k, v in p12.items()}, **{f"s12:{k}": v for k, v in s12.items()},
             **{f"pano:{k}": pano[k] for k in ("data", "input_theta", "rois")}, **{"pano:views": views},
             **{f"p2:{k}": v for k, v in p2.items()}, **{f"s2:{k}": v for k, v in s2.items()},
             **{f"batch:{k}": v for k, v in batch.items()})
    procs = start_ranks(CHILD, 4, str(work))
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        model12 = JaxNefNetDef(lead_num=12)
        lat = model12.encode(p12, jnp.asarray(pano["data"]), jnp.asarray(pano["input_theta"]),
                             jnp.asarray(pano["rois"]))
        pano_ref = np.asarray(model12.decode_views(p12, s12, lat.latent_all,
                                                   jnp.broadcast_to(jnp.asarray(views)[None], (2, 8, 2))))
        scfg = jcfg.clone()
        scfg.output_dir = str(work / "jax_solver")
        arrays = tuple(jnp.asarray(batch[k]) for k in
                       ("data", "input_theta", "target_theta", "rois", "target_view", "noise"))
        jp, jbn, jopt, jl = JaxSolver(scfg, use_writer=False)._train_step(
            {k: jnp.asarray(v) for k, v in p2.items()}, {k: jnp.asarray(v) for k, v in s2.items()},
            tx.init({k: jnp.asarray(v) for k, v in p2.items()}), None, np.int32(0),
            jnp.asarray(SHUFFLE[0]), jnp.asarray(SHUFFLE[1]), *arrays)
        jmom = {k: v["momentum_buffer"] for k, v in optimizer_from_optax(jopt, list(p2))["state"].items()}
        tp, ts = params_from_jax(p2, s2)
        single = port_single_step(tp, ts, batch, str(work / "port_single"))
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    wait_ranks(procs, deadline, RANKS_TIMEOUT_S)
    return dict(port=dict(np.load(work / "port.npz")), pano_ref=pano_ref, p0=p2,
                jax=(numpy_tree(jp), numpy_tree(jbn), jmom, np.asarray(jl)), single=single)


@pytest.mark.parametrize("lead_num", [12, 3])
def test_lead_param_specs_match_jax(lead_num):
    """The same leaves shard on the lead axis, on axis 0, as the JAX
    package's P("lead"); the rest replicates."""
    shapes, _ = jax.eval_shape(JaxNefNetDef(lead_num=lead_num).init, jax.random.PRNGKey(0))
    want = jax_lead_param_specs(shapes, lead_num)
    params = dict(NefNet(lead_num).named_parameters())
    got = lead_param_specs(params, lead_num)
    assert set(got) == set(want)
    assert {k for k, s in got.items() if s == "lead"} == {k for k, s in want.items() if s == P("lead")}
    assert {k for k, s in got.items() if s is None} == {k for k, s in want.items() if s == P()}
    assert got["W_encoder.conv1.weight"] == got["z2_conv2.1.bias"] == "lead"
    assert got["decoder.4.weight"] is got["mlp1.weight"] is got["mlp2.weight"] is None
    # z2_conv2's blocks are 128 * 7 rows per lead: ROI segments interleave across groups
    assert params["z2_conv2.0.conv1.weight"].shape[0] == 128 * 7 * lead_num
    with pytest.raises(ValueError, match="not divisible"):
        lead_param_specs(params, 5)


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_opt_state_specs_follow_the_params(optim):
    """The optimizer state of a lead-sharded leaf is sharded (SGD's
    momentum, Adam's two moments), as the JAX package's optax state of
    W_encoder.conv1.weight is; the rest replicates."""
    cfg = step_cfg()
    cfg.SOLVER.optim = optim
    params = dict(NefNet(2).named_parameters())
    specs = lead_param_specs(params, 2)
    o_specs = opt_state_specs(get_optimizer(cfg, params), params, specs)
    names = {"sgd": {"momentum_buffer"}, "adam": {"exp_avg", "exp_avg_sq"}}[optim]
    assert set(o_specs) == set(params) and all(set(v) == names for v in o_specs.values())
    assert all(s == "lead" for s in o_specs["W_encoder.conv1.weight"].values())
    assert all(s is None for s in o_specs["decoder.1.double_conv.0.weight"].values())
    jcfg = jax_step_cfg()
    jcfg.SOLVER.optim = optim
    shapes, _ = jax.eval_shape(JaxNefNetDef(lead_num=2).init, jax.random.PRNGKey(0))
    j_specs = jax_opt_state_specs(jax_get_optimizer(jcfg), shapes, jax_lead_param_specs(shapes, 2))
    sharded = {k.key for path, s in jax.tree_util.tree_leaves_with_path(j_specs) if s == P("lead")
               for k in path if isinstance(k, jax.tree_util.DictKey)}
    assert sharded == {k for k, v in o_specs.items() if set(v.values()) == {"lead"}}


def test_lead_axis_must_divide_the_leads(lead_run):
    """On a lead axis of 4 the panorama at 3 leads and the step at 2 raise."""
    port = lead_run["port"]
    for name in ("panorama", "step"):
        msg = str(port[f"raised:{name}"])
        assert "not divisible" in msg and "|lead|=4" in msg, (name, msg)


@pytest.mark.parametrize("mesh", list(PANORAMA_MESHES))
def test_lead_parallel_panorama_matches_jax(lead_run, mesh):
    got = lead_run["port"][f"pano:{mesh}"]
    assert got.shape == (2, 8, 512)
    np.testing.assert_allclose(got, lead_run["pano_ref"], rtol=0, atol=2e-5)


def lead_sharded(keys):
    return [k for k in keys if k.startswith(LEAD_PREFIXES)]


@pytest.mark.parametrize("shape", STEP_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_3d_step_matches_jax_solver(lead_run, shape):
    port, p0 = lead_run["port"], lead_run["p0"]
    jp, jbn, jmom, jl = lead_run["jax"]
    tag = f"float32:{'x'.join(map(str, shape))}"
    assert int(port[f"{tag}:local_rows"]) == p0["W_encoder.conv1.weight"].shape[0] // 2  # sharded on the ranks
    np.testing.assert_allclose(port[f"{tag}:loss"], jl, rtol=0, atol=LOSS_ATOL)
    for k in jp:
        np.testing.assert_allclose(port[f"{tag}:p:{k}"], jp[k], rtol=0, atol=STATE_ATOL, err_msg=f"param {k}")
        np.testing.assert_allclose(port[f"{tag}:m:{k}"], jmom[k], rtol=0, atol=STATE_ATOL, err_msg=f"momentum {k}")
    for k in jbn:
        np.testing.assert_allclose(port[f"{tag}:s:{k}"], jbn[k], rtol=0, atol=STATE_ATOL, err_msg=f"bn state {k}")
    # a lead gradient off by a factor n_lead = 2 moves these leaves by lr * |grad|
    lr_grad = max(float(np.abs(jp[k] - p0[k]).max()) for k in lead_sharded(jp))
    assert lr_grad >= 20 * STATE_ATOL, lr_grad


def test_3d_step_bf16_tracks_f32(lead_run):
    port = lead_run["port"]
    tag16, tag32 = (f"{dt}:{'x'.join(map(str, STEP_MESHES[0]))}" for dt in ("bfloat16", "float32"))
    assert np.isfinite(port[f"{tag16}:loss"]).all()
    np.testing.assert_allclose(port[f"{tag16}:loss"], port[f"{tag32}:loss"], rtol=0.05, atol=5e-3)
    for part in ("p", "m", "s"):
        leaves = [port[k] for k in port if k.startswith(f"{tag16}:{part}:")]
        assert leaves and all(v.dtype == np.float32 for v in leaves if np.issubdtype(v.dtype, np.floating)), part
        assert all(np.isfinite(v).all() for v in leaves), part
    assert any(not np.array_equal(port[f"{tag16}:p:{k}"], lead_run["p0"][k]) for k in lead_sharded(lead_run["p0"]))


@pytest.mark.parametrize("shape", STEP_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_gathered_params_equal_single_process(lead_run, shape):
    port = lead_run["port"]
    p1, bn1, mom1, l1 = lead_run["single"]
    tag = f"float32:{'x'.join(map(str, shape))}"
    np.testing.assert_allclose(port[f"{tag}:loss"], l1.numpy(), rtol=0, atol=LOSS_ATOL)
    for k in p1:
        assert port[f"{tag}:p:{k}"].shape == tuple(p1[k].shape), k
        np.testing.assert_allclose(port[f"{tag}:p:{k}"], p1[k].numpy(), rtol=0, atol=STATE_ATOL, err_msg=k)
        np.testing.assert_allclose(port[f"{tag}:m:{k}"], mom1[k].numpy(), rtol=0, atol=STATE_ATOL, err_msg=k)
    for k in bn1:
        np.testing.assert_allclose(port[f"{tag}:s:{k}"], bn1[k].numpy(), rtol=0, atol=STATE_ATOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_of_one_step_is_the_single_process_step(tmp_path, dtype, no_group):
    """In this process, a (1, 1, 1) mesh (a group of one) makes every
    collective the identity: the step is the Solver's single-process step
    bit for bit, params, momentum, BN state and losses."""
    tp, ts = params_from_jax(*port_init(2, seed=4))
    batch = make_batch(np.random.default_rng(7), B=4, L=2)
    p1, bn1, mom1, l1 = port_single_step(tp, ts, batch, str(tmp_path), dtype)
    cfg = step_cfg(dtype)
    mesh = make_mesh((1, 1, 1), ("data", "lead", "view"), device="cpu")
    p = {k: v.requires_grad_(True) for k, v in shard_lead_params(tp, mesh, lead_num=2).items()}
    opt = get_optimizer(cfg, p)
    step = build_3d_train_step(build_model(cfg), cfg, opt, mesh, deterministic=True)
    bn2, l2 = step(p, ts, epoch=0, step=0, i1=SHUFFLE[0], i2=SHUFFLE[1], batch=batch)
    assert torch.equal(l1, l2)
    assert all(torch.equal(p1[k], p[k].detach()) for k in p1)
    mom2 = momentum(opt, p)
    assert all(torch.equal(mom1[k], mom2[k]) for k in p1)
    assert set(bn1) == set(bn2) and all(torch.equal(bn1[k], bn2[k]) for k in bn1)
