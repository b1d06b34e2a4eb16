"""The port's data parallelism over torch.distributed, on the CPU with gloo:

  * `local_batch_slice` partitions a batch as the JAX package's does, and
    raises when the batch does not divide;
  * a mesh whose size is not the world size raises, naming both; a mesh of
    one starts a group of one, and a trainer run under it is bitwise the run
    without a mesh;
  * 2 gloo ranks of the real `main.main` equal one process at the same
    global batch: params rtol 1e-4, atol 1e-5, and the best PSNR rtol 1e-4,
    as tests/test_multihost.py holds the JAX package;
  * one dp Solver step at 2 ranks, dropout off, equals the JAX package's
    `build_dp_train_step(..., deterministic=True)` on a 2-device CPU mesh
    from the same params and batch, at the f32 train bars of PERF.md §2:
    loss components relative 1e-4, the update's L2 distance over its size
    1e-3, and BN running statistics within 1e-5;
  * the view-sharded panorama on a (1, 2) mesh equals the single-process
    render within 2e-5, with the eager decoder and with A1's plain version.

Every multi-process run has a deadline of its own and fails with the ranks'
output when it passes it.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from electrocardio_panorama_tpu.config import get_cfg as jax_get_cfg
from electrocardio_panorama_tpu.models import NefNetDef as JaxNefNetDef
from electrocardio_panorama_tpu.models import build_model as jax_build_model
from electrocardio_panorama_tpu.parallel import build_dp_train_step, make_mesh as jax_make_mesh
from electrocardio_panorama_tpu.parallel import multihost as jax_multihost
from electrocardio_panorama_tpu.parallel import put_batch, put_replicated
from electrocardio_panorama_tpu.training.optim import get_optimizer as jax_get_optimizer
from electrocardio_panorama_tpu_torch import main as train_main
from electrocardio_panorama_tpu_torch.convert import params_from_jax
from electrocardio_panorama_tpu_torch.data import build_dataset
from electrocardio_panorama_tpu_torch.models import build_model
from electrocardio_panorama_tpu_torch.parallel import make_mesh, multihost
from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator
from electrocardio_panorama_tpu_torch.training import solver as S
from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer

from _torch_dist_child import BATCH, SHUFFLE, make_cfg
from _torch_ranks import REPO, no_group, run_ranks  # noqa: F401 (no_group is a fixture)

CHILD = os.path.join(REPO, "tests", "_torch_dist_child.py")
N_VIEWS = 8


def test_local_batch_slice_partitions_as_jax(monkeypatch):
    sl = multihost.local_batch_slice(32)
    assert (sl.start, sl.stop) == (0, 32)
    for n, i in ((4, 2), (2, 1), (8, 7)):
        monkeypatch.setattr(multihost, "process_count", lambda n=n: n)
        monkeypatch.setattr(multihost, "process_index", lambda i=i: i)
        monkeypatch.setattr(jax_multihost.jax, "process_count", lambda n=n: n)
        monkeypatch.setattr(jax_multihost.jax, "process_index", lambda i=i: i)
        assert multihost.local_batch_slice(32) == jax_multihost.local_batch_slice(32)
    slices = []
    for i in range(4):
        monkeypatch.setattr(multihost, "process_count", lambda: 4)
        monkeypatch.setattr(multihost, "process_index", lambda i=i: i)
        slices.append(multihost.local_batch_slice(32))
    assert [x for s in slices for x in range(32)[s]] == list(range(32))
    with pytest.raises(ValueError, match="divisible"):
        multihost.local_batch_slice(30)


def test_ensure_initialized_needs_the_launcher(monkeypatch, no_group):
    for k in multihost.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.ensure_initialized("cpu") is False and not dist.is_initialized()
    assert (multihost.backend_for("cuda"), multihost.backend_for("cpu")) == ("nccl", "gloo")


def test_mesh_shape_against_world_size_raises(tmp_path, no_group):
    with pytest.raises(ValueError, match=r"mesh_shape \[2\] needs 2 ranks, but the world size is 1"):
        make_mesh([2], ("data",), device="cpu")
    cfg = make_cfg(str(tmp_path), str(tmp_path / "synth"), mesh_shape=(2, 2))
    cfg.TPU.mesh_axes = ["data", "view"]
    with pytest.raises(ValueError, match=r"mesh_shape \[2, 2\] needs 4 ranks"):
        S.Solver(cfg, use_writer=False, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="axis names"):
        make_mesh([1, 1], ("data",), device="cpu")
    mesh = make_mesh([1], ("data",), device="cpu")  # a group of one
    assert dist.get_world_size() == 1 and mesh.mesh_dim_names == ("data",)
    with pytest.raises(ValueError, match=r"mesh_shape \[1, 2\] needs 2 ranks, but the world size is 1"):
        make_mesh([1, 2], ("data", "view"), device="cpu")


@pytest.mark.parametrize("decoder", ["xla", "fused"])
def test_mesh_of_one_is_bitwise_the_run_without_a_mesh(tmp_path, decoder, no_group):
    """At world size 1 every collective is the identity, bit for bit: params,
    BN state, per-step losses and the eval metrics."""
    runs = {}
    for mesh in ((), (1,)):
        cfg = make_cfg(str(tmp_path / f"out{len(mesh)}"), str(tmp_path / "synth"), mesh_shape=mesh)
        cfg.DATA.batch_size = 4
        cfg.TPU.train_decoder = decoder
        solver = train_main.main(cfg, device="cpu")
        assert (solver.mesh is None) == (not mesh)
        runs[mesh] = (CheckPointer(os.path.join(cfg.output_dir, cfg.desc)).load(), solver.history[0])
    ((p0, s0, _, e0), h0), ((p1, s1, _, e1), h1) = runs[()], runs[(1,)]
    assert all(torch.equal(p0[k], p1[k]) for k in p0) and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert np.array_equal(h0["train_losses"], h1["train_losses"]) and e0 == e1
    assert h0["scalars"] == h1["scalars"]


def test_two_rank_training_matches_single_process(tmp_path, no_group):
    synth = str(tmp_path / "synth")
    build_dataset(make_cfg(str(tmp_path / "seed"), synth), "train")  # the ranks never race the generator
    build_dataset(make_cfg(str(tmp_path / "seed"), synth), "test")
    one = make_cfg(str(tmp_path / "one"), synth, mesh_shape=())
    train_main.main(one, device="cpu")
    run_ranks(CHILD, 2, "train", str(tmp_path / "two"), synth)

    params_one, _, _, extras_one = CheckPointer(os.path.join(one.output_dir, "mh")).load()
    params_two, _, _, extras_two = CheckPointer(str(tmp_path / "two" / "mh")).load()
    for k in params_one:
        np.testing.assert_allclose(params_two[k].numpy(), params_one[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert extras_two["epoch"] == extras_one["epoch"] == 0
    np.testing.assert_allclose(extras_two["best_test_psnr_gen"], extras_one["best_test_psnr_gen"], rtol=1e-4)
    # rank 0 alone wrote the scalars (one row for the one epoch) and the lock's pid
    rows = open(tmp_path / "two" / "tf_logs" / "scalars.jsonl").read().splitlines()
    assert len(rows) == 1
    assert open(tmp_path / "two" / ".train.lock").read().startswith("pid ")


def make_batch(rng, B, L=3):
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


def jax_dp_step(params, state, batch):
    """The JAX package's dp step, dropout off, on a 2-device CPU mesh."""
    cfg = jax_get_cfg()
    cfg.MODEL.model = "model_nefnet"
    cfg.DATA.lead_num = 3
    cfg.SOLVER.loss_factor = [0.5, 0.5, 1]
    cfg.SOLVER.lr = 0.01
    mesh = jax_make_mesh((2,), ("data",))
    model, tx = jax_build_model(cfg), jax_get_optimizer(cfg)
    step = build_dp_train_step(model, cfg, tx, mesh, deterministic=True)
    arrays = put_batch(tuple(jnp.asarray(batch[k]) for k in
                             ("data", "input_theta", "target_theta", "rois", "target_view", "noise")), mesh)
    new_p, new_bn, _, losses = step(put_replicated(params, mesh), put_replicated(state, mesh),
                                    put_replicated(tx.init(params), mesh), jax.random.PRNGKey(7),
                                    jnp.asarray(SHUFFLE[0]), jnp.asarray(SHUFFLE[1]), *arrays)
    return ({k: np.asarray(v) for k, v in new_p.items()}, {k: np.asarray(v) for k, v in new_bn.items()},
            np.asarray(losses))


def test_dp_step_matches_jax_and_view_sharded_panorama(tmp_path, no_group):
    params, state = JaxNefNetDef(3).init(jax.random.PRNGKey(3))
    params = {k: np.asarray(v) for k, v in params.items()}
    state = {k: np.asarray(v) for k, v in state.items()}
    rng = np.random.default_rng(11)
    batch = make_batch(rng, BATCH)
    views = rng.uniform(-np.pi, np.pi, (N_VIEWS, 2)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **{f"p:{k}": v for k, v in params.items()},
             **{f"s:{k}": v for k, v in state.items()}, **{f"b:{k}": v for k, v in batch.items()},
             **{"b:views": views})
    run_ranks(CHILD, 2, "step_render", str(tmp_path))
    port = np.load(tmp_path / "port.npz")

    # the dp step against JAX's, at the f32 train bars (PERF.md §2)
    jp, jbn, jl = jax_dp_step(params, state, batch)
    np.testing.assert_allclose(port["loss"], jl, rtol=1e-4)
    upd_j = np.concatenate([(jp[k] - params[k]).ravel() for k in params])
    upd_p = np.concatenate([(port[f"p:{k}"] - params[k]).ravel() for k in params])
    assert np.linalg.norm(upd_p - upd_j) <= 1e-3 * np.linalg.norm(upd_j)
    for k in jbn:
        if k.endswith("num_batches_tracked"):
            assert int(port[f"s:{k}"]) == int(jbn[k]) == int(state[k]) + 3
        else:
            np.testing.assert_allclose(port[f"s:{k}"], jbn[k], atol=1e-5, rtol=1e-5, err_msg=k)

    # the view-sharded panorama at (1, 2) against one process's render
    tp, ts = params_from_jax(params, state)
    model = build_model(make_cfg("", ""))
    for name, fused in (("eager", False), ("fused", True)):
        ref = PanoramaGenerator(model, tp, ts, use_fused=fused, device="cpu").render(
            batch["data"], batch["input_theta"], batch["rois"], views)
        assert port[name].shape == (BATCH, N_VIEWS, 512)
        np.testing.assert_allclose(port[name], ref.numpy(), atol=2e-5, rtol=0, err_msg=name)
