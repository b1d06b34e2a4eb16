"""Checkpoints cross between the packages, on the CPU: a JAX-written
epoch_N.pkl resumes in the port's Solver with params, BN state, optimizer
state, epoch and best intact, and the next optimizer step equals optax's;
a port-written one loads in the JAX CheckPointer, and its by-key optimizer
state maps onto an optax state that optax updates with. SGD with momentum
and Adam.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from electrocardio_panorama_tpu.config import get_cfg as jax_get_cfg
from electrocardio_panorama_tpu.models.nefnet import init_nefnet as jax_init_nefnet
from electrocardio_panorama_tpu.training.checkpoint import CheckPointer as JaxCheckPointer
from electrocardio_panorama_tpu.training.optim import get_optimizer as jax_get_optimizer
from electrocardio_panorama_tpu_torch.config import get_cfg
from electrocardio_panorama_tpu_torch.convert import optimizer_from_optax, optimizer_to_optax
from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer
from electrocardio_panorama_tpu_torch.training.optim import get_optimizer, state_by_key
from electrocardio_panorama_tpu_torch.training.solver import Solver

LR = {"sgd": 0.1, "adam": 1e-3}


def configure(cfg, optim, out):
    cfg.desc = "xpkg"
    cfg.output_dir = str(out)
    cfg.DATA.lead_num = 3
    cfg.MODEL.model = "model_nefnet"
    cfg.SOLVER.optim = optim
    cfg.SOLVER.lr = LR[optim]
    return cfg


def random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1e-2, np.shape(v)).astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, optim):
    params, state = jax_init_nefnet(jax.random.PRNGKey(2), lead_num=3)
    state = {k: (v + 7 if k.endswith("num_batches_tracked") else v + 0.25) for k, v in state.items()}
    tx = jax_get_optimizer(configure(jax_get_cfg(), optim, tmp_path))
    opt_state = tx.init(params)
    g1 = random_grads(params, 1)
    updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g1.items()}, opt_state, params)
    params = optax.apply_updates(params, updates)
    out_dir = tmp_path / "xpkg"
    JaxCheckPointer(str(out_dir)).save("epoch_4", params=params, bn_state=state, opt_state=opt_state,
                                       epoch=4, psnr_gen=20.5, psnr_reg=21.0, best_test_psnr_gen=23.5)

    solver = Solver(configure(get_cfg(), optim, tmp_path), use_writer=False, device="cpu")
    tp, ts, opt, start, best = solver.restore()
    assert (start, best) == (5, 23.5)
    for k, v in params.items():
        np.testing.assert_array_equal(tp[k].detach().numpy(), np.asarray(v))
    for k, v in state.items():
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(v))
    assert ts["decoder.1.double_conv.1.num_batches_tracked"].dtype == torch.int64
    saved = state_by_key(opt, tp)
    direct = optimizer_from_optax(opt_state, list(params))
    assert saved["name"] == direct["name"] == optim and saved["step"] == direct["step"]
    for k in params:
        for name, arr in direct["state"][k].items():
            np.testing.assert_array_equal(saved["state"][k][name], arr)

    # the next step in both packages from the same gradient
    g2 = random_grads(params, 2)
    updates, _ = tx.update({k: jnp.asarray(v) for k, v in g2.items()}, opt_state, params)
    jax_next = optax.apply_updates(params, updates)
    for k, p in tp.items():
        p.grad = torch.tensor(g2[k])
    opt.step()
    for k, v in jax_next.items():
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(v), rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_port_checkpoint_loads_in_jax(tmp_path, optim):
    cfg = configure(get_cfg(), optim, tmp_path)
    solver = Solver(cfg, use_writer=False, device="cpu")
    params, bn, opt = solver.init_state()
    for step in (1, 2):
        g = random_grads(params, step)
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    bn = {k: v + 3 if k.endswith("num_batches_tracked") else v * 1.5 for k, v in bn.items()}
    saved = state_by_key(opt, params)
    path = CheckPointer(solver.output_dir).save("epoch_1", params=params, bn_state=bn, opt_state=saved,
                                                epoch=1, psnr_gen=19.0, psnr_reg=20.0, best_test_psnr_gen=19.0)
    assert path == os.path.join(solver.output_dir, "epoch_1.pkl") == CheckPointer(solver.output_dir).epoch_path(1)

    jp, jbn, jopt, extras = JaxCheckPointer(solver.output_dir).load()
    assert extras == {"epoch": 1, "psnr_gen": 19.0, "psnr_reg": 20.0, "best_test_psnr_gen": 19.0}
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(jp[k]), v.detach().numpy())
    for k, v in bn.items():
        np.testing.assert_array_equal(np.asarray(jbn[k]), v.numpy())
    tx = jax_get_optimizer(configure(jax_get_cfg(), optim, tmp_path))
    ostate = optimizer_to_optax(jopt, tx.init(jp))
    assert jax.tree.structure(ostate) == jax.tree.structure(tx.init(jp))
    back = optimizer_from_optax(ostate, list(params))
    for k in params:
        for name, arr in saved["state"][k].items():
            np.testing.assert_array_equal(back["state"][k][name], arr)
    assert back["step"] == saved["step"] == (2 if optim == "adam" else 0)
    assert back["lr"] == pytest.approx(LR[optim])

    # optax and torch take the same next step from the carried state
    g3 = random_grads(params, 3)
    updates, _ = tx.update({k: jnp.asarray(v) for k, v in g3.items()},
                           jax.tree.map(jnp.asarray, ostate), jp)
    jax_next = optax.apply_updates(jp, updates)
    for k, p in params.items():
        p.grad = torch.tensor(g3[k])
    opt.step()
    for k, v in jax_next.items():
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(v), rtol=1e-6, atol=1e-7, err_msg=k)


def test_optax_mapping_rejects_other_states():
    with pytest.raises(ValueError, match="TraceState"):
        optimizer_from_optax(optax.adagrad(0.1).init({"w": jnp.zeros(2)}), ["w"])
    sgd = {"name": "sgd", "lr": 0.1, "step": 0, "state": {"w": {"momentum_buffer": np.ones(2, np.float32)}}}
    with pytest.raises(ValueError, match="TraceState"):
        optimizer_to_optax(sgd, optax.adam(0.1).init({"w": jnp.zeros(2)}))
    opt = get_optimizer(configure(get_cfg(), "adam", "unused"), {"w": torch.zeros(2, requires_grad=True)})
    from electrocardio_panorama_tpu_torch.training.optim import load_state_by_key

    with pytest.raises(ValueError, match="sgd state"):
        load_state_by_key(opt, {"w": opt.param_groups[0]["params"][0]}, sgd)
