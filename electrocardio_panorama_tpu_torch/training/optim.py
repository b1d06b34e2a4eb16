"""Optimizer and LR schedule (reference solver/optim_scheduler.py:5-18; the
JAX package's training/optim.py).

  * SGD(lr, momentum=0.9): buf = 0.9 buf + g; p -= lr buf, which is optax
    `sgd(momentum=0.9)` (trace, then -lr scaling).
  * Adam(lr) with torch defaults (b1 0.9, b2 0.999, eps 1e-8), which is
    optax `adam`.
  * StepLR(50, gamma 0.1) / MultiStepLR(SOLVER.lr_step, gamma 0.1), indexed
    by epoch and set on the optimizer before each epoch (`set_lr`).

The optimizer's state is kept by parameter key (`state_by_key`,
`load_state_by_key`), the form checkpoints store and `convert.py` maps to
and from an optax state.
"""

from __future__ import annotations

import numpy as np
import torch

# per-parameter state tensors of each optimizer, in torch's names
STATE_KEYS = {"sgd": ("momentum_buffer",), "adam": ("exp_avg", "exp_avg_sq")}


def get_optimizer(cfg, params: dict) -> torch.optim.Optimizer:
    """`params` is the flat {key: leaf tensor} dict the optimizer updates."""
    name = cfg.SOLVER.optim
    if name == "adam":
        return torch.optim.Adam(list(params.values()), lr=cfg.SOLVER.lr)
    if name == "sgd":
        return torch.optim.SGD(list(params.values()), lr=cfg.SOLVER.lr, momentum=0.9)
    raise ValueError(f"unknown optimizer {name}")


def optimizer_name(opt: torch.optim.Optimizer) -> str:
    if isinstance(opt, torch.optim.Adam):
        return "adam"
    if isinstance(opt, torch.optim.SGD):
        return "sgd"
    raise ValueError(f"unsupported optimizer {type(opt).__name__}")


def lr_for_epoch(cfg, epoch: int) -> float:
    """Epoch-indexed LR matching torch StepLR/MultiStepLR with gamma=0.1."""
    base = cfg.SOLVER.lr
    sched = cfg.SOLVER.scheduler
    if sched == "steplr":
        return base * (0.1 ** (epoch // 50))
    if sched == "MultiStep":
        passed = sum(1 for m in cfg.SOLVER.lr_step if epoch >= m)
        return base * (0.1**passed)
    raise ValueError(f"unknown scheduler {sched}")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in opt.param_groups:
        group["lr"] = lr
    return opt


def state_by_key(opt: torch.optim.Optimizer, params: dict) -> dict:
    """{"name", "lr", "step", "state": {key: {state name: numpy}}}; `step`
    is Adam's step count (SGD keeps none: 0). A parameter that has had no
    gradient yet (an unused conv) gets zeros, as the optax state holds."""
    name = optimizer_name(opt)
    step = 0
    state = {}
    for k, p in params.items():
        st = opt.state.get(p, {})
        if "step" in st:
            step = max(step, int(st["step"]))
        state[k] = {s: (st[s] if s in st else torch.zeros_like(p)).detach().cpu().float().numpy()
                    for s in STATE_KEYS[name]}
    return {"name": name, "lr": float(opt.param_groups[0]["lr"]), "step": step, "state": state}


def load_state_by_key(opt: torch.optim.Optimizer, params: dict, saved: dict) -> None:
    """Restore `state_by_key`'s dict into `opt` (whose parameters are
    `params`, by the same keys)."""
    name = optimizer_name(opt)
    if saved["name"] != name:
        raise ValueError(f"checkpoint holds {saved['name']} state, the optimizer is {name}")
    missing = set(params) - set(saved["state"])
    if missing:
        raise KeyError(f"optimizer state lacks {len(missing)} parameters, e.g. {sorted(missing)[:3]}")
    for k, p in params.items():
        st = {s: torch.as_tensor(np.asarray(saved["state"][k][s]), dtype=p.dtype).to(p.device).clone()
              for s in STATE_KEYS[name]}
        if name == "adam":
            st["step"] = torch.tensor(float(saved["step"]))
        opt.state[p] = st
