"""Parameter and optimizer-state transfer from and to the JAX package.

The JAX package keeps its parameters in flat dicts keyed by the reference's
torch-style names, and so does the port, so every key maps by name: only the
array type changes. Callers hand the arrays over as numpy (the port never
imports jax); `np.asarray` on a jax array gives that.

Optimizer state maps by parameter key too. The JAX package's optimizer is
`optax.inject_hyperparams(optax.sgd | optax.adam)`, whose state nests
namedtuples: a `TraceState(trace)` for SGD with momentum, a
`ScaleByAdamState(count, mu, nu)` for Adam, and a hyperparams dict holding
`learning_rate`. The port keeps the same numbers by key
(training/optim.py::state_by_key): torch's `momentum_buffer` is optax's
trace, `exp_avg` / `exp_avg_sq` / `step` are Adam's mu / nu / count, and both
libraries apply them with the same update rule. The two functions below walk
such a state by class name and position only, so they work on the real optax
classes and on the tuples a JAX checkpoint unpickles to here
(training/checkpoint.py), without importing optax.
"""

from __future__ import annotations

import numpy as np
import torch

# optax state classes, matched by name: TraceState(trace, ...),
# ScaleByAdamState(count, mu, nu)
_OPTAX_TRACE = "TraceState"
_OPTAX_ADAM = "ScaleByAdamState"


def to_tensor(v, *, dtype=torch.float32, device="cpu") -> torch.Tensor:
    arr = np.array(v)  # a copy: torch.from_numpy shares memory
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(arr.astype(np.int64)).to(device)  # torch BN counters are Long
    return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)


def params_from_jax(params: dict, bn_state: dict, *, dtype=torch.float32, device="cpu"):
    """(params, bn_state) flat dicts of arrays -> the port's flat tensor dicts."""
    return ({k: to_tensor(v, dtype=dtype, device=device) for k, v in params.items()},
            {k: to_tensor(v, dtype=dtype, device=device) for k, v in bn_state.items()})


def _walk(tree):
    """Every node of a nest of tuples and dicts, depth first."""
    yield tree
    if isinstance(tree, tuple):
        for v in tree:
            yield from _walk(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)


def optimizer_from_optax(opt_state, param_keys) -> dict:
    """An optax inject_hyperparams(sgd(momentum) | adam) state -> the port's
    by-key optimizer dict {"name", "lr", "step", "state": {key: {torch state
    name: numpy}}} (training/optim.py::state_by_key)."""
    keys = list(param_keys)
    out = {"lr": None, "step": 0}
    for node in _walk(opt_state):
        cls = type(node).__name__
        if cls == _OPTAX_TRACE:
            out["name"] = "sgd"
            out["state"] = {k: {"momentum_buffer": np.asarray(node[0][k], np.float32)} for k in keys}
        elif cls == _OPTAX_ADAM:
            out["name"] = "adam"
            out["step"] = int(np.asarray(node[0]))
            out["state"] = {k: {"exp_avg": np.asarray(node[1][k], np.float32),
                                "exp_avg_sq": np.asarray(node[2][k], np.float32)} for k in keys}
        elif isinstance(node, dict) and "learning_rate" in node:
            out["lr"] = float(np.asarray(node["learning_rate"]))
    if "name" not in out:
        raise ValueError("not an optax sgd(momentum) or adam state: found no TraceState or ScaleByAdamState")
    return out


def optimizer_to_optax(saved: dict, template):
    """The port's by-key optimizer dict -> an optax state shaped like
    `template` (the caller's `tx.init(params)`), with numpy leaves: the trace,
    or mu / nu / count, and the injected learning rate replaced by key."""

    def by_key(name, like):
        return {k: np.asarray(saved["state"][k][name], np.float32) for k in like}

    def fill(node):
        cls = type(node).__name__
        if cls == _OPTAX_TRACE:
            return type(node)(by_key("momentum_buffer", node[0]), *node[1:])
        if cls == _OPTAX_ADAM:
            return type(node)(np.asarray(saved["step"], np.int32), by_key("exp_avg", node[1]),
                              by_key("exp_avg_sq", node[2]))
        if isinstance(node, dict):
            node = {k: fill(v) for k, v in node.items()}
            if "learning_rate" in node and saved.get("lr") is not None:
                node["learning_rate"] = np.asarray(saved["lr"], np.float32)
            return node
        if isinstance(node, tuple):
            vals = [fill(v) for v in node]
            return type(node)(*vals) if hasattr(node, "_fields") else type(node)(vals)
        return node

    want = {"sgd": _OPTAX_TRACE, "adam": _OPTAX_ADAM}[saved["name"]]
    if not any(type(n).__name__ == want for n in _walk(template)):
        raise ValueError(f"the template holds no {want}: it is not an optax {saved['name']} state")
    return fill(template)
