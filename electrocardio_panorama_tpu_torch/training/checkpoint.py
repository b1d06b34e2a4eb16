"""Checkpointing with the reference CheckPointer's file semantics
(utils/checkpointer.py:18-98), in the JAX package's on-disk format:

  * save(name, **extras) -> {save_dir}/{name}.pkl (a pickle of numpy
    arrays: {"model", "bn_state", ["optimizer"], **extras}) and the pointer
    file `last_checkpoint` holding its path;
  * load(): explicit path -> `last_checkpoint` pointer -> best_valid.pkl,
    and an explicit `MODEL.resume` path that does not exist raises.

The optimizer state is saved by parameter key (training/optim.py::
state_by_key) and comes back by key whichever package wrote it: a JAX
checkpoint's optax state pickles optax classes, which unpickle here as
tuples that keep their class names (so loading never imports jax) and map
onto the by-key form through `convert.optimizer_from_optax`. The JAX
package's CheckPointer loads a port checkpoint as it is; its optimizer dict
maps onto an optax state through `convert.optimizer_to_optax`. The Solver's
extras (`epoch`, `psnr_gen`, `psnr_reg`, `best_test_psnr_gen`) ride in every
epoch checkpoint. A reference PyTorch checkpoint (torch.save .pkl) loads
through `torch_import`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from electrocardio_panorama_tpu_torch.convert import optimizer_from_optax


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _to_torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


class _Foreign(tuple):
    """Stand-in for a class of the JAX stack (optax states are namedtuples)."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("optax", "jax", "jaxlib", "chex"):
            return type(name, (_Foreign,), {"__module__": module})
        return super().find_class(module, name)


class CheckPointer:
    def __init__(self, save_dir: str | None):
        self.save_dir = save_dir
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, name: str, *, params, bn_state, opt_state=None, **extras) -> str | None:
        if self.save_dir is None:
            return None
        payload = {"model": _to_numpy(params), "bn_state": _to_numpy(bn_state)}
        if opt_state is not None:
            payload["optimizer"] = _to_numpy(opt_state)
        payload.update(extras)
        path = os.path.join(self.save_dir, f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f, pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(path)
        return path

    # ------------------------------------------------------------------ load
    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.save_dir or ".", f"epoch_{epoch}.pkl")

    def resolve(self, resume: str | None = None, best_valid: bool = False) -> str | None:
        if resume:
            return resume
        if not self.save_dir:
            return None
        if best_valid:
            path = os.path.join(self.save_dir, "best_valid.pkl")
            return path if os.path.exists(path) else None
        ptr = os.path.join(self.save_dir, "last_checkpoint")
        if os.path.exists(ptr):
            with open(ptr) as f:
                return f.read().strip()
        return None

    def load(self, resume: str | None = None, best_valid: bool = False):
        """Returns (params, bn_state, opt_state, extras) with CPU tensors and
        opt_state by parameter key (or None), or None when there is nothing
        to load."""
        path = self.resolve(resume, best_valid)
        if resume and (path is None or not os.path.exists(path)):
            raise FileNotFoundError(
                f"MODEL.resume checkpoint not found: {resume!r} (resume takes "
                "a checkpoint PATH, e.g. output/run/desc/epoch_123.pkl)"
            )
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                payload = _Unpickler(f).load()
            native = (isinstance(payload, dict) and isinstance(payload.get("model"), dict)
                      and not any(isinstance(v, torch.Tensor) for v in payload["model"].values()))
        except Exception:  # noqa: BLE001 — a torch.save zip is not a plain pickle
            native = False
        if not native:
            from electrocardio_panorama_tpu_torch.training.torch_import import import_torch_pkl

            params, bn_state, extras = import_torch_pkl(path)
            return params, bn_state, None, extras
        params = _to_torch(payload.pop("model"))
        bn_state = _to_torch(payload.pop("bn_state", {}))
        opt_state = payload.pop("optimizer", None)
        if opt_state is not None and not (isinstance(opt_state, dict) and "state" in opt_state):
            opt_state = optimizer_from_optax(opt_state, params)  # written by the JAX package
        return params, bn_state, opt_state, payload
