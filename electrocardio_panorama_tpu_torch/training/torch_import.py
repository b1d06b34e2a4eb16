"""Reference PyTorch checkpoints (torch.save .pkl) -> the port's flat dicts.

Parameters are stored under the reference's torch-style names, so the import
is an identity key mapping: BatchNorm buffers (running_mean / running_var /
num_batches_tracked) split into the state dict, and DataParallel 'module.'
prefixes are stripped (reference utils/checkpointer.py:73-91).
"""

from __future__ import annotations

import torch

_STATE_MARKERS = ("running_mean", "running_var", "num_batches_tracked")


def strip_module_prefix(state_dict: dict) -> dict:
    keys = list(state_dict.keys())
    if keys and all(k.startswith("module.") for k in keys):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    return state_dict


def split_params_state(state_dict: dict, dtype=torch.float32):
    """{torch_name: tensor} -> (params, state) flat dicts; integer buffers
    keep their integer type."""
    params, state = {}, {}
    for k, v in strip_module_prefix(state_dict).items():
        t = torch.as_tensor(v)
        t = t if not t.is_floating_point() else t.to(dtype)
        (state if k.endswith(_STATE_MARKERS) else params)[k] = t
    return params, state


def import_torch_pkl(path: str, dtype=torch.float32):
    """Load a reference `.pkl` checkpoint. Returns (params, state, extras),
    extras carrying epoch/psnr metadata as the reference CheckPointer stores
    them (checkpointer.py:18-35)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model_sd = ckpt.pop("model") if "model" in ckpt else ckpt
    params, state = split_params_state(model_sd, dtype)
    extras = {k: v for k, v in ckpt.items() if k not in ("optimizer", "scheduler")}
    return params, state, extras
