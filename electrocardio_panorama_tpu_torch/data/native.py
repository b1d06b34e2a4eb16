"""ctypes bindings for the native beat-preprocessing library (native/beatprep.cpp).

The C library implements the per-example hot loop — derive augmented leads,
slice, joint min-max normalize, noise-sigma estimate, pad-to-512 — in one call,
replacing the reference's Python inner loops across 16 DataLoader worker
processes (train_net.py:27). Falls back to the pure-numpy path transparently
when the library is absent or the toolchain can't build it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libbeatprep.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        build = os.path.join(_REPO_ROOT, "native", "build.sh")
        if os.path.exists(build):
            try:
                subprocess.run(["sh", build], check=True, capture_output=True, timeout=120)
            except Exception:
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ecg_prep_beat.restype = ctypes.c_int
        lib.ecg_prep_beat.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        if lib.ecg_prep_abi_version() != 1:
            return None
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def prep_beat(rec8: np.ndarray, p_on: int, end_point: int, tp_mid: int, tp_end: int):
    """rec8: [8, T] float64 contiguous. Returns (beat12 [12,512] f32 normalized
    + padded, noise_sigma [12] f32) or None when the native path is unavailable."""
    lib = _load()
    if lib is None:
        return None
    rec8 = np.ascontiguousarray(rec8, dtype=np.float64)
    out = np.zeros((12, 512), np.float32)
    sig = np.zeros(12, np.float32)
    rc = lib.ecg_prep_beat(
        rec8.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rec8.shape[1],
        int(p_on), int(end_point), int(tp_mid), int(tp_end),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sig.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError(f"ecg_prep_beat failed with code {rc}")
    return out, sig
