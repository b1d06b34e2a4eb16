"""Breakpoint-annotation schema I/O.

The reference's PyQt5 annotation tool (AnnotationTools/window.py) saves one
JSON per record with six integer-list keys — "P on", "P off", "R on", "R off",
"T on", "T off" (window.py:221-233) — the exact format the datasets consume
(tianchi.py:95-101). This module is the headless core of that tool: load/save/
validate the schema and parse the tool's input txt records
(AnnotationTools/read_data.py:4-15: space-separated ints, first header line
skipped, 5000 samples x 8 leads).
"""

from __future__ import annotations

import json

import numpy as np

BREAKPOINT_KEYS = ("P on", "P off", "R on", "R off", "T on", "T off")


def read_ecg_txt(path: str) -> np.ndarray:
    """Parse the annotation tool's txt record format -> [8, T] int array."""
    rows = []
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines[1:]:  # skip header line
        parts = line.split()
        if not parts:
            continue
        rows.append([int(float(x)) for x in parts])
    return np.asarray(rows, dtype=np.int64).T


def load_breakpoints(path: str) -> dict:
    with open(path) as f:
        bp = json.load(f)
    validate_breakpoints(bp)
    return bp


def save_breakpoints(bp: dict, path: str) -> None:
    validate_breakpoints(bp)
    with open(path, "w") as f:
        json.dump({k: [int(x) for x in bp[k]] for k in BREAKPOINT_KEYS}, f)


def validate_breakpoints(bp: dict, record_len: int | None = None) -> None:
    """Schema + ordering invariants the datasets rely on:
      * all six keys present, equal lengths;
      * within each beat: P on <= P off <= R on <= R off <= T on <= T off;
      * beats sorted: next P on >= current T off;
      * all indices within [0, record_len) when record_len given.
    Raises ValueError on violation."""
    missing = [k for k in BREAKPOINT_KEYS if k not in bp]
    if missing:
        raise ValueError(f"missing breakpoint keys: {missing}")
    lens = {k: len(bp[k]) for k in BREAKPOINT_KEYS}
    if len(set(lens.values())) != 1:
        raise ValueError(f"unequal breakpoint list lengths: {lens}")
    n = lens["P on"]
    cols = np.asarray([[bp[k][i] for k in BREAKPOINT_KEYS] for i in range(n)])
    if n:
        if (np.diff(cols, axis=1) < 0).any():
            raise ValueError("breakpoints out of order within a beat")
        if n > 1 and (cols[1:, 0] < cols[:-1, 5]).any():
            raise ValueError("beats overlap (next P on before current T off)")
        if record_len is not None and (cols.min() < 0 or cols.max() >= record_len):
            raise ValueError(f"breakpoint outside [0, {record_len})")


def beats_in(bp: dict) -> int:
    """Usable beats: consecutive (P on)_i .. (P on)_{i+1} windows
    (tianchi.py:97 draws from range(len(P on) - 1))."""
    return max(len(bp["P on"]) - 1, 0)
