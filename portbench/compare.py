"""The comparisons that decide `correct`: the program's outputs against the
plain reference's, as numbers each held to a limit of its own (the cell's
`limits`).

Train cells compare norms leaf by leaf, as the gap between the program's norm
of a leaf and the reference's (not the norm of their difference), against
the reference's norm of that leaf or of the median leaf, whichever is
larger; the worst leaf is the number. The change of the parameters leaves
out the leaves whose reference gradient is under a thousandth of the median
leaf's (a conv bias ahead of a train-mode BatchNorm, or a weight no path
uses): those move under SGD by rounding alone.
"""

from __future__ import annotations

import torch

NOUGHT_GRADIENT = 1e-3


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def worst_norm_gap(prog: dict, ref: dict, keys) -> float:
    """max over `keys` of |‖prog[k]‖ - ‖ref[k]‖| / max(‖ref[k]‖, median_k ‖ref[k]‖).
    A leaf missing on the program's side counts as norm 0."""
    keys = list(keys)
    r = norms({k: ref[k] for k in keys})
    p = norms({k: prog[k] for k in keys if k in prog})
    med = float(torch.tensor(sorted(r.values())).median()) if r else 0.0
    gaps = [abs(p.get(k, 0.0) - r[k]) / max(r[k], med, 1e-30) for k in keys]
    if not all(g == g and g != float("inf") for g in gaps):
        return float("inf")  # a non-finite norm on either side
    return max(gaps, default=0.0)


def moving_leaves(ref_grads: dict) -> list[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    g = norms(ref_grads)
    med = float(torch.tensor(sorted(g.values())).median())
    return [k for k, v in g.items() if v >= NOUGHT_GRADIENT * med]


def loss_gaps(prog: dict, ref: dict) -> list[float]:
    """|loss_p - loss_r| / |loss_r| of each step (non-finite reads as
    infinite)."""
    lp, lr = prog["losses"][:, 0].double(), ref["losses"][:, 0].double()
    gaps = (lp - lr).abs() / lr.abs()
    return [float(g) if torch.isfinite(g) else float("inf") for g in gaps]


def train_readings(prog: dict, ref: dict, p0: dict, s0: dict) -> dict:
    """prog / ref: {'losses': [3, 4], 'grads': first step's gradients,
    'params': after step 3, 'bn_state': running statistics after step 3};
    p0 / s0 the state both started from. Returns the compared numbers:
      loss_gap   the first step's relative loss gap (the later steps' gaps
                 carry the first update's rounding and swing from seed to
                 seed; the update and BN numbers hold those steps)
      grad_gap   worst leaf's norm gap of the first gradient
      update_gap worst moving leaf's norm gap of the change over the steps
      bn_gap     worst leaf's norm gap of the running statistics' change."""
    loss_gap = loss_gaps(prog, ref)[0]
    grad_gap = worst_norm_gap(prog["grads"], ref["grads"], ref["grads"])
    moving = moving_leaves(ref["grads"])
    dp = {k: prog["params"][k] - p0[k] for k in moving}
    dr = {k: ref["params"][k] - p0[k] for k in moving}
    stats = [k for k, v in s0.items() if v.is_floating_point()]
    bp = {k: prog["bn_state"][k] - s0[k] for k in stats}
    br = {k: ref["bn_state"][k] - s0[k] for k in stats}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": worst_norm_gap(dp, dr, moving),
            "bn_gap": worst_norm_gap(bp, br, stats)}


def view_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap of a rendered sample from the reference's: max |p - r|
    over every beat, view and sample (non-finite reads as infinite)."""
    d = (prog.double() - ref.double()).abs()
    return float("inf") if not torch.isfinite(d).all() else float(d.max())
