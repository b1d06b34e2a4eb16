"""Shared by the per-layer readers: the arithmetic of the metrics that the
train and the render cells report under names of their own, and of the
kernels' rooflines."""


def idle_share(run):
    """100 * (1 - busy / window) of the traced window, busy being the union
    of device activity intervals."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def eager_ms(run):
    """Device milliseconds per step or request of the traced window outside
    the program's custom ops (ecgpan_torch::*)."""
    t = run.trace
    if t is None or not run.traced["attempted"]:
        return None
    return 1e3 * (t.device_s - sum(s for s, _ in t.ops.values())) / run.traced["attempted"]


def roofline_share(run, op: str, bound_s: float):
    """A kernel's share of its roofline, in %: one launch's least time at the
    cell's shapes (counts/kernels.py) over the device time of a launch under
    its custom op. None where the op did not run or the trace gives it no
    device time."""
    got = run.trace.op(op) if run.trace is not None else None
    if got is None or got[0] <= 0:
        return None
    device_s, launches = got
    return 100.0 * bound_s / (device_s / launches)
