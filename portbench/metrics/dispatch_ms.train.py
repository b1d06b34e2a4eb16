"""dispatch_ms.train: host milliseconds a call of Solver.train_step takes to
return, unsynchronized, averaged over the measured window's steps (host
clock around each call)."""


def read(run):
    w = run.window
    if not w["attempted"]:
        return None
    return 1e3 * w["dispatch_s"] / w["attempted"]
