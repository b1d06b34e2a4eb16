"""forward_host_ms.train: host milliseconds a train step spends in the span
ecgpan.train_step.forward (training/solver.py::Solver.train_step), summed over
the traced window and divided by its ecgpan.train_step spans. Read under
torch.profiler, which slows the host: compare it between commits, not with
dispatch_ms.train."""

from portbench.metrics._spans import TRAIN_ROOT, per_root


def read(run):
    return per_root(run, TRAIN_ROOT + ".forward", TRAIN_ROOT, "host_ms")
