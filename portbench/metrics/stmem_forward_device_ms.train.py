"""stmem_forward_device_ms.train: stream milliseconds a train step between
the CUDA events of the span ecgpan.stmem.forward
(models/stmem.py::stmem_apply, the embedding, the twelve blocks and the
head), summed over the traced window and divided by its ecgpan.train_step
spans. None where the program records no such span (another model, or a
program before it)."""

from portbench.metrics._spans import TRAIN_ROOT, per_root

SPAN = "ecgpan.stmem.forward"


def read(run):
    return per_root(run, SPAN, TRAIN_ROOT, "device_ms")
