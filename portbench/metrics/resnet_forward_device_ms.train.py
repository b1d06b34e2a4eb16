"""resnet_forward_device_ms.train: stream milliseconds a train step between
the CUDA events of the span ecgpan.resnet1d.forward
(models/resnet1d.py::resnet1d_apply, stem to head), summed over the traced
window and divided by its ecgpan.train_step spans. None where the program
records no such span (a model without it, or a program before it)."""

from portbench.metrics._spans import TRAIN_ROOT, per_root

SPAN = "ecgpan.resnet1d.forward"


def read(run):
    return per_root(run, SPAN, TRAIN_ROOT, "device_ms")
