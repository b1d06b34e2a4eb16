"""stmem_attention_device_ms.train: stream milliseconds a train step between
the CUDA events of the spans ecgpan.stmem.attention (models/stmem.py::block:
q kᵀ, the softmax and the product with v, without the projections; one a
block), summed over the traced window and divided by its ecgpan.train_step
spans: the forward's attention. None where the program records no such
span."""

from portbench.metrics._spans import TRAIN_ROOT, per_root

SPAN = "ecgpan.stmem.attention"


def read(run):
    return per_root(run, SPAN, TRAIN_ROOT, "device_ms")
