"""stmem_forward_roofline: the ViT forward's share of its roofline, in %: the
forward's frozen operation count at the cell's batch
(counts/<config>.py::forward_flops, 70.71 GFLOP a record) over the span
ecgpan.stmem.forward's stream time a step (stmem_forward_device_ms.train)
and the dtype's published peak. A float32 forward of GEMMs is bound by
arithmetic, so the bound is the count over the peak. None where the span is
not recorded."""

from portbench.counts.peaks import peak_flops
from portbench.metrics._spans import TRAIN_ROOT, per_root

SPAN = "ecgpan.stmem.forward"


def read(run):
    ms = per_root(run, SPAN, TRAIN_ROOT, "device_ms")
    if not ms:
        return None
    c = run.cell
    return 100.0 * c.counts().forward_flops(c.mix["batch"]) / (ms / 1e3) / peak_flops(c.dtype)
