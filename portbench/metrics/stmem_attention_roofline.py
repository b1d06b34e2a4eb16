"""stmem_attention_roofline: the forward attention's share of its roofline,
in %: the least time of its work at the cell's batch (counts/peaks.py::bound_s
of counts/<config>.py::attention_flops and attention_bytes: q kᵀ and the
product with v, q, k and v read once and the output written once, in every
block) over the spans ecgpan.stmem.attention's stream time a step
(stmem_attention_device_ms.train). None where the spans are not recorded."""

from portbench.counts.peaks import bound_s
from portbench.metrics._spans import TRAIN_ROOT, per_root

SPAN = "ecgpan.stmem.attention"


def read(run):
    ms = per_root(run, SPAN, TRAIN_ROOT, "device_ms")
    if not ms:
        return None
    c = run.cell
    counts, batch = c.counts(), c.mix["batch"]
    return 100.0 * bound_s(counts.attention_flops(batch), counts.attention_bytes(batch), c.dtype) / (ms / 1e3)
