"""a3_roofline: the share of its roofline, in %, of A3, the fused encoder's
backward (ops/kernels/encoder_fused.py): one launch's least time at the
cell's shapes (counts/kernels.py::a3_work) over the device time of a launch
under the custom op ecgpan_torch::encoder_bwd (the traced window)."""

from portbench.counts.kernels import bound_of
from portbench.metrics._shared import roofline_share


def read(run):
    c = run.cell
    return roofline_share(run, "encoder_bwd", bound_of("a3", c.mix["batch"], c.lead_num, dtype=c.dtype))
