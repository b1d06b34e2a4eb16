"""a2_roofline: the share of its roofline, in %, of A2, the fused encoder's
forward (ops/kernels/encoder_fused.py): one launch's least time at the
cell's shapes (counts/kernels.py::a2_work) over the device time of a launch
under the custom op ecgpan_torch::encoder_fwd (the traced window)."""

from portbench.counts.kernels import bound_of
from portbench.metrics._shared import roofline_share


def read(run):
    c = run.cell
    return roofline_share(run, "encoder_fwd", bound_of("a2", c.mix["batch"], c.lead_num, dtype=c.dtype))
