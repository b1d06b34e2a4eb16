"""a1_roofline: the share of its roofline, in %, of A1, the streamed-basis
decode (ops/kernels/decoder_fused.py): one launch's least time at the cell's
shapes (counts/kernels.py::a1_work) over the device time of a launch under
the custom op ecgpan_torch::decoder_basis (the traced window)."""

from portbench.counts.kernels import bound_of
from portbench.metrics._shared import roofline_share


def read(run):
    c = run.cell
    views = c.mix["n_theta"] * c.mix["n_phi"]
    return roofline_share(run, "decoder_basis", bound_of("a1", c.mix["batch"], views, dtype=c.dtype))
