"""a4b_roofline: the share of its roofline, in %, of A4b, the fused train
decoder's backward (ops/kernels/decoder_train.py): one launch's least time
at the cell's shapes (counts/kernels.py::a4b_work) over the device time of a
launch under the custom op ecgpan_torch::decoder_train_bwd (the traced
window)."""

from portbench.counts.kernels import bound_of
from portbench.metrics._shared import roofline_share


def read(run):
    c = run.cell
    return roofline_share(run, "decoder_train_bwd", bound_of("a4b", c.mix["batch"], dtype=c.dtype))
