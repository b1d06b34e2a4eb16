"""a4f_roofline: the share of its roofline, in %, of A4f, the fused train
decoder's forward (ops/kernels/decoder_train.py): one launch's least time at
the cell's shapes (counts/kernels.py::a4f_work) over the device time of a
launch under the custom op ecgpan_torch::decoder_train_fwd (the traced
window)."""

from portbench.counts.kernels import bound_of
from portbench.metrics._shared import roofline_share


def read(run):
    c = run.cell
    return roofline_share(run, "decoder_train_fwd", bound_of("a4f", c.mix["batch"], dtype=c.dtype))
