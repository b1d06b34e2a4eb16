"""basis_planes_device_ms.render: stream milliseconds a render request
between the CUDA events of the span ecgpan.basis_planes
(ops/kernels/decoder_fused.py::fused_decode_views: the basis planes and
their mix coefficients, before A1), summed over the traced window and divided
by its ecgpan.render spans."""

from portbench.metrics._spans import RENDER_ROOT, per_root


def read(run):
    return per_root(run, "ecgpan.basis_planes", RENDER_ROOT, "device_ms")
