"""encode_device_ms.render: stream milliseconds a render request between the
CUDA events of the span ecgpan.encode (synthesis.py::PanoramaGenerator.render:
the eager encode with its conversions), summed over the traced window and
divided by its ecgpan.render spans."""

from portbench.metrics._spans import RENDER_ROOT, per_root


def read(run):
    return per_root(run, "ecgpan.encode", RENDER_ROOT, "device_ms")
