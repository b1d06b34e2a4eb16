"""eager_device_ms.render: device milliseconds a render request outside the
program's custom ops: the eager encode and the basis planes (torch.profiler,
the traced window)."""

from portbench.metrics._shared import eager_ms


def read(run):
    return eager_ms(run)
