"""eager_device_ms.train: device milliseconds a step outside the program's
custom ops: the eager model layers (cuDNN convolutions, ROI ops, BatchNorm),
the loss, the optimizer and the batch's copy to the device (torch.profiler,
the traced window)."""

from portbench.metrics._shared import eager_ms


def read(run):
    return eager_ms(run)
