"""device_idle_share.render: the share of the traced window, in %, in which no
operation ran on the device: 100 * (1 - busy / window), busy being the union
of device activity intervals (torch.profiler)."""

from portbench.metrics._shared import idle_share as read  # noqa: F401
