"""The traced window: torch.profiler over a run of the timed path, reduced to
what the per-layer metrics read.

`device_window` is a copy of the program's utils/profiling.py::device_window
(device time by kernel, the union of kernel intervals as busy time), extended
with each custom op's device time and launch count, and the device's idle
gaps attributed to what the host was doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

OP_PREFIX = "ecgpan_torch::"
GAPS_ATTRIBUTED = 2000  # the longest idle gaps, each attributed to a host op
TOP = 10


@dataclass
class Trace:
    window_s: float                      # the traced window, host clock, from a synchronize to a synchronize
    busy_s: float                        # union of device activity intervals
    device_s: float                      # sum of device activity durations
    by_kernel: dict                      # device name -> seconds
    ops: dict = field(default_factory=dict)  # custom op -> (device seconds, launches)
    idle_by_host: dict = field(default_factory=dict)  # host op -> idle seconds of the device under it

    def op(self, name: str):
        """(device seconds, launches) under the custom op `ecgpan_torch::name`,
        or None where it did not run."""
        v = self.ops.get(OP_PREFIX + name)
        return v if v and v[1] > 0 else None

    def breakdown(self) -> dict:
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _device_time_us(e) -> float:
    v = getattr(e, "device_time_total", None)
    return float(v if v is not None else getattr(e, "cuda_time_total", 0.0))


def device_window(run) -> tuple[object, Trace]:
    """Run `run()` under torch.profiler (CPU and CUDA activity) and reduce
    the trace. `run` synchronizes the device at its start and end and returns
    (result, seconds of its window)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        result, window_s = run()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events if e.device_type == cuda)
    by_kernel = defaultdict(float)
    busy_us, device_us, end = 0.0, 0.0, float("-inf")
    gaps = []
    for a, b, name in dev:
        by_kernel[name[:120]] += (b - a) / 1e6
        device_us += b - a
        if a > end > float("-inf"):
            gaps.append((a - end, end, a))
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    ops = {}
    for e in prof.key_averages():
        if e.key.startswith(OP_PREFIX):
            ops[e.key] = (_device_time_us(e) / 1e6, int(e.count))
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type != cuda and e.time_range.end > e.time_range.start)
    return result, Trace(window_s=window_s, busy_s=busy_us / 1e6, device_s=device_us / 1e6,
                         by_kernel=dict(by_kernel), ops=ops, idle_by_host=_attribute_gaps(gaps, host))


def _attribute_gaps(gaps, host) -> dict:
    """Sum the longest idle gaps of the device by the innermost host op that
    was running when each began ('(host outside any op)' where none was)."""
    starts = [h[0] for h in host]
    out = defaultdict(float)
    for length, a, _ in sorted(gaps, reverse=True)[:GAPS_ATTRIBUTED]:
        i = bisect.bisect_right(starts, a) - 1
        name = "(host outside any op)"
        for j in range(i, max(i - 4000, -1), -1):  # latest-starting op that still covers a
            if host[j][1] >= a:
                name = host[j][2]
                break
        out[name[:120]] += length / 1e6
    return dict(out)


def timed(window, *args):
    """Adapter: a window function returning a dict with 'seconds' -> the
    (result, seconds) pair device_window takes."""
    def run():
        r = window(*args)
        return r, r["seconds"]
    return run
