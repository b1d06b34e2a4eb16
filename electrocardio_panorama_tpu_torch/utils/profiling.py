"""Device-side timing of a window of work, for the port's profile scripts."""

from __future__ import annotations

import time

import torch


def device_window(run, n: int, top: int = 12) -> dict:
    """Run `run()` once under torch.profiler and divide by `n` (the batches
    or steps it holds): device ms by kernel name (the `top` largest), their
    sum, the union of kernel intervals on the device timeline (busy), its
    share of the window's host-clock time, and that window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops report their kernels' time too
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            by_kernel[e.key[:80]] = dev_us / 1e3 / n
    # busy time: the union of kernel intervals (kernels may overlap)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return {
        "by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]),
        "kernel_sum_ms": sum(by_kernel.values()),
        "busy_ms": busy_us / 1e3 / n,
        "busy_share": busy_us / 1e6 / window,
        "window_ms": 1e3 * window / n,
    }
