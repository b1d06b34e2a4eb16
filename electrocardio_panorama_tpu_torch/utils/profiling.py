"""The port's tracing: device-side timing of a window of work, for the
profile scripts, and spans at the program's layer boundaries.

Spans. `span(name)` marks a phase of the program (the train step and its
phases, the render entry, the wait for the loader). It records only while a
`torch.profiler` session is active or inside `recording()`; otherwise it
makes one check and returns a shared no-op context. A recorded span keeps its
name, its id, its parent's and its root's id (every span of one step or
request shares the root's), its thread's native id and its start and end in
`time.time_ns()`, the clock of the profiler's host events, so the two line
up. With a CUDA `device` it also records a CUDA event on the device's current
stream at its start and its end. `snapshot()` reduces what was recorded;
`merge_chrome_trace` writes the spans into a profiler's chrome trace.

A span never opens a `record_function` range: under CUDA activity the
profiler gives each such range a device-typed annotation event, which a
reader of the trace would count as device work. Names start with `ecgpan.`,
never `ecgpan_torch::`, the prefix of the program's custom ops.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 200_000  # spans past this many are counted as dropped, not kept


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


# ------------------------------------------------------------------ spans
class _Recorder:
    """The process's spans. One per process, as the profiler it follows is
    one per process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: the thread's open spans
        self.ids = itertools.count(1)
        self.forced = 0  # depth of recording() contexts
        self.spans = []  # (name, id, parent, root, thread, start_ns, end_ns, device, ev0, ev1)
        self.dropped = 0


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "device", "start", "ev0")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device if device and device.type == "cuda" else None

    def __enter__(self):
        stack = _REC.local.__dict__.setdefault("stack", [])
        self.id = next(_REC.ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else self.id
        stack.append(self)
        self.ev0 = None
        if self.device is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.device))
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        ev1 = None
        if self.device is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(torch.cuda.current_stream(self.device))
        _REC.local.stack.pop()
        rec = (self.name, self.id, self.parent, self.root, threading.get_native_id(), self.start, end,
               self.device, self.ev0, ev1)
        with _REC.lock:
            if len(_REC.spans) < MAX_SPANS:
                _REC.spans.append(rec)
            else:
                _REC.dropped += 1
        return False


def span(name: str, *, device=False):
    """A context that records the span `name` while recording is on (a
    torch.profiler session is active, or inside `recording()`), and does
    nothing otherwise. `device`: False, or the torch.device the span's work
    runs on; a CUDA device adds a pair of CUDA events on its current stream,
    which `snapshot()` turns into device milliseconds."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


@contextlib.contextmanager
def recording():
    """Record spans inside this context, without a profiler."""
    with _REC.lock:
        _REC.forced += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.forced -= 1


def reset() -> None:
    """Forget every recorded span and the count of those dropped."""
    with _REC.lock:
        _REC.spans = []
        _REC.dropped = 0


def _covered_ns(start: int, end: int, children) -> int:
    """The part of [start, end] that the union of the children's intervals
    covers."""
    covered, reach = 0, start
    for a, b in sorted(children):
        a, b = max(a, reach), min(b, end)
        if b > a:
            covered += b - a
            reach = b
    return covered


def snapshot() -> dict:
    """The recorded spans and their sums by name, without clearing them.

    Synchronizes each device that a span timed once, then returns
    {'spans': [one dict per span: name, id, parent (None for a root), root,
    thread, start_ns, end_ns, device_ms (None without events)],
     'by_name': {name: {'calls', 'host_ms', 'self_ms', 'device_ms'}} (totals
     over the calls; self ms is host ms less the part the span's children
     cover; device ms None where the name recorded no events),
     'dropped': spans not kept past MAX_SPANS}."""
    with _REC.lock:
        recs, dropped = list(_REC.spans), _REC.dropped
    for dev in {r[7] for r in recs if r[7] is not None}:
        torch.cuda.synchronize(dev)
    children = defaultdict(list)
    for r in recs:
        if r[2] is not None:
            children[r[2]].append((r[5], r[6]))
    spans, by_name = [], {}
    for name, sid, parent, root, thread, start, end, _, ev0, ev1 in recs:
        device_ms = ev0.elapsed_time(ev1) if ev0 is not None else None
        spans.append({"name": name, "id": sid, "parent": parent, "root": root, "thread": thread,
                      "start_ns": start, "end_ns": end, "device_ms": device_ms})
        s = by_name.setdefault(name, {"calls": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None})
        s["calls"] += 1
        s["host_ms"] += (end - start) / 1e6
        s["self_ms"] += (end - start - _covered_ns(start, end, children.get(sid, ()))) / 1e6
        if device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + device_ms
    return {"spans": spans, "by_name": by_name, "dropped": dropped}


def summary_lines(snap: dict) -> list[str]:
    """One line per span name: calls, host ms a call, self ms a call (and
    device ms a call where the span timed the device)."""
    lines = []
    for name, s in sorted(snap["by_name"].items()):
        n = s["calls"]
        line = f"span {name}: {n} calls, host {s['host_ms'] / n:.3f} ms a call, self {s['self_ms'] / n:.3f} ms a call"
        if s["device_ms"] is not None:
            line += f", device {s['device_ms'] / n:.3f} ms a call"
        lines.append(line)
    if snap["dropped"]:
        lines.append(f"spans dropped past {MAX_SPANS}: {snap['dropped']}")
    return lines


def merge_chrome_trace(path: str, spans: list[dict]) -> None:
    """Add `spans` (snapshot()['spans']) to the chrome trace at `path`, as
    complete events on their threads of this process, on the file's own time
    base (its 'baseTimeNanoseconds', where it has one)."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    for s in spans:
        args = {"id": s["id"], "parent": s["parent"], "root": s["root"]}
        if s["device_ms"] is not None:
            args["device_ms"] = s["device_ms"]
        trace["traceEvents"].append({
            "ph": "X", "cat": "ecgpan_span", "name": s["name"], "pid": pid, "tid": s["thread"],
            "ts": (s["start_ns"] - base) / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
