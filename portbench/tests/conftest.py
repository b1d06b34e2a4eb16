"""The program's span recorder, filled by hand for the tests that read it.

`test_every_per_layer_reader_reads_a_trace` runs every per-layer reader of a
cell on a synthetic trace of 100 traced steps or requests; the readers of
program spans read the recorder's snapshot, so for that test alone the
snapshot is a synthetic one of the cell's roots and children, and the
recorder is reset after."""

import os

import pytest

from portbench.harness import read_json

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# per step or request: the root's host ms, and each child's (host ms, device ms or None)
TRAIN = ("ecgpan.train_step", 20.0, {"ecgpan.train_step.inputs": (2.0, None),
                                      "ecgpan.train_step.forward": (6.0, None),
                                      "ecgpan.train_step.backward": (9.0, None),
                                      "ecgpan.train_step.update": (2.5, None)})
RENDER = ("ecgpan.render", 30.0, {"ecgpan.encode": (8.0, 8.4), "ecgpan.basis_planes": (1.0, 2.0)})
TRACED = 100  # the traced steps or requests of the harness test's synthetic trace


def synthetic_snapshot(root: str, root_ms: float, children: dict, n: int) -> dict:
    """What profiling.snapshot() returns after `n` roots, each with the
    children one after the other from the root's start."""
    spans, sid, t = [], 0, 0
    for _ in range(n):
        sid += 1
        rid, start = sid, t
        for name, (host, dev) in children.items():
            sid += 1
            spans.append({"name": name, "id": sid, "parent": rid, "root": rid, "thread": 1, "start_ns": t,
                          "end_ns": t + int(host * 1e6), "device_ms": dev})
            t += int(host * 1e6)
        t = start + int(root_ms * 1e6)
        spans.append({"name": root, "id": rid, "parent": None, "root": rid, "thread": 1, "start_ns": start,
                      "end_ns": t, "device_ms": None})
    by_name = {root: {"calls": n, "host_ms": n * root_ms,
                      "self_ms": n * (root_ms - sum(h for h, _ in children.values())), "device_ms": None}}
    for name, (host, dev) in children.items():
        by_name[name] = {"calls": n, "host_ms": n * host, "self_ms": n * host,
                         "device_ms": None if dev is None else n * dev}
    return {"spans": spans, "by_name": by_name, "dropped": 0}


@pytest.fixture
def make_snapshot():
    return synthetic_snapshot


@pytest.fixture(autouse=True)
def cell_spans(request, monkeypatch):
    if request.node.originalname != "test_every_per_layer_reader_reads_a_trace":
        yield
        return
    from electrocardio_panorama_tpu_torch.utils import profiling

    cell = request.node.callspec.params["cell"]
    spec = read_json(ROOT, "portbench", "cells", f"{cell}.json")
    root, root_ms, children = TRAIN if spec["entry"] == "train" else RENDER
    snap = synthetic_snapshot(root, root_ms, children, TRACED)
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    yield
    profiling.reset()
