"""The readers of the program's spans on hand-made snapshots: a phase's sum
per root span (a step or a request), and nothing read without a trace,
without a root span, without device time, or from a program without the
span recorder."""

import os

import pytest

from portbench import harness
from portbench.tests.conftest import RENDER, TRAIN
from portbench.tracing import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAIN_CELL, RENDER_CELL = "nefnet.train.f32.b85", "nefnet.render.f32.v336"
READERS = {"inputs_host_ms.train": (TRAIN_CELL, 2.0), "forward_host_ms.train": (TRAIN_CELL, 6.0),
           "backward_host_ms.train": (TRAIN_CELL, 9.0), "update_host_ms.train": (TRAIN_CELL, 2.5),
           "encode_device_ms.render": (RENDER_CELL, 8.4), "basis_planes_device_ms.render": (RENDER_CELL, 2.0)}


def traced_run(cell):
    trace = Trace(window_s=3.0, busy_s=2.0, device_s=2.0, by_kernel={"k": 2.0})
    return harness.Run(harness.load_cell(ROOT, cell), {"seconds": 10.0, "attempted": 40, "failed": 0},
                       {"seconds": 3.0, "attempted": 7, "failed": 0}, trace)


def fill(monkeypatch, snap):
    from electrocardio_panorama_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: snap)


@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_divides_by_the_root_spans(metric, n, make_snapshot, monkeypatch):
    cell, want = READERS[metric]
    fill(monkeypatch, make_snapshot(*(TRAIN if cell == TRAIN_CELL else RENDER), n))
    got = harness.load_reader(ROOT, metric)(traced_run(cell))
    assert isinstance(got, float) and got == pytest.approx(want)


def test_reader_counts_only_root_spans(make_snapshot, monkeypatch):
    """A span of the root's name nested under another span is no step."""
    snap = make_snapshot(*TRAIN, 4)
    snap["spans"].append(dict(snap["spans"][-1], id=10**6, parent=1))
    fill(monkeypatch, snap)
    assert harness.load_reader(ROOT, "forward_host_ms.train")(traced_run(TRAIN_CELL)) == pytest.approx(6.0)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_without_trace_or_roots(metric, make_snapshot, monkeypatch):
    cell, _ = READERS[metric]
    read = harness.load_reader(ROOT, metric)
    fill(monkeypatch, make_snapshot(*(TRAIN if cell == TRAIN_CELL else RENDER), 3))
    assert read(harness.Run(harness.load_cell(ROOT, cell), {"seconds": 1.0, "attempted": 1, "failed": 0})) is None
    other = RENDER if cell == TRAIN_CELL else TRAIN  # spans, but none of this cell's roots
    fill(monkeypatch, make_snapshot(*other, 3))
    assert read(traced_run(cell)) is None
    fill(monkeypatch, {"spans": [], "by_name": {}, "dropped": 0})
    assert read(traced_run(cell)) is None


@pytest.mark.parametrize("metric", ["encode_device_ms.render", "basis_planes_device_ms.render"])
def test_device_reader_reads_nothing_without_device_time(metric, make_snapshot, monkeypatch):
    root, root_ms, children = RENDER
    fill(monkeypatch, make_snapshot(root, root_ms, {k: (h, None) for k, (h, _) in children.items()}, 3))
    assert harness.load_reader(ROOT, metric)(traced_run(RENDER_CELL)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_from_a_program_without_spans(metric, monkeypatch):
    """A program without the recorder (the commit before it) reads None and
    raises nothing."""
    from electrocardio_panorama_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert harness.load_reader(ROOT, metric)(traced_run(READERS[metric][0])) is None


def test_readers_read_the_recorder_itself(monkeypatch):
    """Without a hand-made snapshot the readers read what the program's
    recorder holds: here spans recorded on the CPU."""
    from electrocardio_panorama_tpu_torch.utils import profiling

    profiling.reset()
    try:
        with profiling.recording():
            for _ in range(2):
                with profiling.span("ecgpan.train_step"):
                    with profiling.span("ecgpan.train_step.update"):
                        pass
        got = harness.load_reader(ROOT, "update_host_ms.train")(traced_run(TRAIN_CELL))
        snap = profiling.snapshot()
        assert got == pytest.approx(snap["by_name"]["ecgpan.train_step.update"]["host_ms"] / 2)
        assert harness.load_reader(ROOT, "inputs_host_ms.train")(traced_run(TRAIN_CELL)) is None
    finally:
        profiling.reset()
