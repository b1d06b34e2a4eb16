"""The port's annotation tooling (electrocardio_panorama_tpu_torch.annotation):
every case of tests/test_annotation.py against the port (schema I/O,
validation, txt parsing, auto-segmentation, the CLI, the round trip into the
port's own `build_dataset`, the plot and the interactive marker); the port's
`auto_segment` and `detect_r_peaks` equal the JAX package's exactly on seeded
synthetic records; and segment / validate / show run with matplotlib
unimportable."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from electrocardio_panorama_tpu.annotation import auto_segment as jax_auto_segment
from electrocardio_panorama_tpu.annotation import detect_r_peaks as jax_detect_r_peaks
from electrocardio_panorama_tpu_torch.annotation import (
    auto_segment,
    beats_in,
    detect_r_peaks,
    load_breakpoints,
    read_ecg_txt,
    save_breakpoints,
    validate_breakpoints,
)
from electrocardio_panorama_tpu_torch.annotation.cli import main as anno_cli
from electrocardio_panorama_tpu_torch.data.synthetic import synth_record

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_schema_roundtrip(tmp_path):
    bp = {"P on": [10, 500], "P off": [40, 530], "R on": [100, 590],
          "R off": [150, 640], "T on": [220, 710], "T off": [300, 790]}
    path = str(tmp_path / "x.json")
    save_breakpoints(bp, path)
    loaded = load_breakpoints(path)
    assert loaded == bp
    assert beats_in(bp) == 1


@pytest.mark.parametrize("mutate,msg", [
    (lambda bp: bp.pop("T on"), "missing"),
    (lambda bp: bp["P on"].append(999), "unequal"),
    (lambda bp: bp["R on"].__setitem__(0, 5), "out of order"),
    (lambda bp: bp["P on"].__setitem__(1, 200), "overlap"),
])
def test_schema_validation_errors(mutate, msg):
    bp = {"P on": [10, 500], "P off": [40, 530], "R on": [100, 590],
          "R off": [150, 640], "T on": [220, 710], "T off": [300, 790]}
    mutate(bp)
    with pytest.raises(ValueError, match=msg):
        validate_breakpoints(bp)


def test_read_ecg_txt(tmp_path):
    path = str(tmp_path / "rec.txt")
    with open(path, "w") as f:
        f.write("I II V1 V2 V3 V4 V5 V6\n")
        for t in range(20):
            f.write(" ".join(str(t * 8 + i) for i in range(8)) + "\n")
    rec = read_ecg_txt(path)
    assert rec.shape == (8, 20)
    assert rec[0, 0] == 0 and rec[7, 19] == 19 * 8 + 7


def test_auto_segment_on_synthetic_record():
    data, true_bp = synth_record(np.random.default_rng(3), total_len=5000)
    bp = auto_segment(data, fs=500.0, lead=1)
    validate_breakpoints(bp, record_len=5000)
    n_true = len(true_bp["P on"])
    n_det = len(bp["P on"])
    # R detection should find most beats
    assert n_det >= 0.6 * n_true, (n_det, n_true)
    # detected R windows should straddle true R regions
    true_r = np.array([(a + b) / 2 for a, b in zip(true_bp["R on"], true_bp["R off"])])
    hits = 0
    for r_on, r_off in zip(bp["R on"], bp["R off"]):
        if ((true_r >= r_on - 40) & (true_r <= r_off + 40)).any():
            hits += 1
    assert hits >= 0.8 * n_det


def test_detect_r_peaks_count():
    data, true_bp = synth_record(np.random.default_rng(5), total_len=5000)
    peaks = detect_r_peaks(data[1], fs=500.0)
    assert abs(len(peaks) - len(true_bp["R on"])) <= 2


def test_cli_segment_validate_show(tmp_path, capsys):
    data, _ = synth_record(np.random.default_rng(7), total_len=3000)
    rec_path = str(tmp_path / "rec.npy")
    np.save(rec_path, data)
    assert anno_cli(["segment", rec_path]) == 0
    out_json = str(tmp_path / "rec.json")
    assert anno_cli(["validate", out_json, "--record", rec_path]) == 0
    assert anno_cli(["show", out_json]) == 0
    captured = capsys.readouterr().out
    assert "OK:" in captured

    # corrupt the json -> validate fails with nonzero exit
    bp = json.load(open(out_json))
    bp["R on"][0] = 0
    json.dump(bp, open(out_json, "w"))
    assert anno_cli(["validate", out_json]) == 1


def test_auto_segmented_record_feeds_dataset(tmp_path):
    """End-to-end: auto-segment a synthetic record, then the port's
    `build_dataset` (Tianchi layout) consumes it."""
    from electrocardio_panorama_tpu_torch.config import get_cfg
    from electrocardio_panorama_tpu_torch.data import build_dataset

    data, _ = synth_record(np.random.default_rng(11), total_len=5000)
    npy_dir = tmp_path / "npy"
    json_dir = tmp_path / "labels"
    npy_dir.mkdir(), json_dir.mkdir()
    np.save(str(npy_dir / "r0.npy"), data)
    bp = auto_segment(data)
    save_breakpoints(bp, str(json_dir / "r0.json"))
    (tmp_path / "list.txt").write_text("r0.json\n")

    cfg = get_cfg()
    cfg.DATA.dataset = "tianchi"
    cfg.DATA.lead_num = 3
    cfg.DATA.super_mode = "IIv2v5_v4I_372"
    cfg.DATA.train_data_mode = "input_fix"
    cfg.DATA.train_label_path = str(tmp_path / "list.txt")
    cfg.DATA.test_label_path = str(tmp_path / "list.txt")
    cfg.DATA.train_data_root = str(npy_dir)
    cfg.DATA.train_label_root = str(json_dir)
    ds = build_dataset(cfg, "train")
    meta = ds.__getitem__(0, rng=np.random.default_rng(0))
    assert meta["data"].shape == (3, 512)
    assert meta["rois"][0, 0] == 0 and meta["rois"][-1, 1] == 512


def test_cli_plot(tmp_path):
    data, _ = synth_record(np.random.default_rng(9), total_len=3000)
    rec = str(tmp_path / "r.npy")
    np.save(rec, data)
    assert anno_cli(["segment", rec]) == 0
    out = str(tmp_path / "overlay.png")
    assert anno_cli(["plot", rec, "--out", out]) == 0
    assert os.path.getsize(out) > 5000
    # plot without a label file still renders (no overlays)
    rec2 = str(tmp_path / "r2.npy")
    np.save(rec2, data)
    assert anno_cli(["plot", rec2]) == 0


def test_interactive_annotator_headless(tmp_path):
    """The interactive marker's full loop, driven by synthetic canvas events
    on the Agg backend: crosshair motion -> keys 1-6 mark at the cursor ->
    undo -> save -> next-file autosave (reference window.py:93-104,135-161,
    221-259)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.backend_bases import KeyEvent, MouseEvent

    from electrocardio_panorama_tpu_torch.annotation.interactive import annotate

    data, _ = synth_record(np.random.default_rng(3), total_len=3000)
    np.save(tmp_path / "1.npy", data)
    np.save(tmp_path / "2.npy", data)
    ann = annotate(str(tmp_path / "1.npy"))
    assert [np.load(f) is not None for f in ann.files] and len(ann.files) == 2

    def move_to(x_data):
        ax = ann.axes[0]
        px, py = ax.transData.transform((x_data, float(np.mean(data[1]))))
        ev = MouseEvent("motion_notify_event", ann.fig.canvas, px, py)
        ann.fig.canvas.callbacks.process("motion_notify_event", ev)

    def press(key):
        ev = KeyEvent("key_press_event", ann.fig.canvas, key)
        ann.fig.canvas.callbacks.process("key_press_event", ev)

    # mark one full beat: P on@100 .. T off@600, through the event pipeline
    for key, x in zip("123456", [100, 150, 250, 320, 450, 600]):
        move_to(x)
        press(key)
    assert ann.cursor_x == pytest.approx(600, abs=1)
    assert [p[0] for p in ann.points] == [100, 150, 250, 320, 450, 600]

    # undo removes the most recent mark (T off)
    press("u")
    assert ann.points[5] == []

    # re-mark and save -> schema-valid JSON next to the record
    move_to(600)
    press("6")
    press("s")
    bp = load_breakpoints(str(tmp_path / "1.json"))
    assert bp["P on"] == [100] and bp["T off"] == [600]

    # next file: autosaves (already saved), loads 2.npy blank
    press("n")
    assert ann.record_path.endswith("2.npy")
    assert all(not p for p in ann.points)
    # prev file: preloads the saved labels for editing
    press("p")
    assert ann.record_path.endswith("1.npy")
    assert ann.points[0] == [100]


@pytest.mark.parametrize("seed", [3, 5, 7, 11, 13])
def test_segmentation_equals_jax(seed):
    data, _ = synth_record(np.random.default_rng(seed), total_len=5000)
    np.testing.assert_array_equal(detect_r_peaks(data[1], fs=500.0), jax_detect_r_peaks(data[1], fs=500.0))
    assert auto_segment(data, fs=500.0, lead=1) == jax_auto_segment(data, fs=500.0, lead=1)


def test_segment_validate_show_need_no_matplotlib(tmp_path):
    data, _ = synth_record(np.random.default_rng(7), total_len=3000)
    rec = str(tmp_path / "rec.npy")
    np.save(rec, data)
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "from electrocardio_panorama_tpu_torch.annotation.cli import main\n"
            f"assert main(['segment', {rec!r}]) == 0\n"
            f"assert main(['validate', {rec[:-4] + '.json'!r}, '--record', {rec!r}]) == 0\n"
            f"assert main(['show', {rec[:-4] + '.json'!r}]) == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert "OK:" in proc.stdout
