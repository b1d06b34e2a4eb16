"""Interactive breakpoint marker — matplotlib-event equivalent of the
reference's PyQt5 annotation GUI (AnnotationTools/window.py).

Behavioral parity:
  * plots leads II / V2 / V4 of a record stacked vertically with a shared
    crosshair that follows the mouse (window.py:50-91,193-208);
  * keys 1-6 append the cursor's x position to the matching breakpoint list —
    P on / P off / R on / R off / T on / T off (window.py:93-95,235-259);
  * save writes `{record}.json` in the six-key schema (window.py:221-233);
  * next/prev walk the record's directory in numeric filename order and
    auto-save the current annotation first (window.py:135-161);
  * clear resets the in-progress annotation (window.py:179-183).

Additions over the reference: `u` undoes the most recent mark, existing JSON
labels are preloaded for editing, and marks render as color-coded vlines live.
Keys: 1-6 mark, u undo, s save, c clear, n next file, p previous file.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from electrocardio_panorama_tpu_torch.annotation.schema import (
    BREAKPOINT_KEYS,
    read_ecg_txt,
    validate_breakpoints,
)

_COLORS = {0: "g", 1: "g", 2: "r", 3: "r", 4: "b", 5: "b"}
_HELP = "1-6: mark P on/off, R on/off, T on/off   u: undo   s: save   c: clear   n/p: next/prev"


def _numeric_key(name: str):
    """Directory ordering by leading numeric prefix (window.py:120-124),
    falling back to lexicographic for non-numeric names."""
    m = re.match(r"(\d+)", os.path.basename(name))
    return (0, int(m.group(1))) if m else (1, name)


def _load_record(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.asarray(np.load(path))
    return read_ecg_txt(path)


class InteractiveAnnotator:
    """Drive with .run() on a display, or feed events headlessly in tests via
    fig.canvas key/motion events (backend Agg)."""

    def __init__(self, record_path: str, *, leads=(1, 3, 5),
                 lead_names=("II", "V2", "V4"), preload: bool = True):
        import matplotlib.pyplot as plt

        self._plt = plt
        self.leads = tuple(leads)
        self.lead_names = tuple(lead_names)
        self.preload = preload
        self.cursor_x: float = -1.0
        self._undo: list[int] = []  # stack of breakpoint-class indices
        self.points: list[list[int]] = [[] for _ in range(6)]
        self._mark_artists: list[list] = [[] for _ in range(6)]

        self.files: list[str] = []
        self.file_index = -1
        self._scan_dir(record_path)

        self.fig, self.axes = plt.subplots(
            len(self.leads), 1, figsize=(16, 2.6 * len(self.leads)),
            sharex=True, squeeze=False,
        )
        self.axes = [row[0] for row in self.axes]
        self._crosshairs = [ax.axvline(0, color="0.5", lw=0.8) for ax in self.axes]
        self.status = self.fig.text(0.01, 0.005, "", fontsize=8, family="monospace")
        self.fig.canvas.mpl_connect("motion_notify_event", self.on_motion)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self._load(self.files[self.file_index])

    # ------------------------------------------------------------ file walk
    def _scan_dir(self, record_path: str) -> None:
        d = os.path.dirname(os.path.abspath(record_path))
        names = sorted(
            (n for n in os.listdir(d) if n.endswith((".txt", ".npy"))),
            key=_numeric_key,
        )
        self.files = [os.path.join(d, n) for n in names]
        self.file_index = self.files.index(os.path.abspath(record_path))

    def _label_path(self) -> str:
        return os.path.splitext(self.record_path)[0] + ".json"

    def _load(self, path: str) -> None:
        self.record_path = os.path.abspath(path)
        self.record = _load_record(path)
        self.points = [[] for _ in range(6)]
        self._undo = []
        # a stale cursor from the previous record must not silently place
        # marks in the new one; -1 makes mark() a no-op until the mouse moves
        self.cursor_x = -1.0
        if self.preload and os.path.exists(self._label_path()):
            with open(self._label_path()) as f:
                bp = json.load(f)
            for k, key in enumerate(BREAKPOINT_KEYS):
                self.points[k] = [int(x) for x in bp.get(key, [])]
        self._redraw()

    # -------------------------------------------------------------- drawing
    def _redraw(self) -> None:
        for k, ax in enumerate(self.axes):
            ax.clear()
            ax.plot(self.record[self.leads[k]], lw=0.7, color="k")
            ax.set_ylabel(self.lead_names[k])
            ax.set_xlim(0, self.record.shape[-1])
        self._crosshairs = [ax.axvline(0, color="0.5", lw=0.8) for ax in self.axes]
        self._mark_artists = [[] for _ in range(6)]
        for k in range(6):
            for x in self.points[k]:
                self._draw_mark(k, x)
        self.axes[0].set_title(os.path.basename(self.record_path), fontsize=10)
        self._update_status()
        self.fig.canvas.draw_idle()

    def _draw_mark(self, k: int, x: int) -> None:
        arts = [ax.axvline(x, color=_COLORS[k], alpha=0.6, lw=1.0) for ax in self.axes]
        self._mark_artists[k].append(arts)

    def _update_status(self) -> None:
        counts = " ".join(
            f"{key}:{len(self.points[k])}" for k, key in enumerate(BREAKPOINT_KEYS)
        )
        self.status.set_text(f"{_HELP}\n{counts}")

    # --------------------------------------------------------------- events
    def on_motion(self, event) -> None:
        if event.inaxes is None or event.xdata is None:
            return
        self.cursor_x = float(event.xdata)
        for line in self._crosshairs:
            line.set_xdata([self.cursor_x, self.cursor_x])
        self.fig.canvas.draw_idle()

    def on_key(self, event) -> None:
        key = event.key
        if key is None:  # unmapped key (media/IME/dead keys): ignore
            return
        if key in "123456":
            self.mark(int(key) - 1)
        elif key == "u":
            self.undo()
        elif key == "s":
            self.save()
        elif key == "c":
            self.clear()
        elif key == "n":
            self.step_file(+1)
        elif key == "p":
            self.step_file(-1)

    # -------------------------------------------------------------- actions
    def mark(self, k: int) -> None:
        if self.cursor_x < 0 or self.cursor_x >= self.record.shape[-1]:
            return
        x = int(self.cursor_x)
        self.points[k].append(x)
        self._undo.append(k)
        self._draw_mark(k, x)
        self._update_status()
        self.fig.canvas.draw_idle()

    def undo(self) -> None:
        if not self._undo:
            return
        k = self._undo.pop()
        self.points[k].pop()
        for art in self._mark_artists[k].pop():
            art.remove()
        self._update_status()
        self.fig.canvas.draw_idle()

    def clear(self) -> None:
        self.points = [[] for _ in range(6)]
        self._undo = []
        self._redraw()

    def save(self) -> str:
        """Write the six-key JSON next to the record (window.py:221-233).
        Saves exactly what was marked — like the reference — but warns when
        the result violates the datasets' ordering invariants."""
        bp = {key: sorted(self.points[k]) for k, key in enumerate(BREAKPOINT_KEYS)}
        try:
            validate_breakpoints(bp)
        except ValueError as e:
            print(f"warning: annotation does not validate ({e}); saved anyway")
        path = self._label_path()
        with open(path, "w") as f:
            json.dump(bp, f)
        print(f"saved {sum(len(v) for v in bp.values())} breakpoints -> {path}")
        return path

    def step_file(self, delta: int) -> None:
        """Auto-save then move to the neighboring record (window.py:135-161).

        Auto-save is skipped when it would clobber annotations the user never
        saw: with --no-preload an existing label JSON stays hidden, so
        overwriting it with this session's partial marks would destroy work —
        an explicit 's' is required to overwrite in that case."""
        if any(self.points[k] for k in range(6)):
            if self.preload or not os.path.exists(self._label_path()):
                self.save()
            else:
                print(
                    f"not auto-saving over existing {self._label_path()} "
                    "(opened with --no-preload); press 's' to overwrite"
                )
        nxt = self.file_index + delta
        if 0 <= nxt < len(self.files):
            self.file_index = nxt
            self._load(self.files[nxt])

    def run(self) -> None:
        self._plt.show()


def annotate(record_path: str, leads=(1, 3, 5), lead_names=("II", "V2", "V4"),
             preload: bool = True) -> InteractiveAnnotator:
    return InteractiveAnnotator(
        record_path, leads=leads, lead_names=lead_names, preload=preload
    )
