"""Annotation CLI: headless replacement for the reference's PyQt5 tool.

    python -m electrocardio_panorama_tpu_torch.annotation.cli segment REC.npy|REC.txt
        -> writes REC.json (six-key breakpoint schema) via auto-segmentation
    python -m electrocardio_panorama_tpu_torch.annotation.cli validate LABEL.json [--record REC.npy]
        -> schema + ordering validation
    python -m electrocardio_panorama_tpu_torch.annotation.cli show LABEL.json
        -> per-beat segment table
    python -m electrocardio_panorama_tpu_torch.annotation.cli plot REC.npy|REC.txt [--label LABEL.json] [--out PNG]
        -> leads II/V2/V4 with breakpoint overlays (the GUI's plot view,
           window.py:163-176, as a static image)

    python -m electrocardio_panorama_tpu_torch.annotation.cli annotate REC.npy|REC.txt
        -> INTERACTIVE marker (requires a display): crosshair follows the
           mouse over leads II/V2/V4; keys 1-6 append the cursor x to the six
           breakpoint lists, u undoes, s saves {record}.json, n/p walk the
           directory — the reference GUI's live labeling loop
           (AnnotationTools/window.py:93-104,221-259) without Qt.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from electrocardio_panorama_tpu_torch.annotation import (
    BREAKPOINT_KEYS,
    auto_segment,
    beats_in,
    load_breakpoints,
    read_ecg_txt,
    save_breakpoints,
    validate_breakpoints,
)


def _load_record(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    return read_ecg_txt(path)


def main(argv=None):
    parser = argparse.ArgumentParser(description="ECG breakpoint annotation")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_seg = sub.add_parser("segment", help="auto-segment a record -> JSON")
    p_seg.add_argument("record")
    p_seg.add_argument("--out", default=None)
    p_seg.add_argument("--fs", type=float, default=500.0)
    p_seg.add_argument("--lead", type=int, default=1, help="lead index for R detection (default II)")

    p_val = sub.add_parser("validate", help="validate a breakpoint JSON")
    p_val.add_argument("label")
    p_val.add_argument("--record", default=None)

    p_show = sub.add_parser("show", help="print per-beat segments")
    p_show.add_argument("label")

    p_ann = sub.add_parser("annotate", help="interactive breakpoint marker (needs a display)")
    p_ann.add_argument("record")
    p_ann.add_argument("--leads", default="1,3,5", help="comma-separated lead indices (default II,V2,V4)")
    p_ann.add_argument("--no-preload", action="store_true", help="start blank even if {record}.json exists")

    p_plot = sub.add_parser("plot", help="plot record leads with breakpoint overlays")
    p_plot.add_argument("record")
    p_plot.add_argument("--label", default=None, help="breakpoint JSON (default: record path with .json)")
    p_plot.add_argument("--out", default=None, help="output PNG (default: record path with _annotated.png)")
    p_plot.add_argument("--leads", default="1,3,5", help="comma-separated lead indices (default II,V2,V4)")

    args = parser.parse_args(argv)

    if args.cmd == "segment":
        rec = _load_record(args.record)
        bp = auto_segment(rec, fs=args.fs, lead=args.lead)
        out = args.out or os.path.splitext(args.record)[0] + ".json"
        save_breakpoints(bp, out)
        print(f"{args.record}: {len(bp['P on'])} beats ({beats_in(bp)} usable) -> {out}")
        return 0

    if args.cmd == "validate":
        try:
            bp = load_breakpoints(args.label)
            if args.record:
                rec = _load_record(args.record)
                validate_breakpoints(bp, record_len=rec.shape[-1])
        except ValueError as e:
            print(f"INVALID: {e}")
            return 1
        print(f"OK: {len(bp['P on'])} beats, schema valid")
        return 0

    if args.cmd == "plot":
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        rec = _load_record(args.record)
        label_path = args.label or os.path.splitext(args.record)[0] + ".json"
        if args.label and not os.path.exists(args.label):
            print(f"ERROR: --label {args.label} does not exist")
            return 1
        bp = load_breakpoints(label_path) if os.path.exists(label_path) else None
        leads = [int(x) for x in args.leads.split(",")]
        fig, axes = plt.subplots(len(leads), 1, figsize=(16, 2.2 * len(leads)),
                                 sharex=True, squeeze=False)
        colors = {"P on": "g", "P off": "g", "R on": "r", "R off": "r",
                  "T on": "b", "T off": "b"}
        for row, li in enumerate(leads):
            ax = axes[row][0]
            ax.plot(rec[li], linewidth=0.7, color="k")
            ax.set_ylabel(f"lead {li}")
            if bp is not None:
                for key, xs in bp.items():
                    for x in xs:
                        ax.axvline(x, color=colors.get(key, "gray"), alpha=0.4,
                                   linewidth=0.7)
        out = args.out or os.path.splitext(args.record)[0] + "_annotated.png"
        fig.tight_layout()
        fig.savefig(out, dpi=110)
        plt.close(fig)
        n = len(bp["P on"]) if bp else 0
        print(f"{args.record}: {n} beats overlaid -> {out}")
        return 0

    if args.cmd == "annotate":
        from electrocardio_panorama_tpu_torch.annotation.interactive import annotate

        leads = tuple(int(x) for x in args.leads.split(","))
        names = tuple(f"lead {i}" for i in leads) if leads != (1, 3, 5) else ("II", "V2", "V4")
        ann = annotate(args.record, leads=leads, lead_names=names,
                       preload=not args.no_preload)
        ann.run()
        return 0

    if args.cmd == "show":
        bp = load_breakpoints(args.label)
        print("beat  " + "  ".join(f"{k:>6}" for k in BREAKPOINT_KEYS))
        for i in range(len(bp["P on"])):
            print(f"{i:4d}  " + "  ".join(f"{bp[k][i]:6d}" for k in BREAKPOINT_KEYS))
        return 0


if __name__ == "__main__":
    sys.exit(main())
