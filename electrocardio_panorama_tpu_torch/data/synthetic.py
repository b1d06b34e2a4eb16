"""Synthetic ECG record generator in the Tianchi on-disk format.

The reference ships only two sample Tianchi records (codes/data/tianchi), so
this module generates arbitrarily many physiologically-shaped records —
8 leads x 5000 samples of P/QRS/T morphology with known breakpoints — writing
the exact npy + breakpoint-JSON layout the dataset reader consumes
(and the annotation tool emits, AnnotationTools/window.py:221-233).

Used as the pytest fixture backbone and as a runnable end-to-end training
corpus in environments without the real Tianchi download.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np


def _gauss(t: np.ndarray, center: float, width: float) -> np.ndarray:
    return np.exp(-0.5 * ((t - center) / width) ** 2)


def synth_beat(rng: np.random.Generator, length: int) -> tuple[np.ndarray, dict]:
    """One beat template [length] + breakpoint offsets within the beat."""
    t = np.arange(length, dtype=np.float64)
    # Segment layout scaled to the beat length.
    p_on = 0
    p_off = int(length * rng.uniform(0.12, 0.18))
    r_on = int(length * rng.uniform(0.22, 0.28))
    r_off = int(length * rng.uniform(0.34, 0.40))
    t_on = int(length * rng.uniform(0.48, 0.55))
    t_off = int(length * rng.uniform(0.68, 0.75))

    p_amp = rng.uniform(40, 90)
    r_amp = rng.uniform(350, 700)
    q_amp = rng.uniform(40, 120)
    s_amp = rng.uniform(60, 160)
    t_amp = rng.uniform(90, 220)

    p_c, p_w = (p_on + p_off) / 2, (p_off - p_on) / 4
    r_c = (r_on + r_off) / 2
    r_w = (r_off - r_on) / 8
    t_c, t_w = (t_on + t_off) / 2, (t_off - t_on) / 4

    beat = (
        p_amp * _gauss(t, p_c, p_w)
        + r_amp * _gauss(t, r_c, r_w)
        - q_amp * _gauss(t, r_c - 3 * r_w, r_w)
        - s_amp * _gauss(t, r_c + 3 * r_w, r_w)
        + t_amp * _gauss(t, t_c, t_w)
    )
    marks = {"P on": p_on, "P off": p_off, "R on": r_on, "R off": r_off, "T on": t_on, "T off": t_off}
    return beat, marks


def synth_record(rng: np.random.Generator, total_len: int = 5000) -> tuple[np.ndarray, dict]:
    """8-lead record [8, total_len] (int-valued, Tianchi-style) + breakpoint json."""
    breakpoints = {k: [] for k in ("P on", "P off", "R on", "R off", "T on", "T off")}
    signal = np.zeros(total_len)
    pos = int(rng.uniform(30, 120))
    while True:
        beat_len = int(rng.uniform(320, 480))
        if pos + beat_len + 8 >= total_len:
            break
        beat, marks = synth_beat(rng, beat_len)
        signal[pos: pos + beat_len] += beat
        for k, v in marks.items():
            breakpoints[k].append(int(pos + v))
        pos += beat_len

    # 8 leads: I, II independent-ish projections; V1..V6 mixtures.
    lead_gains = rng.uniform(0.4, 1.4, size=8)
    lead_gains[1] = rng.uniform(0.9, 1.4)  # II usually largest
    baseline = rng.uniform(-40, 40, size=(8, 1))
    wander = 20 * np.sin(np.linspace(0, rng.uniform(2, 6) * np.pi, total_len))
    noise = rng.normal(0, rng.uniform(2, 6), size=(8, total_len))
    leads = lead_gains[:, None] * signal[None, :] + baseline + wander[None, :] + noise
    return np.round(leads).astype(np.int64), breakpoints


def generate_tianchi_dataset(
    root: str, n_train: int = 16, n_test: int = 8, seed: int = 0, total_len: int = 5000
) -> dict:
    """Write a complete synthetic corpus in the reference's directory layout
    (config/default.py:16-19): npy_data/tianchi_train_round1/*.npy,
    tianchi_interval/*.json, tianchi_{train,test}_jsons.txt.

    Returns the DATA.* config overrides pointing at it.
    """
    rng = np.random.default_rng(seed)
    npy_dir = os.path.join(root, "npy_data", "tianchi_train_round1")
    json_dir = os.path.join(root, "tianchi_interval")
    os.makedirs(npy_dir, exist_ok=True)
    os.makedirs(json_dir, exist_ok=True)

    names = []
    for i in range(n_train + n_test):
        name = f"synth_{i:05d}"
        data, breakpoints = synth_record(rng, total_len)
        np.save(os.path.join(npy_dir, name + ".npy"), data)
        with open(os.path.join(json_dir, name + ".json"), "w") as f:
            json.dump(breakpoints, f)
        names.append(name + ".json")

    train_txt = os.path.join(root, "tianchi_train_jsons.txt")
    test_txt = os.path.join(root, "tianchi_test_jsons.txt")
    with open(train_txt, "w") as f:
        f.write("\n".join(names[:n_train]) + "\n")
    with open(test_txt, "w") as f:
        f.write("\n".join(names[n_train:]) + "\n")

    return {
        "train_label_path": train_txt,
        "test_label_path": test_txt,
        "train_data_root": npy_dir,
        "train_label_root": json_dir,
    }


def multi_hot(rng: np.random.Generator, num_classes: int, p: float = 0.05) -> np.ndarray:
    """A record's multi-hot labels [num_classes]: each class at probability
    `p`, and one class drawn uniformly where none came up."""
    y = (rng.random(num_classes) < p).astype(np.int64)
    if not y.any():
        y[int(rng.integers(num_classes))] = 1
    return y


def generate_tianchi_classification_dataset(root: str, n_records: int = 24, num_classes: int = 55, seed: int = 0,
                                            total_len: int = 5000, label_p: float = 0.05) -> dict:
    """Write a labelled corpus in the layout TianchiClassificationDataset
    reads (reference EcgTianChiDataset, tianchi.py:10-43): npy_data/tianchi_cls/
    synth_NNNNN.npy (`synth_record`'s 8 x total_len records) and labels.csv,
    whose columns are the file name, age, sex and `num_classes` 0/1 label
    columns (`multi_hot`). Returns the DATA.* config overrides pointing at it."""
    rng = np.random.default_rng(seed)
    npy_dir = os.path.join(root, "npy_data", "tianchi_cls")
    os.makedirs(npy_dir, exist_ok=True)
    csv_path = os.path.join(root, "labels.csv")
    rows = []
    for i in range(n_records):
        name = f"synth_{i:05d}.npy"
        data, _ = synth_record(rng, total_len)
        np.save(os.path.join(npy_dir, name), data)
        age, sex = int(rng.integers(18, 90)), ("FEMALE", "MALE")[int(rng.integers(2))]
        rows.append([name, age, sex, *multi_hot(rng, num_classes, label_p).tolist()])
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "age", "sex", *(f"label_{c:02d}" for c in range(num_classes))])
        w.writerows(rows)
    return {"train_label_path": csv_path, "train_data_root": npy_dir}


def generate_ptb_dataset(root: str, n_patients: int = 4, records_per_patient: int = 2, seed: int = 0) -> dict:
    """Synthetic PTB-layout corpus: per-patient dirs of 12-lead npy + json
    (ptbv2.py:179-188 walk). PTB raw lead order is [I,II,III,aVR,aVL,aVF,V1..V6]
    — the inverse of reorder_ptb_leads."""
    rng = np.random.default_rng(seed)
    patients = []
    for pi in range(n_patients):
        pname = f"patient_{pi:03d}"
        pdir = os.path.join(root, "data", pname)
        os.makedirs(pdir, exist_ok=True)
        for ri in range(records_per_patient):
            data8, breakpoints = synth_record(rng, total_len=3000)
            data12 = np.concatenate(
                [data8, rng.uniform(0.3, 1.0, (4, 1)) * data8[1:2]], axis=0
            ).astype(np.float64)
            # store in raw PTB order: [I,II,(III,aVR,aVL,aVF),V1..V6]
            raw = np.concatenate([data12[0:2], data12[8:12], data12[2:8]], axis=0)
            np.save(os.path.join(pdir, f"rec_{ri}.npy"), raw)
            with open(os.path.join(pdir, f"rec_{ri}.json"), "w") as f:
                json.dump(breakpoints, f)
        patients.append(pname)

    train_txt = os.path.join(root, "ptb_train.txt")
    test_txt = os.path.join(root, "ptb_test.txt")
    n_tr = max(1, n_patients - 1)
    with open(train_txt, "w") as f:
        f.write("\n".join(patients[:n_tr]) + "\n")
    with open(test_txt, "w") as f:
        f.write("\n".join(patients[n_tr:]) + "\n")
    return {
        "train_label_path": train_txt,
        "test_label_path": test_txt,
        "train_data_root": os.path.join(root, "data"),
        "train_pkl_path": os.path.join(root, "train_beats.pkl"),
        "test_pkl_path": os.path.join(root, "test_beats.pkl"),
    }
