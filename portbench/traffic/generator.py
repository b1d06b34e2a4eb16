"""The one traffic generator: synthetic Tianchi-format ECG records and the
batches a cell's program takes, made from `--seed`.

A frozen rewrite of the program's data/synthetic.py (synth_beat,
synth_record: 8 leads x 5000 samples of P/QRS/T morphology with known
breakpoints), data/beats.py and data/leads.py (the beat's seven ROIs, the
four augmented leads, the joint min-max normalization, the noise sigma, the
viewpoint jitter and the lead partition of the configuration) and of
BeatLoader's per-example random streams, so that a pool equals the batches
the program's own loader assembles from the same records
(tests/test_portbench_traffic.py holds it to that).

A mix (traffic/<name>.json) gives:
  batch         beats per batch (a train step's batch, a render request's beats)
  pool          batches in the pool; the window cycles through them
  phase         "train" (viewpoint jitter, as the trainer draws it) or "test"
  record_len    samples per synthetic record
  n_theta, n_phi  (render mixes) the viewpoint grid of every request
Every row of a pool is a beat of its own record, so no two rows are alike.
"""

from __future__ import annotations

import json
import os

import numpy as np

SEQ_LEN = 512
BREAKPOINTS = ("P on", "P off", "R on", "R off", "T on", "T off")

# per-lead viewpoint (theta, phi), order [I, II, V1..V6, III, aVR, aVL, aVF]
LEAD_THETA = np.array([
    [np.pi / 2, np.pi / 2], [np.pi * 5 / 6, np.pi / 2], [np.pi / 2, -np.pi / 18], [np.pi / 2, np.pi / 18],
    [np.pi * (19 / 36), np.pi / 12], [np.pi * (11 / 20), np.pi / 6], [np.pi * (16 / 30), np.pi / 3],
    [np.pi * (16 / 30), np.pi / 2], [np.pi * (5 / 6), -np.pi / 2], [np.pi * (1 / 3), -np.pi / 2],
    [np.pi * (1 / 3), np.pi / 2], [np.pi * 1, np.pi / 2],
])

# (lead_num, super_mode, train_data_mode) -> (input leads, leads left out of
# supervision); the rest supervise
LEAD_PARTITIONS = {(3, "IIv2v5_v4I_372", "input_fix"): ([1, 3, 6], [5, 0])}

_STACK = ("data", "rois", "input_theta", "target_view", "target_theta", "ori_data", "rest_view",
          "rest_theta", "noise")


def load_mix(root: str, name: str) -> dict:
    with open(os.path.join(root, "portbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _gauss(t, center, width):
    return np.exp(-0.5 * ((t - center) / width) ** 2)


def synth_beat(rng: np.random.Generator, length: int):
    """One beat template [length] and its breakpoints within the beat."""
    t = np.arange(length, dtype=np.float64)
    p_on = 0
    p_off = int(length * rng.uniform(0.12, 0.18))
    r_on = int(length * rng.uniform(0.22, 0.28))
    r_off = int(length * rng.uniform(0.34, 0.40))
    t_on = int(length * rng.uniform(0.48, 0.55))
    t_off = int(length * rng.uniform(0.68, 0.75))
    p_amp, r_amp = rng.uniform(40, 90), rng.uniform(350, 700)
    q_amp, s_amp, t_amp = rng.uniform(40, 120), rng.uniform(60, 160), rng.uniform(90, 220)
    p_c, p_w = (p_on + p_off) / 2, (p_off - p_on) / 4
    r_c, r_w = (r_on + r_off) / 2, (r_off - r_on) / 8
    t_c, t_w = (t_on + t_off) / 2, (t_off - t_on) / 4
    beat = (p_amp * _gauss(t, p_c, p_w) + r_amp * _gauss(t, r_c, r_w) - q_amp * _gauss(t, r_c - 3 * r_w, r_w)
            - s_amp * _gauss(t, r_c + 3 * r_w, r_w) + t_amp * _gauss(t, t_c, t_w))
    return beat, dict(zip(BREAKPOINTS, (p_on, p_off, r_on, r_off, t_on, t_off)))


def synth_record(rng: np.random.Generator, total_len: int = 5000):
    """An 8-lead record [8, total_len] (integer-valued) and its breakpoints."""
    marks = {k: [] for k in BREAKPOINTS}
    signal = np.zeros(total_len)
    pos = int(rng.uniform(30, 120))
    while True:
        beat_len = int(rng.uniform(320, 480))
        if pos + beat_len + 8 >= total_len:
            break
        beat, m = synth_beat(rng, beat_len)
        signal[pos:pos + beat_len] += beat
        for k, v in m.items():
            marks[k].append(int(pos + v))
        pos += beat_len
    gains = rng.uniform(0.4, 1.4, size=8)
    gains[1] = rng.uniform(0.9, 1.4)
    baseline = rng.uniform(-40, 40, size=(8, 1))
    wander = 20 * np.sin(np.linspace(0, rng.uniform(2, 6) * np.pi, total_len))
    noise = rng.normal(0, rng.uniform(2, 6), size=(8, total_len))
    leads = gains[:, None] * signal[None, :] + baseline + wander[None, :] + noise
    return np.round(leads).astype(np.int64), marks


def records(seed: int, n: int, total_len: int):
    """n records from one stream seeded by `seed`, as the program's corpus
    generator draws them."""
    rng = np.random.default_rng(seed)
    return [synth_record(rng, total_len) for _ in range(n)]


def prep_beat(data8: np.ndarray, marks: dict, beat_index: int):
    """(12 leads [12, 512] float32 normalized and padded, noise sigma [12],
    beat length, rois [7, 2] from the beat's start)."""
    p = [marks[k][beat_index] for k in BREAKPOINTS]
    n = len(marks["P on"])
    end = marks["P on"][beat_index + 1] if beat_index + 1 < n else data8.shape[-1]
    rois = np.array([[p[0], p[1]], [p[1], p[2]], [p[2], p[3]], [p[3], p[4]], [p[4], p[5]], [p[5], end],
                     [end, SEQ_LEN + p[0]]]) - p[0]
    data = data8.astype(np.float64)
    I, II = data[0:1], data[1:2]
    data12 = np.concatenate([data, II - I, -0.5 * (I + II), I - 0.5 * II, II - 0.5 * I], axis=0)
    beat = data12[:, p[0]:end]
    norm = (beat - beat.min()) / (beat.max() - beat.min())
    lo = (rois[5][0] + rois[5][1]) // 2
    sigma = np.std(norm[:, lo:rois[5][1]], axis=1).astype(np.float32)
    full = np.zeros((12, SEQ_LEN), np.float32)
    m = min(norm.shape[-1], SEQ_LEN)
    full[:, :m] = norm[:, :m]
    return full, sigma, int(beat.shape[-1]), rois


def example(record, data_cfg: dict, phase: str, rng: np.random.Generator) -> dict:
    """One example: a random beat of the record, its views and target, with
    the draws in the program's order (beat, jitter, target, noise)."""
    data8, marks = record
    beat_index = int(rng.integers(0, len(marks["P on"]) - 1))
    full, sigma, beat_len, rois = prep_beat(data8, marks, beat_index)
    theta = LEAD_THETA
    if data_cfg["jitter_factor"] > 0 and phase == "train":
        theta = theta + rng.normal(scale=data_cfg["jitter_factor"] / 180 * np.pi, size=theta.shape)
    select, unsup = LEAD_PARTITIONS[(data_cfg["lead_num"], data_cfg["super_mode"], data_cfg["train_data_mode"])]
    rest = [x for x in range(12) if x not in select + unsup]
    target = rest[int(rng.integers(len(rest)))]
    rest = rest + unsup
    noise = np.zeros(SEQ_LEN, np.float32)
    nb = min(beat_len, SEQ_LEN)
    noise[:nb] = rng.normal(0.0, float(sigma[target]), size=nb)
    theta32 = theta.astype(np.float32)
    return {"data": full[select], "rois": np.asarray(rois, np.int64), "input_theta": theta32[select],
            "target_view": full[target], "target_theta": theta32[target], "ori_data": full,
            "rest_view": full[rest], "rest_theta": theta32[rest], "noise": noise}


def example_rng(seed: int, epoch: int, position: int) -> np.random.Generator:
    """The per-example stream of the program's BeatLoader."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, position]))


def pool_records(mix: dict, seed: int) -> list:
    """The pool's records, one per row."""
    return records(int(np.random.SeedSequence([seed, 0x7EC0]).generate_state(1)[0]),
                   mix["batch"] * mix["pool"], mix["record_len"])


def pool(mix: dict, data_cfg: dict, seed: int) -> list[dict]:
    """The cell's pool: mix['pool'] batches of mix['batch'] beats (numpy
    arrays under the program's batch keys), position i drawn from record i
    by the stream example_rng(seed, 0, i)."""
    n = mix["batch"] * mix["pool"]
    recs = pool_records(mix, seed)
    exs = [example(recs[i], data_cfg, mix["phase"], example_rng(seed, 0, i)) for i in range(n)]
    return [{k: np.stack([e[k] for e in exs[b:b + mix["batch"]]]) for k in _STACK}
            for b in range(0, n, mix["batch"])]


def view_grid(n_theta: int, n_phi: int) -> np.ndarray:
    """The dense viewpoint grid [n_theta * n_phi, 2] float32: theta from
    pi/24 to 23pi/24, phi over a full turn from -pi (the program's
    synthesis.theta_grid)."""
    if n_theta == 7:
        thetas = np.array([np.pi / 24] + [np.pi * k / 6 for k in range(1, 6)] + [np.pi * 23 / 24])
    else:
        thetas = np.linspace(np.pi / 24, np.pi * 23 / 24, n_theta)
    phis = -np.pi + np.arange(n_phi) * (np.pi / 6 if n_phi == 12 else 2 * np.pi / n_phi)
    return np.stack(np.meshgrid(thetas, phis, indexing="ij"), axis=-1).reshape(-1, 2).astype(np.float32)
