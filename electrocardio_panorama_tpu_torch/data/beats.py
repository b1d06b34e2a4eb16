"""Shared per-heartbeat example assembly.

The normalize / noise / jitter / lead-partition / pad-to-512 logic duplicated
across the reference's two datasets (tianchi.py:109-225 == ptbv2.py:44-157)
lives here once. Input: a 12-lead beat slice + its 7 contiguous ROIs; output:
the fixed-shape `meta` dict the solver consumes (tianchi.py:212-225).
"""

from __future__ import annotations

import numpy as np

from electrocardio_panorama_tpu_torch.data.leads import (
    LEAD_THETA,
    REST_EQUALS_SUPERVISION,
    lead_partition,
)

SEQ_LEN = 512
N_SEGMENTS = 7


def beat_rois(breakpoints: dict, beat_index: int, record_len: int) -> np.ndarray:
    """7 contiguous segments from the 6 breakpoint arrays, offset to beat start
    (tianchi.py:99-106): [P, P-R gap, QRS, R-T gap, T, T->next-P, tail-to-512].
    """
    p_on = breakpoints["P on"][beat_index]
    p_off = breakpoints["P off"][beat_index]
    r_on = breakpoints["R on"][beat_index]
    r_off = breakpoints["R off"][beat_index]
    t_on = breakpoints["T on"][beat_index]
    t_off = breakpoints["T off"][beat_index]
    n = len(breakpoints["P on"])
    end_point = breakpoints["P on"][beat_index + 1] if beat_index + 1 < n else record_len
    rois = np.array(
        [
            [p_on, p_off], [p_off, r_on], [r_on, r_off],
            [r_off, t_on], [t_on, t_off], [t_off, end_point],
            [end_point, SEQ_LEN + p_on],
        ]
    )
    return rois - p_on, p_on, end_point


def prep_beat_numpy(beat12: np.ndarray, rois: np.ndarray):
    """The rng-free prep stage, numpy path (the C++ twin is
    native/beatprep.cpp): joint min-max normalization across leads
    (tianchi.py:109-111), per-lead noise sigma from the 2nd half of the T->P
    segment (tianchi.py:113-116), pad to SEQ_LEN.

    beat12: [12, T] raw beat slice; rois: [7, 2] offset to beat start.
    Returns (full12 [12, SEQ_LEN] f32, sigma [12] f32, beat_len) — a pure
    function of its inputs, so datasets may cache the result per beat.
    """
    mx, mn = beat12.max(), beat12.min()
    norm = (beat12 - mn) / (mx - mn)
    lo = (rois[5][0] + rois[5][1]) // 2
    sigma = np.std(norm[:, lo: rois[5][1]], axis=1).astype(np.float32)
    return pad12_to_seq(norm), sigma, int(beat12.shape[-1])


def pad12_to_seq(data12: np.ndarray) -> np.ndarray:
    """[12, T] -> fresh zero-padded (or truncated) [12, SEQ_LEN] f32. The one
    padding implementation for both the cached prep path and assemble_meta's
    unpadded-input fallback — they must stay byte-identical (tianchi.py:199-211)."""
    full12 = np.zeros((12, SEQ_LEN), np.float32)
    n = min(data12.shape[-1], SEQ_LEN)
    full12[:, :n] = data12[:, :n]
    return full12


def build_meta(
    beat12: np.ndarray,
    rois: np.ndarray,
    *,
    cfg,
    phase: str,
    rng: np.random.Generator,
    record_id: str = "",
) -> dict:
    """beat12: [12, T] raw beat slice (T = beat length); rois: [7, 2] offset to 0."""
    full12, sigma, beat_len = prep_beat_numpy(beat12, rois)
    return assemble_meta(
        full12, sigma, beat_len, rois,
        cfg=cfg, phase=phase, rng=rng, record_id=record_id,
    )


def assemble_meta(
    data12: np.ndarray,
    noise_std: np.ndarray,
    beat_len: int,
    rois: np.ndarray,
    *,
    cfg,
    phase: str,
    rng: np.random.Generator,
    record_id: str = "",
) -> dict:
    """Second stage shared by the numpy and native (C++) preprocessing paths:
    data12 is already normalized (padded or unpadded); noise_std is the
    per-lead sigma; beat_len the true (unpadded) beat length.

    When data12 is already f32 and SEQ_LEN wide (the native prep output, or a
    dataset's prepped-beat cache entry) it is shared into the meta dict
    without a copy, and several meta values are row views of the same array —
    meta arrays are read-only until collate's np.stack copies them out
    (cache entries are frozen by data/cache.py, so in-place mutation raises).

    Draw order within the per-example rng stream is jitter -> lead partition
    -> target choice -> noise-of-target. The reference draws the full
    (beat_len, 12) noise matrix first and keeps one column
    (tianchi.py:113-116); sampling only the consumed column is
    distributionally identical and ~12x less normal generation — the
    per-(seed, epoch, position) determinism contract is unchanged.
    """
    # viewpoint-angle jitter, train only (tianchi.py:77-82,119-121)
    theta = LEAD_THETA
    if cfg.MODEL.jitter_factor > 0 and phase == "train":
        jitter = rng.normal(scale=cfg.MODEL.jitter_factor / 180 * np.pi, size=theta.shape)
        theta = theta + jitter

    select, supervision, unsup = lead_partition(
        cfg.DATA.lead_num, cfg.DATA.super_mode, cfg.DATA.train_data_mode, rng
    )
    if cfg.DATA.super_mode in REST_EQUALS_SUPERVISION:
        rest = list(supervision)
    else:
        rest = [x for x in supervision if x not in select]
    target_index = rest[int(rng.integers(len(rest)))]  # uniform; ~4x cheaper than rng.choice
    rest = rest + unsup  # unsupervised leads appended at the END (tianchi.py:194)

    # one padded f32 image of the full 12-lead beat; every view/target/ori key
    # below is a row slice of it (replaces five separate pad+astype passes)
    if data12.dtype == np.float32 and data12.shape[-1] == SEQ_LEN:
        full12 = data12
    else:
        full12 = pad12_to_seq(data12)

    # per-lead noise sigma Gaussian over the true beat length, target lead only
    noise = np.zeros(SEQ_LEN, np.float32)
    nb = min(int(beat_len), SEQ_LEN)
    noise[:nb] = rng.normal(0.0, float(noise_std[target_index]), size=nb)

    theta32 = theta.astype(np.float32)
    meta = {
        "data": full12[select],
        "rois": np.asarray(rois, np.int64),
        "input_theta": theta32[select],
        "target_view": full12[target_index],
        "target_theta": theta32[target_index],
        "id": record_id,
        "ori_data": full12,
        "rest_view": full12[rest],
        "rest_theta": theta32[rest],
        "noise": noise,
        "unsupervision_lead_name": list(unsup),
    }
    return meta
