"""Lead geometry and the few-view lead-partition matrix.

* LEAD_THETA: per-lead viewpoint (theta, phi) in spherical coordinates —
  12 rows, order [I, II, V1..V6, III, aVR, aVL, aVF]
  (reference codes/dataset/tianchi.py:55-67; identical copy ptbv2.py:19-31).
* derive_augmented_leads: III/aVR/aVL/aVF from I, II (tianchi.py:88-93).
* lead_partition: the (lead_num, super_mode, train_data_mode) if-ladder
  (tianchi.py:123-191, duplicated at ptbv2.py:58-126) expressed as one table +
  a few rules. Returns (select, supervision, unsupervision) index lists.
"""

from __future__ import annotations

import numpy as np

LEAD_NAMES = ["I", "II", "V1", "V2", "V3", "V4", "V5", "V6", "III", "aVR", "aVL", "aVF"]

LEAD_THETA = np.array(
    [
        [np.pi / 2, np.pi / 2],          # I
        [np.pi * 5 / 6, np.pi / 2],      # II
        [np.pi / 2, -np.pi / 18],        # V1
        [np.pi / 2, np.pi / 18],         # V2
        [np.pi * (19 / 36), np.pi / 12], # V3
        [np.pi * (11 / 20), np.pi / 6],  # V4
        [np.pi * (16 / 30), np.pi / 3],  # V5
        [np.pi * (16 / 30), np.pi / 2],  # V6
        [np.pi * (5 / 6), -np.pi / 2],   # III
        [np.pi * (1 / 3), -np.pi / 2],   # aVR
        [np.pi * (1 / 3), np.pi / 2],    # aVL
        [np.pi * 1, np.pi / 2],          # aVF
    ]
)

# The 3-lead random mode samples inputs from these pools (tianchi.py:123,135-136).
# Naming follows the reference verbatim ("lamb" = limb).
SUPERVISION_LEAD_LAMB = [2, 4, 6, 7]
SUPERVISION_LEAD_CHEST = [0, 1, 8, 9]


def derive_augmented_leads(data8: np.ndarray) -> np.ndarray:
    """[8, T] (I, II, V1..V6) -> [12, T] adding III, aVR, aVL, aVF.

    III = II - I; aVR = -0.5(I + II); aVL = I - 0.5 II; aVF = II - 0.5 I
    (tianchi.py:88-93).
    """
    I, II = data8[0:1], data8[1:2]
    III = II - I
    aVR = -0.5 * (I + II)
    aVL = I - 0.5 * II
    aVF = II - 0.5 * I
    return np.concatenate([data8, III, aVR, aVL, aVF], axis=0)


# (lead_num, super_mode) -> (select, unsupervision) with supervision defaulting
# to "all leads not in select+unsupervision". None marks a computed field.
_FIXED_MODES = {
    (3, "IIv2v5_v4I_372"): ([1, 3, 6], [5, 0]),
    (12, "_12120"): (list(range(12)), []),
    (8, "_8120"): (list(range(8)), []),
    (4, "_480"): ([2, 6, 0, 8], []),
    (4, "_462"): ([2, 6, 0, 8], [4, 11]),
    (5, "_552"): ([2, 6, 0, 8, 10], [4, 11]),
    (5, "_561"): ([2, 6, 0, 8, 10], [4]),
    (5, "_570"): ([2, 6, 0, 8, 10], []),
    (2, "_228"): ([1, 6], None),       # supervision fixed, unsup = complement
    (2, "_2100"): ([1, 6], []),
    (1, "_1110"): ([1], []),
    (1, "_1101"): ([1], [4]),
    (1, "_192"): ([1], [4, 11]),
}

# Modes where rest == supervision rather than supervision - select
# (tianchi.py:191).
REST_EQUALS_SUPERVISION = ("_12120", "_3120", "_8120")


def lead_partition(lead_num: int, super_mode: str, train_data_mode: str, rng=None):
    """Returns (select_index, supervision_lead, unsupervision_lead).

    `rng` (numpy Generator) is only consulted for the 3-lead random mode.
    Raises KeyError for an unknown lead_num, like the reference
    (tianchi.py:190 — typo'd message preserved in spirit, not in string).
    """
    all12 = list(range(12))

    if lead_num == 3 and not (train_data_mode == "input_fix" and super_mode == "IIv2v5_v4I_372"):
        # random-input 3-lead mode (tianchi.py:128,134-136)
        n_lamb = int(rng.integers(1, 3))  # random.randint(1, 2) inclusive
        select = list(rng.choice(SUPERVISION_LEAD_LAMB, size=n_lamb, replace=False)) + list(
            rng.choice(SUPERVISION_LEAD_CHEST, size=3 - n_lamb, replace=False)
        )
        select = [int(i) for i in select]
        supervision = SUPERVISION_LEAD_LAMB + SUPERVISION_LEAD_CHEST
        unsup = [x for x in all12 if x not in supervision]
        return select, supervision, unsup

    if lead_num == 9:
        supervision = [0, 1, 3]
        select = [x for x in all12 if x not in supervision]
        return select, supervision, []

    if lead_num == 12 and super_mode == "_12120":
        return all12, list(all12), []

    key = (lead_num, super_mode)
    if key not in _FIXED_MODES:
        raise KeyError(f"WRONG lead num / super_mode: {lead_num} {super_mode}")
    select, unsup = _FIXED_MODES[key]

    if key == (2, "_228"):
        supervision = [1, 6, 9, 3]
        unsup = [x for x in all12 if x not in supervision]
        return list(select), supervision, unsup

    supervision = [x for x in all12 if x not in select + unsup]
    if key in ((12, "_12120"), (8, "_8120")):
        supervision = list(all12)
    return list(select), supervision, list(unsup)


def partition_sizes(lead_num: int, super_mode: str, train_data_mode: str):
    """Static (n_input, n_rest_total) for shape planning — rest includes the
    unsupervised leads appended at the end (tianchi.py:191-195)."""
    sel, sup, unsup = lead_partition(
        lead_num, super_mode, train_data_mode, rng=np.random.default_rng(0)
    )
    if super_mode in REST_EQUALS_SUPERVISION:
        rest = list(sup)
    else:
        rest = [x for x in sup if x not in sel]
    return len(sel), len(rest) + len(unsup)
