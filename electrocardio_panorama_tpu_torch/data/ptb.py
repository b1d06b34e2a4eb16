"""PTB pre-segmented heartbeat dataset (reference PTBV2 + HeartBeatList,
codes/dataset/ptbv2.py).

Beats are cached as a pickled list of (data, rois) pairs built by walking
patient directories (ptbv2.py:170-214). Raw PTB lead order is reordered to
[I, II, V1..V6, III, aVR, aVL, aVF] via concat(leads[0:2], leads[6:], leads[2:6])
(ptbv2.py:42); everything downstream is the shared beat assembly.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from electrocardio_panorama_tpu_torch.data.beats import assemble_meta, prep_beat_numpy
from electrocardio_panorama_tpu_torch.data.cache import LockedLRU


def reorder_ptb_leads(source: np.ndarray) -> np.ndarray:
    """Raw PTB [12, T] -> canonical order (ptbv2.py:42)."""
    return np.concatenate([source[0:2], source[6:], source[2:6]], axis=0)


def index_heartbeats(txt_path: str, data_root: str) -> list[tuple[np.ndarray, np.ndarray]]:
    """Walk patient dirs, split each annotated record into beats
    (ptbv2.py:179-202). Returns [(data [12,T], rois [7,2]), ...]."""
    from electrocardio_panorama_tpu_torch.data.beats import beat_rois

    beats = []
    with open(txt_path) as f:
        patients = [ln for ln in f.read().splitlines() if ln.strip()]
    for patient in patients:
        pdir = os.path.join(data_root, patient)
        if not os.path.isdir(pdir):
            continue
        for fname in sorted(x for x in os.listdir(pdir) if x.endswith(".json")):
            data = np.load(os.path.join(pdir, fname.replace(".json", ".npy"))).astype(np.float64)
            with open(os.path.join(pdir, fname)) as f:
                label = json.loads(f.read())
            for bi in range(len(label["P on"]) - 1):
                rois, p_on, end = beat_rois(label, bi, data.shape[-1])
                beats.append((data[:, p_on:end], rois))
    return beats


class PTBBeatDataset:
    def __init__(self, cfg, phase: str):
        self.cfg = cfg
        self.phase = phase
        pkl_path = cfg.DATA.train_pkl_path if phase == "train" else cfg.DATA.test_pkl_path
        label_path = cfg.DATA.train_label_path if phase == "train" else cfg.DATA.test_label_path
        if os.path.exists(pkl_path):
            with open(pkl_path, "rb") as f:
                self.beats = pickle.load(f)
        else:
            self.beats = index_heartbeats(label_path, cfg.DATA.train_data_root)
            os.makedirs(os.path.dirname(pkl_path) or ".", exist_ok=True)
            with open(pkl_path, "wb") as f:
                pickle.dump(self.beats, f, pickle.HIGHEST_PROTOCOL)
        # prepped-beat LRU, same rationale and knob as TianchiBeatDataset:
        # reorder/normalize/sigma/pad is a pure function of the beat index
        # (shared thread-safe implementation: data/cache.py)
        self._beat_cache = LockedLRU(int(getattr(cfg.DATA, "beat_cache", 8192)))

    def __len__(self) -> int:
        return len(self.beats)

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        rng = rng or np.random.default_rng()
        hit = self._beat_cache.get(index)
        if hit is None:
            entry = self.beats[index]
            data, rois = (entry.data, entry.rois_list) if hasattr(entry, "data") else entry
            rois = np.asarray(rois)
            data12 = reorder_ptb_leads(np.asarray(data))
            hit = self._beat_cache.put(index, (*prep_beat_numpy(data12, rois), rois))
        full12, sigma, beat_len, rois = hit
        return assemble_meta(
            full12, sigma, beat_len, rois, cfg=self.cfg, phase=self.phase,
            rng=rng, record_id=f"ptb_{index}",
        )
