"""Tianchi single-beat dataset (reference EcgTianChiInterval, tianchi.py:46-228).

Records are 8-lead, 5000-sample int `.npy` files plus breakpoint JSONs with
keys "P on"/"P off"/"R on"/"R off"/"T on"/"T off" (the annotation tool's output
schema, AnnotationTools/window.py:221-233). Each __getitem__ picks one random
heartbeat, derives the 4 augmented leads, builds the 7 contiguous ROIs, and
assembles the fixed-shape meta dict.

TPU-relevant differences from the reference:
  * randomness flows through a numpy Generator seeded per (epoch, index) so
    examples are reproducible and epoch-reshuffles are deterministic;
  * an offline beat index (record -> number of beats) is built once so the
    pipeline can also iterate *all* beats of a record (the dense-panorama
    multi-beat workload) instead of one random beat.
"""

from __future__ import annotations

import json
import os

import numpy as np

from electrocardio_panorama_tpu_torch.data.beats import (
    assemble_meta,
    beat_rois,
    prep_beat_numpy,
)
from electrocardio_panorama_tpu_torch.data.cache import LockedLRU
from electrocardio_panorama_tpu_torch.data.leads import derive_augmented_leads


class TianchiBeatDataset:
    def __init__(self, cfg, phase: str):
        self.cfg = cfg
        self.phase = phase
        label_path = (
            cfg.DATA.train_label_path if phase == "train" else cfg.DATA.test_label_path
        )
        with open(label_path) as f:
            self.records = [ln for ln in f.read().splitlines() if ln.strip()]
        self.data_root = cfg.DATA.train_data_root
        self.label_root = cfg.DATA.train_label_root
        self._label_cache: dict[str, dict] = {}
        # Bounded LRU of float64 record arrays (data/cache.py: thread-safe,
        # entries frozen read-only). The profiler showed np.load + header
        # parse + astype was ~45% of loader time (each __getitem__ loaded its
        # record twice: num_beats + get_beat); a (8, 5000) f64 record is
        # 320 KB, so the default 2048-record cache tops out ~650 MB.
        self._record_cache = LockedLRU(int(getattr(cfg.DATA, "record_cache", 2048)))
        # Prepped-beat LRU: the derive/normalize/sigma stage is a pure function
        # of (record, beat_index) — across a 150-epoch run the same beat is
        # re-prepped thousands of times while only the rng-driven assembly
        # (jitter/partition/target/noise) differs. One entry is a padded
        # [12, 512] f32 + sigma ≈ 25 KB, so the default 8192 tops out ~200 MB.
        self._beat_cache = LockedLRU(int(getattr(cfg.DATA, "beat_cache", 8192)))

    def __len__(self) -> int:
        return len(self.records)

    def _load(self, name: str):
        data = self._record_cache.get(name)
        if data is None:
            data = self._record_cache.put(name, np.load(
                os.path.join(self.data_root, name.replace(".json", ".npy"))
            ).astype(np.float64))
        if name not in self._label_cache:
            with open(os.path.join(self.label_root, name)) as f:
                label = json.loads(f.read())
            self._label_cache[name] = label
        return data, self._label_cache[name]

    def num_beats(self, index: int) -> int:
        _, label = self._load(self.records[index])
        return len(label["P on"]) - 1

    def get_beat(self, index: int, beat_index: int, rng: np.random.Generator) -> dict:
        name = self.records[index]
        key = (name, beat_index)
        hit = self._beat_cache.get(key)
        if hit is None:
            hit = self._beat_cache.put(key, self._prep_beat(name, beat_index))
        out12, sigma, beat_len, rois = hit
        return assemble_meta(
            out12, sigma, beat_len, rois,
            cfg=self.cfg, phase=self.phase, rng=rng, record_id=name,
        )

    def _prep_beat(self, name: str, beat_index: int):
        """The rng-free prep stage: (padded [12,512] f32, sigma [12], beat_len,
        rois [7,2]) for one beat. Cached — consumers must not mutate."""
        data8, label = self._load(name)
        rois, p_on, end_point = beat_rois(label, beat_index, data8.shape[-1])
        beat_len = int(end_point - p_on)
        if getattr(self.cfg.DATA, "use_native_prep", True):
            from electrocardio_panorama_tpu_torch.data import native

            prepped = native.prep_beat(
                data8, p_on, end_point,
                (rois[5][0] + rois[5][1]) // 2, rois[5][1],
            ) if native.available() else None
            if prepped is not None:
                out12, sigma = prepped
                return out12, sigma, beat_len, rois
        # numpy fallback: derive + slice + joint min-max + sigma (tianchi.py:88-116)
        data12 = derive_augmented_leads(data8)
        out12, sigma, _ = prep_beat_numpy(data12[:, p_on:end_point], rois)
        return out12, sigma, beat_len, rois

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        rng = rng or np.random.default_rng()
        n = self.num_beats(index)
        beat_index = int(rng.integers(0, n))  # random.sample(range(n), 1) parity
        return self.get_beat(index, beat_index, rng)


def split_80_20(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(train rows, test rows) of `n` rows: sklearn's
    `train_test_split(shuffle=True, test_size=0.2, random_state=seed)`, which
    the reference calls, written out (a RandomState permutation; the test
    rows are its first ceil(n / 5)), so no sklearn is needed. A seed of 2**32
    or more, which sklearn refuses, is taken modulo 2**32."""
    perm = np.random.RandomState(seed % 2**32).permutation(n)
    n_test = int(np.ceil(0.2 * n))
    return perm[n_test:], perm[:n_test]


# the twelve standard leads in ST-MEM's order, as rows of [I, II, V1..V6, III,
# aVR, aVL, aVF] (derive_augmented_leads)
TWELVE_LEADS = [0, 1, 8, 9, 10, 11, 2, 3, 4, 5, 6, 7]
DECIMATED = 4500  # samples of a 500 Hz record that the 2:1 decimation keeps: 9 s


def twelve_leads_250hz(data8: np.ndarray) -> np.ndarray:
    """A Tianchi record [8, 5000] (I, II, V1..V6 at 500 Hz) as ST-MEM takes
    it: [12, 2250] in the order I, II, III, aVR, aVL, aVF, V1..V6, the four
    limb leads derived by Einthoven's and Goldberger's definitions
    (derive_augmented_leads), every second sample of the first 9 s (250 Hz;
    no anti-alias filter), each lead standardized to mean 0 and standard
    deviation 1 (float64 throughout)."""
    x = derive_augmented_leads(np.asarray(data8, dtype=np.float64))[TWELVE_LEADS, :DECIMATED:2]
    return (x - x.mean(axis=1, keepdims=True)) / x.std(axis=1, keepdims=True)


CLS_INPUTS = {"raw": None, "12lead_250hz": twelve_leads_250hz}


class TianchiClassificationDataset:
    """CSV-driven multi-label classification reader (reference
    EcgTianChiDataset, tianchi.py:10-43): column 0 is the npy filename, columns
    3+ are the binary labels; 80/20 train/test split seeded by cfg.seed
    (`split_80_20`). Feeds the classifiers (MODEL.model 'model_resnet1d' and
    'model_st_mem_vit', DATA.dataset 'tianchi_cls'); an example is {"data":
    [leads, T] float32, "label": [C] int64}, which `collate` stacks: the
    stored 8 leads under DATA.cls_input 'raw', or `twelve_leads_250hz`'s 12
    under '12lead_250hz' (before any `transform`). Reads the CSV with the csv
    module, as the card's machine has no pandas."""

    def __init__(self, cfg, phase: str, transform=None):
        import csv

        with open(cfg.DATA.train_label_path, newline="") as f:
            rows = list(csv.reader(f))
        self.label_name = np.array(rows[0][3:])
        rows = [r for r in rows[1:] if r]
        self.data_root = cfg.DATA.train_data_root
        train_rows, test_rows = split_80_20(len(rows), cfg.seed)
        keep = train_rows if phase == "train" else test_rows
        self.files = [rows[i][0] for i in keep]
        self.label = np.array([[int(float(v)) for v in rows[i][3:]] for i in keep],
                              dtype=np.int64).reshape(len(keep), len(self.label_name))
        self.transform = transform
        if cfg.DATA.cls_input not in CLS_INPUTS:
            raise ValueError(f"unknown DATA.cls_input {cfg.DATA.cls_input!r} (use {' or '.join(map(repr, CLS_INPUTS))})")
        self.layout = CLS_INPUTS[cfg.DATA.cls_input]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int, rng=None) -> dict:
        data = np.load(os.path.join(self.data_root, self.files[index])).astype(np.float64)
        if self.layout is not None:
            data = self.layout(data)
        if self.transform is not None:
            data = self.transform(data)
        return {"data": data.astype(np.float32), "label": self.label[index], "id": self.files[index]}

    def get_label_weight(self) -> np.ndarray:
        """Inverse-frequency example weights for WeightedRandomSampler-style
        sampling (cfg.DATA.weighted_sample, reference train_net.py:22-26)."""
        freq = self.label.sum(axis=0).astype(np.float64)
        freq = np.maximum(freq, 1.0)
        w = (self.label / freq).sum(axis=1)
        return np.maximum(w, 1e-8)
