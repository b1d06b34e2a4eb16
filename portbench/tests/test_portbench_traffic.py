"""The traffic generator's pools equal the batches the program's own loader
assembles from the same records."""

import json
import os

import numpy as np
import pytest

from portbench.harness import load_cell
from portbench.traffic import generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_corpus(root, recs):
    """The records in the Tianchi on-disk layout the program's dataset reads."""
    npy, lab = os.path.join(root, "npy"), os.path.join(root, "labels")
    os.makedirs(npy)
    os.makedirs(lab)
    names = []
    for i, (data, marks) in enumerate(recs):
        np.save(os.path.join(npy, f"r{i:05d}.npy"), data)
        with open(os.path.join(lab, f"r{i:05d}.json"), "w") as f:
            json.dump(marks, f)
        names.append(f"r{i:05d}.json")
    listing = os.path.join(root, "list.txt")
    with open(listing, "w") as f:
        f.write("\n".join(names) + "\n")
    return {"train_label_path": listing, "test_label_path": listing, "train_data_root": npy,
            "train_label_root": lab}


@pytest.mark.parametrize("phase", ["train", "test"])
def test_pool_equals_beatloader(tmp_path, phase):
    from electrocardio_panorama_tpu_torch.config import get_cfg
    from electrocardio_panorama_tpu_torch.data import BeatLoader, TianchiBeatDataset

    cell = load_cell(ROOT, "nefnet.train.f32.b85")
    mix = {"batch": 4, "pool": 3, "phase": phase, "record_len": 5000}
    seed = 2**33 + 11
    cfg = get_cfg()
    cfg.merge_from_other(cell.config["settings"])
    for k, v in write_corpus(str(tmp_path), generator.pool_records(mix, seed)).items():
        cfg.DATA[k] = v
    cfg.DATA.use_native_prep = False
    loader = BeatLoader(TianchiBeatDataset(cfg, phase), mix["batch"], shuffle=False, drop_last=True, seed=seed)
    want = list(loader)
    got = generator.pool(mix, cell.data_cfg(), seed)
    assert len(got) == len(want) == mix["pool"]
    for g, w in zip(got, want):
        for k, v in g.items():
            assert v.dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(v, w[k], err_msg=k)


def test_rows_differ_and_seed_fixes_the_pool():
    cell = load_cell(ROOT, "nefnet.train.f32.b85")
    mix = {"batch": 4, "pool": 2, "phase": "train", "record_len": 5000}
    a, b = (generator.pool(mix, cell.data_cfg(), 7) for _ in range(2))
    c = generator.pool(mix, cell.data_cfg(), 8)
    rows = np.concatenate([p["data"] for p in a]).reshape(8, -1)
    assert len({r.tobytes() for r in rows}) == 8
    assert all(np.array_equal(x["data"], y["data"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["data"], c[0]["data"])


def test_view_grid_is_the_programs():
    from electrocardio_panorama_tpu_torch.synthesis import theta_grid

    for n_theta, n_phi in ((14, 24), (7, 12)):
        np.testing.assert_array_equal(generator.view_grid(n_theta, n_phi), theta_grid(n_theta, n_phi))
