"""Dataset factory (reference codes/dataset/__init__.py:5-16)."""

from electrocardio_panorama_tpu_torch.data.beats import beat_rois, build_meta
from electrocardio_panorama_tpu_torch.data.leads import (
    LEAD_NAMES,
    LEAD_THETA,
    derive_augmented_leads,
    lead_partition,
    partition_sizes,
)
from electrocardio_panorama_tpu_torch.data.pipeline import BeatLoader, collate
from electrocardio_panorama_tpu_torch.data.ptb import PTBBeatDataset, reorder_ptb_leads
from electrocardio_panorama_tpu_torch.data.synthetic import (
    generate_ptb_dataset,
    generate_tianchi_classification_dataset,
    generate_tianchi_dataset,
)
from electrocardio_panorama_tpu_torch.data.tianchi import TianchiBeatDataset, TianchiClassificationDataset

__all__ = [
    "build_dataset",
    "BeatLoader",
    "collate",
    "TianchiBeatDataset",
    "TianchiClassificationDataset",
    "PTBBeatDataset",
    "LEAD_THETA",
    "LEAD_NAMES",
    "lead_partition",
    "partition_sizes",
    "derive_augmented_leads",
    "reorder_ptb_leads",
    "beat_rois",
    "build_meta",
    "generate_tianchi_dataset",
    "generate_tianchi_classification_dataset",
    "generate_ptb_dataset",
]


def _synthetic_classification_corpus(cfg) -> None:
    """Point DATA.train_label_path / train_data_root at the labelled corpus
    under DATA.synthetic_root, writing it there first unless one of the
    configured size (synthetic_n_train + synthetic_n_test records,
    MODEL.num_classes labels) is there already."""
    import os

    root = cfg.DATA.synthetic_root
    n = int(cfg.DATA.synthetic_n_train) + int(cfg.DATA.synthetic_n_test)
    csv_path = os.path.join(root, "labels.csv")
    have = None
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        have = (len(lines) - 1, len(lines[0].split(",")) - 3 if lines else 0)
    if have == (n, cfg.MODEL.num_classes):
        overrides = {"train_label_path": csv_path, "train_data_root": os.path.join(root, "npy_data", "tianchi_cls")}
    else:
        overrides = generate_tianchi_classification_dataset(root, n_records=n, num_classes=cfg.MODEL.num_classes)
    for k, v in overrides.items():
        cfg.DATA[k] = v


def build_dataset(cfg, phase: str):
    if cfg.DATA.dataset == "tianchi":
        return TianchiBeatDataset(cfg, phase)
    if cfg.DATA.dataset == "tianchi_cls":
        # the classifier's records and labels (model_resnet1d); a synthetic
        # labelled corpus under DATA.synthetic_root when that is set
        if cfg.DATA.synthetic_root:
            _synthetic_classification_corpus(cfg)
        return TianchiClassificationDataset(cfg, phase)
    if cfg.DATA.dataset == "ptbv2":
        # path patching parity (reference dataset/__init__.py:8-14) — but
        # only for keys still at their config defaults, so an explicit
        # DATA.* override (CLI or yml) can point at a custom PTB corpus
        # (e.g. the synthetic PTB-layout generator's output)
        from electrocardio_panorama_tpu_torch.config import get_cfg as _defaults

        _d = _defaults().DATA
        for key, ref_path in (
            ("train_pkl_path", "data/ptb/ptb_pkl_data/train_ptb.pkl"),
            ("test_pkl_path", "data/ptb/ptb_pkl_data/test_ptb.pkl"),
            ("train_label_path", "data/ptb/ptb_train.txt"),
            ("test_label_path", "data/ptb/ptb_test.txt"),
            ("train_data_root", "data/ptb/ptb-diag_preprocess"),
        ):
            if cfg.DATA[key] == _d[key]:
                cfg.DATA[key] = ref_path
        return PTBBeatDataset(cfg, phase)
    if cfg.DATA.dataset == "synthetic":
        # self-contained synthetic corpus generated under output_dir
        import os

        root = getattr(cfg.DATA, "synthetic_root", None) or cfg.output_dir + "/synthetic_data"
        marker = f"{root}/tianchi_train_jsons.txt"
        n_train = int(getattr(cfg.DATA, "synthetic_n_train", 16))
        n_test = int(getattr(cfg.DATA, "synthetic_n_test", 8))
        # an existing corpus is only reused if BOTH splits were generated at
        # the SAME size — otherwise a resized config would silently train or
        # eval on the stale corpus (each marker lists one record per line)
        test_marker = f"{root}/tianchi_test_jsons.txt"

        def _lines(path):
            if not os.path.exists(path):
                return -1
            with open(path) as f:
                return sum(1 for line in f if line.strip())

        have_train, have_test = _lines(marker), _lines(test_marker)
        reuse = have_train == n_train and have_test == n_test
        if not reuse and have_train >= 0:
            print(
                f"synthetic corpus at {root} has {have_train} train / "
                f"{have_test} test records but the config asks for "
                f"{n_train}/{n_test}; regenerating"
            )
        if not reuse:
            from electrocardio_panorama_tpu_torch.data.synthetic import generate_tianchi_dataset

            overrides = generate_tianchi_dataset(root, n_train=n_train, n_test=n_test)
        else:
            overrides = {
                "train_label_path": f"{root}/tianchi_train_jsons.txt",
                "test_label_path": f"{root}/tianchi_test_jsons.txt",
                "train_data_root": f"{root}/npy_data/tianchi_train_round1",
                "train_label_root": f"{root}/tianchi_interval",
            }
        for k, v in overrides.items():
            cfg.DATA[k] = v
        return TianchiBeatDataset(cfg, phase)
    raise NotImplementedError(f"{cfg.DATA.dataset} is not supported")
