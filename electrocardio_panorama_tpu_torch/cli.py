"""Shared CLI plumbing for the entry points (reference main.py:10-30)."""

from __future__ import annotations

import argparse

from electrocardio_panorama_tpu_torch.config import load_cfg


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config-file", default="", metavar="FILE", help="path to config file")
    p.add_argument(
        "opts", nargs="*", default=[],
        help="dotted-key overrides: KEY VALUE [KEY VALUE ...] (e.g. SOLVER.epochs 3)",
    )
    return p


def cfg_from_args(args):
    cfg = load_cfg(args.config_file, args.opts)
    return cfg
