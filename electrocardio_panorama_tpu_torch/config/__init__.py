"""Config system: yacs-compatible Node tree with the reference's key schema."""

from electrocardio_panorama_tpu_torch.config.defaults import get_default_cfg
from electrocardio_panorama_tpu_torch.config.node import Node

__all__ = ["Node", "get_cfg", "load_cfg", "get_default_cfg"]


def get_cfg() -> Node:
    """A fresh default config (reference codes/config/default.py)."""
    return get_default_cfg()


def load_cfg(yaml_path: str = "", opts: list | None = None) -> Node:
    """Default config overlaid with a YAML file and/or dotted-key overrides.

    Mirrors the reference entry flow (codes/main.py:22-26): `desc` is derived
    from the YAML filename and `output_dir` gets the desc suffix appended.
    """
    cfg = get_default_cfg()
    if yaml_path:
        cfg.merge_from_file(yaml_path)
        cfg.desc = yaml_path.replace("\\", "/").split("/")[-1].replace(".yml", "").replace(".yaml", "")
    if opts:
        cfg.merge_from_list(opts)
    return cfg
