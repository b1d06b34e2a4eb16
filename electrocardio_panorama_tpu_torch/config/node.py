"""Minimal yacs-compatible config node.

The reference uses yacs (`CfgNode`, reference codes/config/default.py:1-4 and
`cfg.merge_from_file(yaml)` at codes/main.py:22-23). yacs is not available in
this environment; this Node reproduces the subset of its behavior the framework
needs: attribute access, YAML overlay with type checking, `merge_from_list`,
clone, and pretty printing — so the reference's shipped .yml configs load
unchanged.
"""

from __future__ import annotations

import copy
from typing import Any

import yaml

# Type pairs that may silently coerce during a merge (yacs-compatible).
_COERCIONS = {
    (int, float): float,
    (float, int): float,
    (tuple, list): list,
    (list, tuple): list,
}


class Node(dict):
    """A dict with attribute access and typed YAML merging."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    def clone(self) -> "Node":
        return copy.deepcopy(self)

    # ------------------------------------------------------------- merging
    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            overlay = yaml.safe_load(f) or {}
        self._merge(overlay, [])

    def merge_from_other(self, other: dict) -> None:
        self._merge(other, [])

    def merge_from_list(self, opts: list) -> None:
        """Merge from a flat [key1, val1, key2, val2, ...] list; dotted keys."""
        assert len(opts) % 2 == 0, "override list must have even length"
        for key, val in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"config key not found: {key}")
            if isinstance(val, str):
                val = _parse_literal(val)
            node[leaf] = _check_type(node[leaf], val, key)

    def _merge(self, overlay: dict, trail: list) -> None:
        for key, val in overlay.items():
            path = ".".join(trail + [str(key)])
            if key not in self:
                raise KeyError(f"config key not found: {path}")
            cur = self[key]
            if isinstance(cur, Node):
                if not isinstance(val, dict):
                    raise TypeError(f"cannot overwrite group {path} with a scalar")
                cur._merge(val, trail + [str(key)])
            else:
                self[key] = _check_type(cur, val, path)

    # -------------------------------------------------------------- output
    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, Node) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __str__(self) -> str:
        return self.dump()


def _parse_literal(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _check_type(old: Any, new: Any, path: str) -> Any:
    # bool is an int subclass in Python; a bool arriving at an int/float key is
    # a typo'd config ('epochs: yes'), not a number — reject before isinstance.
    if isinstance(new, bool) and isinstance(old, (int, float)) and not isinstance(old, bool):
        raise TypeError(f"type mismatch at {path}: have {type(old).__name__}, got bool")
    if old is None or new is None or isinstance(new, type(old)):
        return new
    coerce = _COERCIONS.get((type(new), type(old)))
    if coerce is not None:
        return coerce(new)
    # PyYAML (YAML 1.1) parses bare scientific notation like `1e-1` as a
    # string; the reference's shipped configs rely on it meaning a float.
    if isinstance(old, (int, float)) and isinstance(new, str):
        try:
            return type(old)(float(new))
        except ValueError:
            pass
    raise TypeError(
        f"type mismatch at {path}: have {type(old).__name__}, got {type(new).__name__}"
    )
