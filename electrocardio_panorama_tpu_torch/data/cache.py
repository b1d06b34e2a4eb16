"""Bounded thread-safe LRU for the dataset hot paths.

One shared implementation for the three loader caches (Tianchi record +
prepped-beat, PTB prepped-beat): ``BeatLoader(num_threads>1)`` calls
``__getitem__`` from a worker pool, and get->move_to_end racing with
insert->evict on a bare OrderedDict corrupts it — the lock covers only the
dict operations (the expensive prep work runs outside it).

Cached values are SHARED across epochs and threads, so they must be
immutable: ``put`` marks every ndarray in the value read-only
(``setflags(write=False)``), turning any accidental in-place mutation by a
consumer into a loud ValueError instead of silent corruption of every later
epoch. Row views of a frozen array are frozen too; advanced indexing and
``np.stack`` (collate) copy, so batch arrays stay writable.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


def _freeze(value):
    if isinstance(value, np.ndarray):
        value.setflags(write=False)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _freeze(v)
    return value


class LockedLRU:
    """get/put LRU bounded to ``maxsize`` entries; ``maxsize <= 0`` disables
    caching (put becomes a no-op, get always misses)."""

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key):
        with self._lock:
            value = self._data.get(key)
            if value is not None:
                self._data.move_to_end(key)
        return value

    def put(self, key, value):
        """Insert (freezing ndarrays in place — the caller's references become
        read-only too) and evict least-recently-used beyond maxsize."""
        if self.maxsize <= 0:
            return value
        _freeze(value)
        with self._lock:
            self._data[key] = value
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
        return value
