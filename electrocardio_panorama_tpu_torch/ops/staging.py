"""A step's host arrays to the device without waiting for the card.

A copy from pageable host memory waits until the stream has drained: the
CUDA runtime stages it through a buffer of its own. `PinnedStaging` copies each
array into pinned host memory that it owns and queues the copy to the
device from there (`non_blocking=True`), behind the work already on the
current stream. Each key keeps a ring of two slots, sized for its array and
made anew for an array of another shape or dtype; a CUDA event recorded
after a call's copies marks its slots busy. Before the host writes into a
slot again it waits on that event: a copy two calls back, not the card's
whole queue. The wait runs under the span
`ecgpan.train_step.inputs.slot_wait`. On a CPU device the arrays become
tensors as they are, sharing their memory.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from electrocardio_panorama_tpu_torch.utils.profiling import span

# "staged": arrays copied through a pinned slot; "slot_waits": times the host
# found a slot's earlier copy still pending and waited on its event;
# "pageable": arrays handed over as they are, on a CPU device
STAGED: collections.Counter = collections.Counter()

SLOTS = 2


class PinnedStaging:
    """The ring of pinned slots of one device, per key."""

    def __init__(self, device: torch.device):
        self.device = device
        self._rings: dict = {}  # key -> [next slot, [[pinned tensor, event] or None] * SLOTS]

    def tensors(self, batch: dict, keys) -> list[torch.Tensor]:
        """`batch[k]` for each of `keys` as a tensor on the device, in order."""
        arrays = [torch.as_tensor(np.asarray(batch[k])) for k in keys]
        if self.device.type != "cuda":
            STAGED["pageable"] += len(arrays)
            return [a.to(self.device, non_blocking=True) for a in arrays]
        slots, out = [], []
        for k, a in zip(keys, arrays):
            ring = self._rings.setdefault(k, [0, [None] * SLOTS])
            i = ring[0]
            ring[0] = (i + 1) % SLOTS
            slot = ring[1][i]
            if slot is not None and slot[1] is not None and not slot[1].query():
                STAGED["slot_waits"] += 1
                with span("ecgpan.train_step.inputs.slot_wait"):
                    slot[1].synchronize()
            if slot is None or slot[0].shape != a.shape or slot[0].dtype != a.dtype:
                slot = ring[1][i] = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True), None]
            np.copyto(slot[0].numpy(), a.numpy())  # one thread: no intra-op pool woken on the step's path
            out.append(slot[0].to(self.device, non_blocking=True))
            slots.append(slot)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        for slot in slots:
            slot[1] = done
        STAGED["staged"] += len(slots)
        return out
