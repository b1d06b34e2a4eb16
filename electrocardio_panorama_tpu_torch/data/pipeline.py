"""Host-side batching pipeline.

Replaces torch DataLoader (reference train_net.py:22-28: batch 32, shuffle,
drop_last, worker processes). TPU-side differences:

  * fixed-shape numpy batches (jit re-traces are shape-keyed; every batch of a
    given config has identical shapes);
  * deterministic per-(epoch, position) RNG streams — reproducible epochs
    without global RNG state (the reference entangles three RNGs,
    utils/seed_torch.py:7-17);
  * optional thread-pool prefetch (dataset __getitem__ is pure numpy; threads
    avoid torch's worker-process + file_system sharing machinery, main.py:8).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

_STACK_KEYS = (
    "data", "rois", "input_theta", "target_view", "target_theta",
    "ori_data", "rest_view", "rest_theta", "noise", "label",
)


def collate(metas: list[dict]) -> dict:
    batch = {k: np.stack([m[k] for m in metas]) for k in _STACK_KEYS if k in metas[0]}
    batch["id"] = [m.get("id", "") for m in metas]
    batch["unsupervision_lead_name"] = metas[0].get("unsupervision_lead_name", [])
    return batch


class BeatLoader:
    """Iterable of collated batches with drop_last semantics (train_net.py:27-28)."""

    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        *,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        num_threads: int = 0,
        sample_weights=None,
        num_samples: int = 5000,
        process_slice: slice | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.epoch = 0
        # Multi-host data parallelism: every process iterates the SAME global
        # index order (seeded identically), but assembles only its
        # local_batch_slice of each batch — per-example RNG streams stay keyed
        # by GLOBAL batch position, so the global batch is identical to the
        # single-process one regardless of topology (parallel/multihost.py).
        self.process_slice = process_slice
        if process_slice is not None and not drop_last:
            raise ValueError(
                "process_slice requires drop_last=True (a ragged final batch "
                "would desync the per-process slices)"
            )
        # WeightedRandomSampler equivalence (reference train_net.py:22-26):
        # draw num_samples indices with replacement, weighted.
        self.sample_weights = None
        self.num_samples = num_samples
        if sample_weights is not None:
            w = np.asarray(sample_weights, np.float64)
            self.sample_weights = w / w.sum()

    def _epoch_len(self) -> int:
        return self.num_samples if self.sample_weights is not None else len(self.dataset)

    def __len__(self) -> int:
        n = self._epoch_len() // self.batch_size
        if not self.drop_last and self._epoch_len() % self.batch_size:
            n += 1
        return max(n, 0)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _example(self, index: int, position: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, position])
        )
        return self.dataset.__getitem__(index, rng=rng)

    def __iter__(self):
        epoch_rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, 0xE90C])
        )
        if self.sample_weights is not None:
            order = epoch_rng.choice(
                len(self.dataset), size=self.num_samples, replace=True,
                p=self.sample_weights,
            )
        else:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                epoch_rng.shuffle(order)
        n_full = len(order) // self.batch_size
        ends = n_full * self.batch_size
        if not self.drop_last and len(order) % self.batch_size:
            ends = len(order)

        spans = [
            (b * self.batch_size, min((b + 1) * self.batch_size, ends))
            for b in range((ends + self.batch_size - 1) // self.batch_size)
        ]
        def batch_offsets(lo, hi):
            offs = range(hi - lo)
            return offs if self.process_slice is None else offs[self.process_slice]

        if self.num_threads > 1:
            # one pool per epoch (not per batch), with a one-batch lookahead:
            # batch i+1 assembles on the pool while the caller consumes batch i.
            # +1 worker because the submitted fetch itself occupies a thread
            # while blocked in pool.map — without it, example assembly would
            # run at num_threads-1 wide
            pool = ThreadPoolExecutor(self.num_threads + 1)
            try:
                def fetch(span):
                    lo, hi = span
                    return collate(list(pool.map(
                        lambda off: self._example(int(order[lo + off]), lo + off),
                        batch_offsets(lo, hi),
                    )))

                pending = pool.submit(fetch, spans[0]) if spans else None
                for nxt in spans[1:]:
                    batch, pending = pending.result(), pool.submit(fetch, nxt)
                    yield batch
                if pending is not None:
                    yield pending.result()
            finally:
                try:
                    pool.shutdown(wait=False, cancel_futures=True)
                except Exception:
                    # generator GC'd during interpreter teardown: the queue
                    # module backing the pool may already be torn down
                    pass
        else:
            for lo, hi in spans:
                yield collate([
                    self._example(int(order[lo + off]), lo + off)
                    for off in batch_offsets(lo, hi)
                ])
        self.epoch += 1
