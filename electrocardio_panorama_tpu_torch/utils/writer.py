"""Scalar logging: JSONL always, TensorBoard when tensorboardX is installed
(the JAX package's utils/writer.py).

Scalar names match the reference's tensorboard set (solver.py:86-88):
train_loss_all, test_loss_all, train_loss_1, test_loss_1, train_loss_2,
test_loss_2, train_3, test_3, test_unsuperv, psnr_gen, psnr_reg, ssim_gen,
ssim_reg (+ per-lead psnr_reg_lead_i / ssim_reg_lead_i).
"""

from __future__ import annotations

import json
import os


class ScalarWriter:
    def __init__(self, logdir: str | None, use_tensorboard: bool = True):
        self.logdir = logdir
        self.tb = None
        self.jsonl = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self.jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
            if use_tensorboard:
                try:
                    import tensorboardX

                    self.tb = tensorboardX.SummaryWriter(logdir=logdir)
                except ImportError:
                    self.tb = None

    def prune_from(self, step: int) -> None:
        """Drop persisted rows with step >= `step`, so that scalars.jsonl is
        one clean monotone run: a fresh run truncates a stale file, and a
        resume from epoch N drops the rows from N on that an earlier process
        wrote. TensorBoard event files are append-only and keep theirs."""
        if not self.jsonl:
            return
        path = os.path.join(self.logdir, "scalars.jsonl")
        self.jsonl.close()
        try:
            with open(path) as f:
                rows = [line for line in f if line.strip()]
            kept = [line for line in rows if json.loads(line).get("step", 0) < step]
            if len(kept) != len(rows):
                with open(path, "w") as f:
                    f.writelines(kept)
        finally:
            self.jsonl = open(path, "a")

    def write(self, scalars: dict, step: int) -> None:
        if self.jsonl:
            self.jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self.jsonl.flush()
        if self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), global_step=step)

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
        if self.tb:
            self.tb.close()
