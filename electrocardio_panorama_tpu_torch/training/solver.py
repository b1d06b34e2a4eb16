"""Solver: the training/eval runtime (reference codes/solver/solver.py:16-245;
the JAX package's training/solver.py) on one CUDA device, or on the CPU when
the caller names it.

  * one train step: forward, loss, backward and the optimizer update, in
    TPU.compute_dtype over float32 masters (training/precision.py); the loss
    tuple is (loss, loss1*f0, loss2*f1, loss3*f2);
  * one eval step: outputs, the loss tuple with the unsupervised term, and
    PSNR/SSIM with the gen/reg split on the device; the rest views decode
    through the streamed-basis kernel A1 under TPU.eval_decoder;
  * the encoder of the train step is the fused pair A2/A3 under
    TPU.train_encoder, and of the eval step A2 in eval form under
    TPU.eval_encoder, both the definition's `fused_encode` ('auto' picks the
    pair on CUDA with bfloat16 compute where the definition has one, as the
    JAX package picks its Pallas pair on a TPU); otherwise the train step's
    eager encode is the definition's `graphed_encode` where it has one
    (Nef-Net2's: replayed from CUDA graphs on one device, without a mesh);
  * the three grouped decodes of the train step go through the fused pair
    A4f/A4b under TPU.train_decoder 'fused' ('xla', the default, is the eager
    grouped decode; there is no 'auto', as in the JAX package);
  * dropout masks come from a per-step torch.Generator seeded from
    (seed, epoch, step), and the standin shuffle indices from a per-epoch
    numpy stream, so a resume at an epoch reproduces both streams, and the
    fused and eager encoders see the same masks;
  * every step's arrays reach a CUDA device through the Solver's ring of
    pinned slots (ops/staging.py), queued behind the previous step's work:
    no call of a step's inputs waits for the card to drain;
  * under TPU.mesh_shape, data parallelism over torch.distributed, one
    process per device (parallel/): each rank steps on its slice of the
    global batch with its rows of the full-batch masks, the eager decoder's
    BatchNorm moments cover the global batch, gradients, loss components and
    eval metrics are averaged over the ranks, and rank 0 alone takes the run
    lock, writes scalars and checkpoints and paints;
  * for a classifier definition (MODEL.model 'model_resnet1d', the
    reference's 1-D ResNet, or 'model_st_mem_vit', ST-MEM's ViT), decided
    once in __init__, the steps are the classifier's: records `data`
    [B, in_channel, T] and multi-hot `label` [B, C] through the same phases
    and spans, the definition's dropout masks from the step's generator (one
    per ResNet block, none for the ViT), the loss vector [1] (BCE) and the
    configured optimizer (SGD or Adam); eval gives the BCE
    and [tp, fp, fn] at 0.5 (training/metrics.py). No A1-A4 function is
    built for it;
  * what differs between the models is the bound definition's
    (models/__init__.py): the knobs it takes (`check_knobs` raises on the
    others), its fused encode, its dropout masks, the loss widths, the
    epoch's scalars and the best-epoch score.

Checkpoint cadence and best-model selection mirror the reference: every epoch
saved as epoch_{n}.pkl, best tracked by test psnr_gen into best_valid.pkl,
auto-resume from the last_checkpoint pointer with restored epoch and best.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from electrocardio_panorama_tpu_torch.models import build_loss, build_model
from electrocardio_panorama_tpu_torch.ops import PinnedStaging, angular_encode, full_f32
from electrocardio_panorama_tpu_torch.ops.kernels.decoder_train import make_train_decode_fn
from electrocardio_panorama_tpu_torch.parallel import (
    BatchStatSync,
    all_reduce_mean_,
    local_batch_slice,
    make_mesh,
    process_count,
    process_index,
    synced_train_decode_fn,
)
from electrocardio_panorama_tpu_torch.training import metrics as M
from electrocardio_panorama_tpu_torch.training.checkpoint import CheckPointer
from electrocardio_panorama_tpu_torch.training.optim import (
    get_optimizer,
    load_state_by_key,
    lr_for_epoch,
    set_lr,
    state_by_key,
)
from electrocardio_panorama_tpu_torch.training.precision import cast_floats, cast_floats_f32
from electrocardio_panorama_tpu_torch.utils import ScalarWriter, profiling, resolve_device
from electrocardio_panorama_tpu_torch.utils.profiling import span

_TRAIN_KEYS = ("data", "input_theta", "target_theta", "rois", "target_view", "noise")
_EVAL_KEYS = ("data", "input_theta", "target_theta", "rois", "rest_theta", "target_view", "rest_view")
_CLASSIFY_KEYS = ("data", "label")


def _waited(dl):
    """The loader's batches, each taken under the span ecgpan.loader_wait."""
    batches, end = iter(dl), object()
    while True:
        with span("ecgpan.loader_wait"):
            batch = next(batches, end)
        if batch is end:
            return
        yield batch


def gen_lead_count(cfg) -> int:
    """Number of truly-unseen ('gen') leads at the end of rest_out
    (solver.py:197-199)."""
    gen_num = 6 if cfg.DATA.lead_num == 336 else 4
    if cfg.DATA.super_mode != "normal":
        gen_num = int(cfg.DATA.super_mode[-1])
    return gen_num


def whole_sequence_metrics(cfg) -> bool:
    """True when eval metrics cover the whole rest_out (no gen/reg split, no
    roi masking): dataset 'mit', super_mode '_mit', or a super_mode with zero
    unsupervised leads (reference solver.py:200-206)."""
    return (cfg.DATA.dataset == "mit" or cfg.DATA.super_mode == "_mit"
            or (cfg.DATA.super_mode != "normal" and cfg.DATA.super_mode[-1] == "0"))


def step_seed(seed: int, epoch: int, step: int) -> int:
    """Seed of the step's dropout generator: a function of (seed, epoch, step)
    only, so a resume reproduces the stream."""
    return int(np.random.SeedSequence([seed, epoch, step, 0xD809]).generate_state(1)[0])


def local_rows(masks, rows: slice, batch: int):
    """This rank's rows of the global batch's masks (m6 [6, batch*k, ...],
    mc20 and mc22 [batch*k, ...], k rows per beat: 1 for Nef-Net, the leads
    for Nef-Net2), so that the topology does not change the draws."""
    m6, mc20, mc22 = masks
    k = mc20.shape[0] // batch
    sl = slice(rows.start * k, rows.stop * k)
    return m6[:, sl].contiguous(), mc20[sl].contiguous(), mc22[sl].contiguous()


def check_ported_knobs(cfg) -> None:
    """Knobs that the port does not take raise, naming why (ROADMAP.md);
    they never run something else silently."""
    backend = cfg.TPU.checkpoint_backend
    if backend == "orbax":
        raise NotImplementedError(
            "TPU.checkpoint_backend='orbax' is not ported, on purpose (ROADMAP.md, divergences kept on purpose): "
            "orbax.checkpoint imports jax, which the port never loads; reading its layout without jax takes "
            "tensorstore, which the port's CUDA environment does not have; use 'pickle', the checkpoint format "
            "that both packages read and write")
    if backend != "pickle":
        raise ValueError(f"unknown TPU.checkpoint_backend {backend!r} (use 'pickle' or 'orbax')")
    if cfg.TPU.train_decoder not in ("xla", "fused"):
        raise ValueError(f"unknown TPU.train_decoder {cfg.TPU.train_decoder!r} (use 'xla' or 'fused')")


class Solver:
    def __init__(self, cfg, use_writer: bool = True, device=None):
        check_ported_knobs(cfg)
        self.cfg = cfg
        self.desc = cfg.desc
        self.device = resolve_device(device)
        self.output_dir = os.path.join(cfg.output_dir, cfg.desc)
        os.makedirs(self.output_dir, exist_ok=True)
        self.model = build_model(cfg)
        self.model.check_knobs(cfg)
        self.loss = build_loss(cfg)
        self.compute_dtype = getattr(torch, cfg.TPU.compute_dtype)
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"TPU.compute_dtype {cfg.TPU.compute_dtype!r}: use float32 or bfloat16")
        self.mixed = self.compute_dtype != torch.float32
        # TPU.mesh_shape: every mesh axis splits the batch over the ranks
        self.mesh = (make_mesh(cfg.TPU.mesh_shape, cfg.TPU.mesh_axes, self.device)
                     if list(cfg.TPU.mesh_shape) else None)
        if self.mesh is None and process_count() > 1:
            raise ValueError(f"{process_count()} processes need TPU.mesh_shape over all of them "
                             f"(e.g. [{process_count()}]) so that they share one model")
        self.world = process_count() if self.mesh is not None else 1
        self.rank0 = process_index() == 0
        self.writer = ScalarWriter(os.path.join(cfg.output_dir, "tf_logs")
                                   if use_writer and self.desc != "debug" and self.rank0 else None)
        self._staging = PinnedStaging(self.device)
        if self.model.classifier:  # no fused function: the step and the eval are the classifier's
            self.train_encoder = self.train_decoder = self.eval_decoder = "xla"
            self._train_enc_fn = self._train_dec_fn = self._eval_enc_fn = None
            self.train_step, self.eval_step = self._classify_train_step, self._classify_eval_step
        else:
            self.train_encoder = self._train_encoder_mode()
            self._train_enc_fn = (self.model.fused_encode(ckpt=cfg.TPU.encoder_ckpt)
                                  if self.train_encoder == "fused"
                                  else self.model.graphed_encode(mesh=self.mesh is not None))
            # TPU.train_decoder 'fused': the grouped decodes through A4f/A4b, in
            # the compute dtype (on a CPU tensor the pair's plain version)
            self.train_decoder = cfg.TPU.train_decoder
            # the eager decode under a mesh of several ranks: BatchNorm over the
            # global batch; A4f normalizes each rank's sub-batch with its own moments
            self._train_dec_fn = (make_train_decode_fn(self.compute_dtype) if self.train_decoder == "fused"
                                  else synced_train_decode_fn(BatchStatSync()) if self.world > 1 else None)
            self.eval_decoder = self._eval_decoder_mode()
            self._eval_enc_fn = self._eval_encode_fn()
        # per epoch: train losses [steps, 4], host-clock times, scalars
        self.history: dict[int, dict] = {}

    # ----------------------------------------------------------------- knobs
    def _train_encoder_mode(self) -> str:
        """TPU.train_encoder: 'auto' picks the fused pair A2/A3 on CUDA with
        bfloat16 compute where the definition has a fused encode (Nef-Net's),
        and the eager encoder elsewhere; 'fused' forces the pair (float32 or
        bfloat16; on a CPU tensor it runs the pair's plain version); 'xla'
        names the eager encoder."""
        mode = self.cfg.TPU.train_encoder
        if mode == "auto":
            mode = ("fused" if self.mixed and self.device.type == "cuda"
                    and self.model.fused_encode is not None else "xla")
        if mode not in ("xla", "fused"):
            raise ValueError(f"unknown TPU.train_encoder {mode!r} (use 'auto', 'xla', or 'fused')")
        return mode

    def _eval_decoder_mode(self) -> str:
        """TPU.eval_decoder: 'auto' is the A1 kernel on CUDA and the eager
        decoder on the CPU; 'fused' / 'fused_bf16' name A1 with float32 /
        bfloat16 storage."""
        dec = self.cfg.TPU.eval_decoder
        if dec == "auto":
            dec = "fused" if self.device.type == "cuda" else "xla"
        if dec not in ("xla", "fused", "fused_bf16"):
            raise ValueError(f"unknown TPU.eval_decoder {dec!r} (use 'auto', 'xla', 'fused', or 'fused_bf16')")
        return dec

    def _eval_encode_fn(self):
        """TPU.eval_encoder: 'fused' runs A2 in eval form, 'xla' the eager
        encoder."""
        enc = self.cfg.TPU.eval_encoder
        if enc == "fused":
            return self.model.fused_encode()
        if enc != "xla":
            raise ValueError(f"unknown TPU.eval_encoder {enc!r} (use 'xla' or 'fused')")
        return None

    @staticmethod
    def _encode_hook(fn) -> dict:
        """The `encode_fn` keyword: Nef-Net's fused encoder, or Nef-Net2's
        graphed train encode (the definition's `graphed_encode`)."""
        return {"encode_fn": fn} if fn is not None else {}

    def draw_masks(self, gen: torch.Generator, B: int):
        """The step's pre-scaled dropout masks in the definition's layout."""
        return self.model.draw_masks(gen, B, dtype=self.compute_dtype)

    def _precision(self):
        """float32 steps run forward and backward at full float32: cuDNN's
        backward convolutions run inside loss.backward(), so TF32 stays off
        around it too."""
        return full_f32() if not self.mixed else contextlib.nullcontext()

    def _tensors(self, batch: dict, keys) -> list[torch.Tensor]:
        """The batch's arrays on the device, queued behind the stream's work
        through pinned slots on CUDA (`ops.staging`), so the step's inputs
        never wait for the card to drain."""
        return self._staging.tensors(batch, keys)

    # ---------------------------------------------------------------- state
    def init_state(self):
        """(params as leaf tensors that require grad, bn_state, optimizer),
        from a CPU generator seeded with cfg.seed."""
        params, bn_state = self.model.init(torch.Generator().manual_seed(self.cfg.seed), device=self.device)
        params = {k: v.requires_grad_(True) for k, v in params.items()}
        return params, bn_state, get_optimizer(self.cfg, params)

    # ----------------------------------------------------------------- steps
    def train_step(self, params: dict, bn_state: dict, opt, *, epoch: int, step: int, i1: int, i2: int,
                   batch: dict):
        """One step; updates `params` in place through `opt` and returns
        (new bn_state, loss vector [4] on the device)."""
        cfg = self.cfg
        with span("ecgpan.train_step"):
            with span("ecgpan.train_step.inputs"):
                data, it, tt, rois, tv, noise = self._tensors(batch, _TRAIN_KEYS)
                gen = torch.Generator(device=self.device).manual_seed(step_seed(cfg.seed, epoch, step))
                batch_all = data.shape[0] * self.world  # every rank draws the global batch's masks
                masks = self.draw_masks(gen, batch_all)
                if self.world > 1 and masks is not None:
                    masks = local_rows(masks, local_batch_slice(batch_all), batch_all)
                opt.zero_grad(set_to_none=True)
            with self._precision():
                with span("ecgpan.train_step.forward"):
                    p = cast_floats(params, self.compute_dtype) if self.mixed else params
                    if self.mixed:
                        data, it, tt = (t.to(self.compute_dtype) for t in (data, it, tt))
                    (out, sp, sl), new_bn = self.model.apply(
                        p, bn_state, data, it, tt, rois, phase="train", masks=masks, shuffle_idx=(i1, i2),
                        train_decode_fn=self._train_dec_fn, **self._encode_hook(self._train_enc_fn))
                    if self.mixed:
                        out, sp, sl = (t.float() for t in (out, sp, sl))
                        new_bn = cast_floats_f32(new_bn)
                    if cfg.DATA.noise:
                        out = out + noise[:, None, :]
                    loss, lo1, lo2, lo3 = self.loss(out, sp, sl, tv[:, None, :], cfg)
                with span("ecgpan.train_step.backward"):
                    loss.backward()
            with span("ecgpan.train_step.update"):
                if self.mesh is not None:
                    all_reduce_mean_([p.grad for p in params.values() if p.grad is not None])
                opt.step()
                new_bn = {k: v.detach() for k, v in new_bn.items()}
                lvec = torch.stack([loss, lo1, lo2, lo3]).detach().float()
                if self.mesh is not None:
                    # A4f's moments are each rank's own: averaging the running stats
                    # they chained keeps the replicas one model
                    own = ([v for v in new_bn.values() if v.is_floating_point()]
                           if self.train_decoder == "fused" else [])
                    all_reduce_mean_([lvec, *own])
        return new_bn, lvec

    @torch.no_grad()
    def eval_step(self, params: dict, bn_state: dict, batch: dict):
        """(out, rest_out, losses [5], metrics [4] = psnr_gen, psnr_reg,
        ssim_gen, ssim_reg, per-gen-lead [gen_num, 2] (psnr, ssim))."""
        cfg = self.cfg
        data, it, tt, rois, rt, tv, rv = self._tensors(batch, _EVAL_KEYS)
        rest_fn = None
        if self.eval_decoder != "xla":
            from electrocardio_panorama_tpu_torch.ops.kernels.decoder_fused import (
                fold_decoder_bn,
                fused_decode_views,
            )

            storage = torch.bfloat16 if self.eval_decoder == "fused_bf16" else torch.float32
            folded = fold_decoder_bn(params, bn_state, dtype=storage)

            def rest_fn(latent_all, r_theta):
                # the basis decode takes the angular encodings, not the gates
                enc = angular_encode(r_theta, cfg.MODEL.theta_L)
                return fused_decode_views(folded, latent_all.to(storage), enc=enc)

        with full_f32():
            (out, sp, sl, rest_out), _ = self.model.apply(
                params, bn_state, data, it, tt, rois, rest_theta=rt, phase="test", shuffle_idx=(0, 0),
                rest_decode_fn=rest_fn, **self._encode_hook(self._eval_enc_fn))
            rest_out = rest_out.float()
            # the unsupervised term over the last 4 rest views: the reference
            # hardcodes 4 whatever gen_num is (solver.py:192-193)
            losses = torch.stack(self.loss(out, sp, sl, tv[:, None, :], cfg, rest_out[:, -4:], rv[:, -4:]))
            gen_num = gen_lead_count(cfg)
            if whole_sequence_metrics(cfg) or gen_num == 0:
                full = torch.full_like(rois, 10**9)  # psnr_values clamps the end to T
                pv, sv = M.psnr_values(rest_out, rv, full), M.ssim_values(rest_out, rv, full)
                metrics = torch.stack([pv.mean(), pv.mean(), sv.mean(), sv.mean()])
                single = pv.new_zeros((0, 2))
            else:
                pv, sv = M.psnr_values(rest_out, rv, rois), M.ssim_values(rest_out, rv, rois)  # [B, R]
                metrics = torch.stack([pv[:, -gen_num:].mean(), pv[:, :-gen_num].mean(),
                                       sv[:, -gen_num:].mean(), sv[:, :-gen_num].mean()])
                single = torch.stack([pv[:, -gen_num:].mean(0), sv[:, -gen_num:].mean(0)], dim=1)
        if self.mesh is not None:  # means over the global batch
            all_reduce_mean_([losses, metrics, single])
        return out, rest_out, losses, metrics, single

    def _classify_train_step(self, params: dict, bn_state: dict, opt, *, epoch: int, step: int, i1: int = 0,
                             i2: int = 0, batch: dict):
        """The classifier's step (`train_step` under a classifier definition;
        the standin indices are unused): records and labels to the device, the
        definition's dropout masks from the step's generator, forward, BCE,
        backward and the update, in the phases and spans of Nef-Net's step.
        Returns (new bn_state, loss vector [1] on the device)."""
        with span("ecgpan.train_step"):
            with span("ecgpan.train_step.inputs"):
                data, label = self._tensors(batch, _CLASSIFY_KEYS)
                gen = torch.Generator(device=self.device).manual_seed(step_seed(self.cfg.seed, epoch, step))
                masks = self.model.draw_masks(gen, data.shape[0], data.shape[-1])
                opt.zero_grad(set_to_none=True)
            with self._precision():
                with span("ecgpan.train_step.forward"):
                    probs, new_bn = self.model.apply(params, bn_state, data, train=True, masks=masks)
                    loss = self.loss(probs, label)
                with span("ecgpan.train_step.backward"):
                    loss.backward()
            with span("ecgpan.train_step.update"):
                opt.step()
                new_bn = {k: v.detach() for k, v in new_bn.items()}
                lvec = loss.detach().float()[None]
        return new_bn, lvec

    @torch.no_grad()
    def _classify_eval_step(self, params: dict, bn_state: dict, batch: dict):
        """The classifier's eval (`eval_step` under a classifier definition), in
        Nef-Net's form: (scores [B, C], no rest views, losses [1] = BCE,
        metrics [3] = tp, fp, fn at a threshold of 0.5 for the epoch's
        micro-averaged F1, no per-lead metrics)."""
        data, label = self._tensors(batch, _CLASSIFY_KEYS)
        with full_f32():
            probs, _ = self.model.apply(params, bn_state, data)
            losses = self.loss(probs, label).float()[None]
        return probs, None, losses, M.multilabel_counts(probs, label), None

    # ------------------------------------------------------------ epoch loop
    def run_one_epoch(self, dl, phase: str, *, epoch: int, params, bn_state, opt=None):
        cfg = self.cfg
        losses, metrics_all, singlelead = [], [], []
        host_rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, epoch, 0x5EED if phase == "train" else 0xE7A1]))
        max_steps = cfg.TPU.steps_per_epoch or None
        n_views = 0
        for step_i, batch in enumerate(_waited(dl)):
            if max_steps and step_i >= max_steps:
                break
            if phase == "train":
                i1 = int(host_rng.integers(0, cfg.DATA.lead_num))
                i2 = int(host_rng.integers(0, cfg.DATA.lead_num))
                bn_state, lvec = self.train_step(params, bn_state, opt, epoch=epoch, step=step_i,
                                                 i1=i1, i2=i2, batch=batch)
                # losses stay on the device until the epoch ends: no
                # device-to-host sync per step
                losses.append(lvec)
            else:
                _, rest_out, lvec, met, single = self.eval_step(params, bn_state, batch)
                if rest_out is not None:  # a classifier renders no views
                    n_views += rest_out.shape[0] * rest_out.shape[1] * self.world
                losses.append(lvec)
                metrics_all.append(met)
                if single is not None and single.shape[0]:
                    singlelead.append(single)

        if not losses:
            # an empty epoch would report 0.0 for every loss and metric, as
            # when DATA.batch_size exceeds the split and drop_last takes all
            print(f"WARNING: epoch {epoch} ({phase}) produced 0 batches — is DATA.batch_size "
                  f"larger than the {phase} split (drop_last)?", flush=True)

        # one device-to-host sync for the whole epoch
        losses_np = torch.stack(losses).cpu().numpy() if losses else np.empty((0,))
        if phase == "train" and cfg.TPU.check_nans and losses:
            finite = np.isfinite(losses_np).all(axis=1)
            if not finite.all():
                bad = int(np.argmax(~finite))
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch} step {bad}: {losses_np[bad].tolist()} (resume "
                    f"from the last epoch checkpoint in {self.output_dir})")
        return {
            "losses": losses_np,
            "metrics": torch.stack(metrics_all).cpu().numpy() if metrics_all else None,
            "singlelead": torch.stack(singlelead).cpu().numpy() if singlelead else None,
            "bn_state": bn_state, "steps": len(losses), "views": n_views,
        }

    # ----------------------------------------------------------------- train
    def _acquire_run_lock(self):
        """Exclusive advisory lock on the run directory, taken by rank 0: two
        trainers on one output_dir would interleave epoch checkpoints and
        scalars.jsonl rows without an error. The file is opened without
        truncating and takes this process's pid only once the lock is held,
        so a refused trainer leaves the holder's pid line. The OS drops the
        lock on any exit."""
        import fcntl

        if not self.rank0:
            return None
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        path = os.path.join(self.cfg.output_dir, ".train.lock")
        f = open(path, "a")
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            f.close()
            raise RuntimeError(
                f"another trainer holds {path}: refusing to run two trainers on one output_dir "
                "(they interleave epoch checkpoints and scalars.jsonl rows); pick a different "
                "output_dir or stop the other run") from None
        f.truncate(0)
        f.write(f"pid {os.getpid()}\n")
        f.flush()
        return f

    def train(self, dl_train, dl_test):
        lock = self._acquire_run_lock()
        try:
            return self._train_locked(dl_train, dl_test)
        finally:
            if lock is not None:
                lock.close()  # closing the fd releases the flock

    def restore(self):
        """(params, bn_state, optimizer, start epoch, best score): a fresh
        init, or the checkpoint MODEL.resume names (which must exist), or the
        run directory's last one, whichever package wrote it."""
        params, bn_state, opt = self.init_state()
        loaded = CheckPointer(self.output_dir).load(self.cfg.MODEL.resume or None)
        if loaded is None:
            return params, bn_state, opt, 0, self.model.score_floor
        lp, ls, opt_loaded, extras = loaded
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(lp[k])
        bn_state = {k: ls[k].to(self.device, v.dtype) for k, v in bn_state.items()}
        if opt_loaded is not None:
            load_state_by_key(opt, params, opt_loaded)
        start_epoch = int(extras["epoch"]) + 1 if "epoch" in extras else 0
        score = self.model.score
        best = float(extras.get(f"best_test_{score}", 0.0))
        print(f"resumed from epoch {start_epoch}, best_test_{score} {best:.6f}")
        return params, bn_state, opt, start_epoch, best

    def _train_locked(self, dl_train, dl_test):
        cfg = self.cfg
        params, bn_state, opt, start_epoch, best = self.restore()
        ckpt = CheckPointer(self.output_dir)
        # scalars.jsonl stays one clean run: drop rows from the first epoch
        # this process writes on
        self.writer.prune_from(start_epoch)
        score, widths = self.model.score, self.model.loss_widths

        profile_dir = cfg.TPU.profile_dir
        for epoch in range(start_epoch, cfg.SOLVER.epochs):
            print(f"---------------------------------{self.desc}---{epoch}-------------------------------------")
            set_lr(opt, lr_for_epoch(cfg, epoch))
            if hasattr(dl_train, "set_epoch"):
                dl_train.set_epoch(epoch)
            prof = self._start_profile(profile_dir) if profile_dir and epoch == start_epoch else None
            t0 = time.perf_counter()
            tr = self.run_one_epoch(dl_train, "train", epoch=epoch, params=params, bn_state=bn_state, opt=opt)
            t1 = time.perf_counter()
            bn_state = tr["bn_state"]
            if prof is not None:
                self._stop_profile(prof, profile_dir)
            if hasattr(dl_test, "set_epoch"):
                # the eval beats of epoch e are drawn alike with or without a
                # resume before it (a fresh run's test loader is at e anyway)
                dl_test.set_epoch(epoch)
            te = self.run_one_epoch(dl_test, "test", epoch=epoch, params=params, bn_state=bn_state)
            t2 = time.perf_counter()

            trm = tr["losses"].mean(axis=0) if len(tr["losses"]) else np.zeros(widths[0])
            tem = te["losses"].mean(axis=0) if len(te["losses"]) else np.zeros(widths[1])
            scalars, record, line = self.model.epoch_scalars(trm, tem, te)
            self.history[epoch] = {"train_losses": tr["losses"], "train_s": t1 - t0, "train_steps": tr["steps"],
                                   "eval_s": t2 - t1, "eval_views": te["views"], "scalars": scalars}
            if self.desc != "debug":
                self.writer.write(scalars, epoch)
            print(f"Epoch {epoch}: train_loss: {trm[0]:.6f}, test_loss: {tem[0]:.6f} ({t2 - t0:.1f}s)")
            print(line)

            # best_test_<score> rides in every epoch checkpoint, so a resume
            # from a non-best epoch keeps the best tracking (solver.py:105-116)
            is_best = record[score] > best
            if is_best:
                best = record[score]
            extras = {**record, "epoch": epoch, f"best_test_{score}": best}
            if self.rank0:  # the replicas hold one model
                opt_saved = state_by_key(opt, params)
                ckpt.save(f"epoch_{epoch}", params=params, bn_state=bn_state, opt_state=opt_saved, **extras)
                if is_best:
                    ckpt.save("best_valid", params=params, bn_state=bn_state, opt_state=opt_saved, **extras)
        return {k: v.detach() for k, v in params.items()}, bn_state

    def _start_profile(self, profile_dir: str):
        """A torch.profiler trace of the first epoch's train steps, with the
        program's spans (utils/profiling.py) recorded while it runs; best
        effort, as in the JAX package."""
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            profiling.reset()
            prof.__enter__()
            return prof
        except Exception as e:  # noqa: BLE001 — profiling is best effort
            print(f"profiler unavailable: {e}")
            return None

    def _stop_profile(self, prof, profile_dir: str) -> None:
        """Writes train_trace.json with the spans merged in on their threads,
        prints each span's calls, host ms and self ms a call, and empties the
        recorder."""
        try:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, "train_trace.json")
            prof.export_chrome_trace(path)
            snap = profiling.snapshot()
            profiling.merge_chrome_trace(path, snap["spans"])
            print(f"profiler trace written to {path}")
            for line in profiling.summary_lines(snap):
                print(line)
        except Exception as e:  # noqa: BLE001 — profiling is best effort
            print(f"profiler trace not written: {e}")
        finally:
            profiling.reset()

    # ------------------------------------------------------------------- val
    def val(self, dl_test, epoch: int = -1):
        ckpt = CheckPointer(self.output_dir)
        loaded = ckpt.load(best_valid=True) if epoch == -1 else ckpt.load(ckpt.epoch_path(epoch))
        if loaded is None:
            raise FileNotFoundError(f"no checkpoint found under {self.output_dir}")
        params, bn_state, _, extras = loaded
        score = self.model.score
        print("the latest best_test_{} is {:06f} of epoch {}".format(
            score, float(extras.get(f"best_test_{score}", 0.0)), extras.get("epoch", 0)))
        params = {k: v.to(self.device) for k, v in params.items()}
        bn_state = {k: v.to(self.device) for k, v in bn_state.items()}
        te = self.run_one_epoch(dl_test, "test", epoch=0, params=params, bn_state=bn_state)
        if te["metrics"] is None:
            raise RuntimeError("the test split produced no batch (DATA.batch_size, drop_last)")
        out, line = self.model.val_summary(te)
        print(line)
        return out

    # ----------------------------------------------------------------- paint
    def paint(self, target, pred, input_data=None, epoch=None, flag="train"):
        """Waveform-grid PNG dumps (reference solver.py:247-277), one
        `{epoch}_{flag}/{i}.png` per sample; rank 0 only."""
        if not self.rank0:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out_dir = os.path.join(self.output_dir, f"{epoch}_{flag}")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(target)):
            tgt = np.atleast_2d(target[i])
            prd = np.atleast_2d(pred[i])
            rows = tgt.shape[0] + (len(input_data[i]) if input_data is not None else 0)
            fig, axes = plt.subplots(rows, 1, figsize=(16, 2 * rows), squeeze=False)
            r = 0
            for j in range(tgt.shape[0]):
                axes[r][0].plot(tgt[j])
                axes[r][0].plot(prd[j], color="orange")
                r += 1
            if input_data is not None:
                for j in range(len(input_data[i])):
                    axes[r][0].plot(input_data[i][j])
                    r += 1
            fig.savefig(os.path.join(out_dir, f"{i}.png"), format="png")
            plt.close(fig)

    def paint_for_other_method(self, target, pred, input_data=None, epoch=None, flag="train"):
        """Side-by-side target/pred grid (reference solver.py:279-302):
        target/pred [B, R, 512], one row per view, target left, pred right;
        rank 0 only. The reference's `paint_for_mit` (solver.py:304-327) is
        the same function, so both names share it."""
        if not self.rank0:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out_dir = os.path.join(self.output_dir, f"{epoch}_{flag}")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(target)):
            rows = target[i].shape[0]
            fig, axes = plt.subplots(rows, 2, figsize=(32, 3 * rows), squeeze=False)
            for ind in range(rows):
                axes[ind][0].plot(target[i][ind])
                axes[ind][1].plot(pred[i][ind])
            fig.savefig(os.path.join(out_dir, f"{i}.png"), format="png")
            plt.close(fig)

    paint_for_mit = paint_for_other_method
