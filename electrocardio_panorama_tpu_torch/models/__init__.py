"""Model registry (reference codes/network/__init__.py:7-24)."""

from functools import partial

import numpy as np
import torch

from electrocardio_panorama_tpu_torch.models.blocks import DROPOUT_RATE
from electrocardio_panorama_tpu_torch.models.losses import bce, l1, loss_wrapper, mse, mse_per_lead
from electrocardio_panorama_tpu_torch.models.nefnet import (
    NefNet,
    NefNetLatents,
    decode_views,
    decoder_apply,
    encode_latents,
    gen_ecg,
    init_nefnet,
    nefnet_apply,
    query_gates,
)
from electrocardio_panorama_tpu_torch.models.nefnet2 import (
    NefNet2,
    draw_masks as nefnet2_draw_masks,
    encode_latents2,
    init_nefnet2,
    nefnet2_apply,
)
from electrocardio_panorama_tpu_torch.models.resnet1d import init_resnet1d, mask_shapes, resnet1d_apply, resnet1d_plan
from electrocardio_panorama_tpu_torch.models.stmem import init_stmem, stmem_apply, stmem_meta
from electrocardio_panorama_tpu_torch.ops import GraphedTrain, dropout_mask
from electrocardio_panorama_tpu_torch.ops.kernels.encoder_fused import draw_masks as fused_draw_masks, make_fused_encode_fn
from electrocardio_panorama_tpu_torch.training.metrics import micro_f1

__all__ = [
    "build_model",
    "build_loss",
    "NefNet",
    "NefNetDef",
    "NefNetLatents",
    "NefNet2",
    "NefNet2Def",
    "ResNet1dDef",
    "STMEMViTDef",
    "ViewSynthesis",
    "init_nefnet2",
    "nefnet2_apply",
    "encode_latents2",
    "init_nefnet",
    "nefnet_apply",
    "encode_latents",
    "decoder_apply",
    "decode_views",
    "query_gates",
    "gen_ecg",
    "loss_wrapper",
    "l1",
    "mse",
    "mse_per_lead",
    "bce",
]


class ViewSynthesis:
    """What the Solver asks of a Nef-Net-family definition besides its steps:
    the loss vectors' widths (train, eval), the test metric that picks the
    best epoch and its value before any epoch, an epoch's scalars and the
    val summary (reference solver.py:105-116)."""

    classifier = False
    loss_widths = (4, 5)
    score, score_floor = "psnr_gen", 0.0

    def graphed_encode(self, *, mesh: bool):
        """The train step's eager encode replayed from CUDA graphs, where
        the definition has one (`encode_fn` of its apply); None."""
        return None

    @staticmethod
    def check_knobs(cfg) -> None:
        """Every knob of check_ported_knobs applies."""

    @staticmethod
    def epoch_scalars(trm, tem, te) -> tuple[dict, dict, str]:
        """(scalars, the checkpoint's metric extras, the printed line) of an
        epoch from the mean train and test loss vectors and the test epoch."""
        met = te["metrics"].mean(axis=0) if te["metrics"] is not None else np.zeros(4)
        psnr_gen, psnr_reg, ssim_gen, ssim_reg = (float(v) for v in met)
        scalars = {
            "train_loss_all": trm[0], "test_loss_all": tem[0],
            "train_loss_1": trm[1], "test_loss_1": tem[1],
            "train_loss_2": trm[2], "test_loss_2": tem[2],
            "train_3": trm[3], "test_3": tem[3], "test_unsuperv": tem[4],
            "psnr_gen": psnr_gen, "psnr_reg": psnr_reg, "ssim_gen": ssim_gen, "ssim_reg": ssim_reg,
        }
        if te["singlelead"] is not None:
            sl = te["singlelead"].mean(axis=0)  # [gen_num, 2]
            for i in range(sl.shape[0]):
                scalars[f"psnr_reg_lead_{i}"] = sl[i, 0]
                scalars[f"ssim_reg_lead_{i}"] = sl[i, 1]
        line = f"psnr_gen: {psnr_gen}, psnr_reg: {psnr_reg}, ssim_gen:{ssim_gen}, ssim_reg:{ssim_reg}"
        return scalars, {"psnr_gen": psnr_gen, "psnr_reg": psnr_reg}, line

    @staticmethod
    def val_summary(te) -> tuple[dict, str]:
        """(val's result, its printed line) from a test epoch."""
        met = te["metrics"].mean(axis=0)
        return ({"psnr_gen": met[0], "psnr_reg": met[1], "ssim_gen": met[2], "ssim_reg": met[3]},
                "psnr_gen:{}, psnr_reg:{}, ssim_gen:{}, ssim_reg:{}".format(*met))


class NefNetDef(ViewSynthesis):
    """Bound model definition: init/apply/encode/decode over static config."""

    def __init__(self, lead_num: int, theta_encoder_len: int = 1, dtype=torch.float32):
        self.lead_num = lead_num
        self.theta_encoder_len = theta_encoder_len
        self.dtype = dtype
        self.init = partial(init_nefnet, lead_num=lead_num,
                            theta_encoder_len=theta_encoder_len, dtype=dtype)
        self.apply = partial(nefnet_apply, lead_num=lead_num, theta_encoder_len=theta_encoder_len)
        self.encode = partial(encode_latents, lead_num=lead_num,
                              theta_encoder_len=theta_encoder_len)
        self.decode_views = partial(decode_views, theta_encoder_len=theta_encoder_len)
        self.gen_ecg = partial(gen_ecg, lead_num=lead_num, theta_encoder_len=theta_encoder_len)
        self.draw_masks = partial(fused_draw_masks, L=lead_num)  # the eager encoder takes them too

    def fused_encode(self, *, ckpt="tower", plain: bool = False):
        """`encode` through A2 (eval) or A2/A3 (train; `ckpt`, what A3
        recomputes) on a CUDA tensor, their plain version on the CPU or under
        `plain` (ops/kernels/encoder_fused.py::make_fused_encode_fn): the
        Solver's train and eval encoders and the render's encode."""
        return make_fused_encode_fn(self.lead_num, self.theta_encoder_len, ckpt=ckpt, plain=plain)


class NefNet2Def(ViewSynthesis):
    """Bound Nef-Net2 definition (the shared single-lead tower)."""

    # A2 computes Nef-Net's lead-grouped chain, not the shared tower and its
    # single_conv_z1/z2: Nef-Net2 encodes eagerly (its train step from CUDA
    # graphs of the eager encode, graphed_encode)
    fused_encode = None

    def __init__(self, lead_num: int, theta_encoder_len: int = 1, dtype=torch.float32):
        self.lead_num = lead_num
        self.theta_encoder_len = theta_encoder_len
        self.dtype = dtype
        self.init = partial(init_nefnet2, lead_num=lead_num,
                            theta_encoder_len=theta_encoder_len, dtype=dtype)
        self.apply = partial(nefnet2_apply, lead_num=lead_num, theta_encoder_len=theta_encoder_len)
        self.decode_views = partial(decode_views, theta_encoder_len=theta_encoder_len)
        self.draw_masks = partial(nefnet2_draw_masks, lead_num=lead_num)

    def graphed_encode(self, *, mesh: bool):
        """The Solver's train encode (`encode_fn` of nefnet2_apply): a train
        encode with masks on CUDA tensors runs encode_latents2 and its
        gradient from two CUDA graphs (ops.GraphedTrain: the first such call
        is the eager warm-up, the second captures; a batch of other shapes
        or dtype runs eagerly), except under a device `mesh`, where it runs
        eagerly; the eval encode and every encode of CPU tensors are
        encode_latents2's own."""
        encode = partial(encode_latents2, lead_num=self.lead_num, theta_encoder_len=self.theta_encoder_len)

        def train_encode(p, x, input_thetas, rois, *masks):
            return encode(p, x, input_thetas, rois, masks=masks, train=True)

        graphed = GraphedTrain(train_encode, eager="mesh" if mesh else None)

        def fn(p, x, input_thetas, rois, *, masks=None, train=False):
            if train and masks is not None:
                return graphed(p, x, input_thetas, rois, *masks)
            return encode(p, x, input_thetas, rois, masks=masks, train=train)

        return fn

    @staticmethod
    def check_knobs(cfg) -> None:
        """A fused encoder raises: there is none for Nef-Net2."""
        for knob in ("train_encoder", "eval_encoder"):
            if cfg.TPU[knob] == "fused":
                raise ValueError(
                    f"TPU.{knob}='fused' supports model_nefnet only: kernels A2/A3 compute Nef-Net's "
                    "encoder, one private tower per lead through conv groups and lead-grouped "
                    "z-blocks; Nef-Net2 folds the leads into the batch through one shared tower "
                    "and adds the single_conv_z1/z2 convs, another function (use 'xla')")

    def encode(self, params, x, input_thetas, rois, *, masks=None, train=False,
               stop_before_reverse=False) -> NefNetLatents:
        """Nef-Net's encode contract, so the render path and the Solver's
        eval take Nef-Net2 too: z1, z2 [B, 128L, 128] per lead, their means
        and latent_all."""
        if stop_before_reverse:
            raise NotImplementedError(
                "Nef-Net2 has no pre-reverse latent export (the reference's "
                "phase='gen' returns post-reverse lead means); use "
                "model_nefnet for the latent-prior/synthesis workflow")
        z1, z2 = encode_latents2(params, x, input_thetas, rois, lead_num=self.lead_num,
                                 theta_encoder_len=self.theta_encoder_len, masks=masks, train=train)
        B = x.shape[0]
        z1_mean, z2_mean = z1.mean(dim=1), z2.mean(dim=1)
        return NefNetLatents(z1.reshape(B, -1, z1.shape[-1]), z2.reshape(B, -1, z2.shape[-1]),
                             z1_mean, z2_mean, torch.cat([z1_mean, z2_mean], dim=1))

    def gen_ecg(self, *args, **kwargs):
        raise NotImplementedError(
            "Nef-Net2's gen_ecg is inconsistent dead code in the reference "
            "(model_nefnet2.py:205-218 expects pre-reverse grids that its own "
            "gen phase never produces); use model_nefnet for synthesis")


class MultiLabelClassifier:
    """What the Solver asks of a multi-label classifier definition besides
    its forward: records [B, in_channel, T] -> sigmoid scores [B,
    num_classes]. The Solver takes the classifier's steps for it
    (`classifier`); its eval reads the BCE and the micro-averaged F1 at 0.5,
    and the best epoch is the one of the highest test F1. `name` is the
    model's MODEL.model and `eager_what` what runs eagerly in it, for the
    errors of `check_knobs`."""

    classifier = True
    fused_encode = None
    loss_widths = (1, 1)
    # F1 reads 0 until a score passes 0.5, and the first epoch is still the best so far
    score, score_floor = "f1", -float("inf")
    name = eager_what = ""

    def check_knobs(self, cfg) -> None:
        """What the classifier's step does not take raises, naming why."""
        for knob in ("train_encoder", "eval_encoder", "train_decoder"):
            if cfg.TPU[knob] == "fused":
                raise ValueError(
                    f"TPU.{knob}='fused' does not apply to {self.name}: kernels A2/A3 and A4f/A4b compute "
                    f"Nef-Net's encoder and decoder; {self.eager_what} runs eagerly (use 'xla')")
        if list(cfg.TPU.mesh_shape):
            raise NotImplementedError(
                f"TPU.mesh_shape under {self.name}: the data-parallel classifier is not ported yet "
                "(ROADMAP.md Queue F); train it on one device (TPU.mesh_shape [])")
        if cfg.TPU.compute_dtype != "float32":
            raise NotImplementedError(
                f"TPU.compute_dtype {cfg.TPU.compute_dtype!r} under {self.name}: only float32 is ported "
                "(the bfloat16 classifier is open in ROADMAP.md Queue F)")

    @staticmethod
    def epoch_scalars(trm, tem, te) -> tuple[dict, dict, str]:
        """The BCEs and the test split's micro-averaged F1 over the epoch's
        summed [tp, fp, fn]."""
        f1 = float(micro_f1(te["metrics"].sum(axis=0))) if te["metrics"] is not None else 0.0
        return {"train_loss_all": trm[0], "test_loss_all": tem[0], "f1": f1}, {"f1": f1}, f"f1: {f1}"

    @staticmethod
    def val_summary(te) -> tuple[dict, str]:
        out = {"loss": float(te["losses"].mean()), "f1": float(micro_f1(te["metrics"].sum(axis=0)))}
        return out, "loss:{}, f1:{}".format(out["loss"], out["f1"])


class ResNet1dDef(MultiLabelClassifier):
    """Bound 1-D ResNet classifier (models/resnet1d.py; the reference's
    resnet_1d.py). The layer plan is fixed here, at the reference's 64 stem
    channels unless a test narrows it; `init` returns (params, state) as the
    Nef-Net definitions do."""

    name, eager_what = "model_resnet1d", "the classifier's Bottleneck tower"

    def __init__(self, arch: str, in_channel: int, num_classes: int, lead_num: int = 1, dtype=torch.float32, *,
                 init_channels: int = 64):
        self.arch, self.in_channel, self.num_classes = arch, in_channel, num_classes
        self.lead_num, self.init_channels, self.dtype = lead_num, init_channels, dtype
        self.meta = resnet1d_plan(arch, lead_num=lead_num, init_channels=init_channels)

    def init(self, generator: torch.Generator, device="cpu"):
        params, state, _ = init_resnet1d(generator, self.arch, in_channel=self.in_channel,
                                         num_classes=self.num_classes, lead_num=self.lead_num,
                                         init_channels=self.init_channels, dtype=self.dtype, device=device)
        return params, state

    def apply(self, params, state, x, *, train: bool = False, masks=None):
        """(scores [B, num_classes], BN state updates; empty at eval)."""
        return resnet1d_apply(params, state, self.meta, x, train=train, masks=masks)

    def draw_masks(self, gen: torch.Generator, batch: int, length: int, dtype=torch.float32) -> list:
        """The step's pre-scaled dropout masks, one per block in block order
        (resnet1d.mask_shapes), drawn from `gen` in that order."""
        return [dropout_mask(shape, DROPOUT_RATE, gen, dtype=dtype)
                for shape in mask_shapes(self.meta, batch, length)]


class STMEMViTDef(MultiLabelClassifier):
    """Bound ST-MEM ViT classifier (models/stmem.py; ST-MEM's
    st_mem_vit.py): records [B, num_leads, seq_len] cut into patches, both
    sizes MODEL.arch's (vit_base: 2,250 samples, patches of 75). No BatchNorm
    (the state is empty) and no dropout (no masks). `widths` overrides
    MODEL.arch's sizes (a test's narrow encoder)."""

    name, eager_what = "model_st_mem_vit", "the ViT's blocks"

    def __init__(self, arch: str, num_leads: int, num_classes: int, dtype=torch.float32, **widths):
        self.num_classes, self.dtype = num_classes, dtype
        self.meta = stmem_meta(arch, num_leads=num_leads, num_classes=num_classes, **widths)

    def init(self, generator: torch.Generator, device="cpu"):
        return init_stmem(generator, self.meta, dtype=self.dtype, device=device), {}

    def apply(self, params, state, x, *, train: bool = False, masks=None):
        """(scores [B, num_classes], no state updates)."""
        return stmem_apply(params, self.meta, x), {}

    def draw_masks(self, gen: torch.Generator, batch: int, length: int, dtype=torch.float32) -> list:
        """No masks: every dropout of the source is 0."""
        return []


def build_model(cfg):
    """'model_nefnet' as the reference registers it (network/__init__.py:7-12);
    'model_nefnet2' as the JAX package registers it besides (the reference
    defines Model_nefnet2 but never registers it); 'model_resnet1d', the
    reference's 1-D ResNet classifier (network/encoder/resnet_1d.py, which
    its registry never names), at MODEL.arch; 'model_st_mem_vit', ST-MEM's
    ViT encoder with a linear head (MODEL.arch 'vit_base'), fine-tuned as a
    multi-label classifier."""
    dtype = getattr(torch, cfg.TPU.param_dtype) if "TPU" in cfg else torch.float32
    if cfg.MODEL.model == "model_nefnet":
        return NefNetDef(cfg.DATA.lead_num, cfg.MODEL.theta_L, dtype)
    if cfg.MODEL.model == "model_nefnet2":
        return NefNet2Def(cfg.DATA.lead_num, cfg.MODEL.theta_L, dtype)
    if cfg.MODEL.model == "model_resnet1d":
        return ResNet1dDef(cfg.MODEL.arch, cfg.DATA.in_channel, cfg.MODEL.num_classes, cfg.DATA.lead_num, dtype)
    if cfg.MODEL.model == "model_st_mem_vit":
        return STMEMViTDef(cfg.MODEL.arch, cfg.DATA.in_channel, cfg.MODEL.num_classes, dtype)
    raise ValueError(
        "build model: model name error "
        f"(MODEL.model={cfg.MODEL.model!r}; registered: 'model_nefnet', "
        "'model_nefnet2', 'model_resnet1d', 'model_st_mem_vit' — the default config ships with the reference's "
        "unregistered 'modelv2', so set MODEL.model in your yml or overrides)"
    )


def build_loss(cfg):
    """Loss registry (reference network/__init__.py:15-24), plus 'bce', the
    classifier's."""
    if cfg.MODEL.loss == "v1":
        return loss_wrapper
    if cfg.MODEL.loss == "mse":
        return lambda pred, target, *a, **k: mse(pred, target)
    if cfg.MODEL.loss == "bce":
        return bce
    raise ValueError("build loss: loss name error")
