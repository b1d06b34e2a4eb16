"""Model registry (reference codes/network/__init__.py:7-24)."""

from functools import partial

import torch

from electrocardio_panorama_tpu_torch.models.losses import l1, loss_wrapper, mse, mse_per_lead
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
from electrocardio_panorama_tpu_torch.ops.kernels.encoder_fused import make_fused_encode_fn

__all__ = [
    "build_model",
    "build_loss",
    "NefNet",
    "NefNetDef",
    "NefNetLatents",
    "NefNet2",
    "NefNet2Def",
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
]


class NefNetDef:
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

    def fused_encode(self, *, plain: bool = False):
        """`encode` through the fused encoder A2 in eval form: kernel A2 on a
        CUDA tensor (`plain=True`: its plain version), the plain version on
        the CPU; the mlp1 gate, ROI ramp, roi_reverse and lead means stay
        plain around it (ops/kernels/encoder_fused.py::make_fused_encode_fn)."""
        return make_fused_encode_fn(self.lead_num, self.theta_encoder_len, plain=plain)


class NefNet2Def:
    """Bound Nef-Net2 definition (the shared single-lead tower)."""

    # A2 computes Nef-Net's lead-grouped chain, not the shared tower and its
    # single_conv_z1/z2: Nef-Net2 always encodes eagerly
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


def build_model(cfg):
    """'model_nefnet' as the reference registers it (network/__init__.py:7-12);
    'model_nefnet2' as the JAX package registers it besides (the reference
    defines Model_nefnet2 but never registers it)."""
    dtype = getattr(torch, cfg.TPU.param_dtype) if "TPU" in cfg else torch.float32
    if cfg.MODEL.model == "model_nefnet":
        return NefNetDef(cfg.DATA.lead_num, cfg.MODEL.theta_L, dtype)
    if cfg.MODEL.model == "model_nefnet2":
        return NefNet2Def(cfg.DATA.lead_num, cfg.MODEL.theta_L, dtype)
    raise ValueError(
        "build model: model name error "
        f"(MODEL.model={cfg.MODEL.model!r}; registered: 'model_nefnet', "
        "'model_nefnet2' — the default config ships with the reference's "
        "unregistered 'modelv2', so set MODEL.model in your yml or overrides)"
    )


def build_loss(cfg):
    """Loss registry (reference network/__init__.py:15-24)."""
    if cfg.MODEL.loss == "v1":
        return loss_wrapper
    if cfg.MODEL.loss == "mse":
        return lambda pred, target, *a, **k: mse(pred, target)
    raise ValueError("build loss: loss name error")
