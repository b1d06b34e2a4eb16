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

__all__ = [
    "build_model",
    "build_loss",
    "NefNet",
    "NefNetDef",
    "NefNetLatents",
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


def build_model(cfg):
    """'model_nefnet' as the reference registers it (network/__init__.py:7-12)."""
    dtype = getattr(torch, cfg.TPU.param_dtype) if "TPU" in cfg else torch.float32
    if cfg.MODEL.model == "model_nefnet":
        return NefNetDef(cfg.DATA.lead_num, cfg.MODEL.theta_L, dtype)
    if cfg.MODEL.model == "model_nefnet2":
        raise NotImplementedError(
            "model_nefnet2 is not ported yet: ROADMAP.md Queue A item 8 "
            "('Synthesis from scratch and variants')")
    raise ValueError(
        "build model: model name error "
        f"(MODEL.model={cfg.MODEL.model!r}; registered: 'model_nefnet' — the "
        "default config ships with the reference's unregistered 'modelv2', so "
        "set MODEL.model in your yml or overrides)"
    )


def build_loss(cfg):
    """Loss registry (reference network/__init__.py:15-24)."""
    if cfg.MODEL.loss == "v1":
        return loss_wrapper
    if cfg.MODEL.loss == "mse":
        return lambda pred, target, *a, **k: mse(pred, target)
    raise ValueError("build loss: loss name error")
