"""ST-MEM's ViT encoder with a linear multi-label head (Na et al., ICLR 2024,
arXiv:2402.09450; github.com/bakqui/ST-MEM, models/encoder/st_mem_vit.py,
`st_mem_vit_base`), the fine-tuned classifier, in the port's functional form.

A record x [B, L, T] of L leads is cut into n = T / patch patches a lead:

  * embedding: t[l, j] = W_e p[l, j] + b_e + pos[j] for the patches j = 1..n,
    a SEP token at each end of the lead (sep + pos[0], sep + pos[n + 1]),
    lead[l] added to every token of lead l, the leads concatenated into
    N = L (n + 2) tokens;
  * each of `depth` pre-norm blocks: h = x + W_o attn(LN1(x)) + b_o, with
    q, k, v from W_qkv LN1(x) + b_qkv split into `heads` heads of `dim_head`
    and attn = softmax(q kᵀ / sqrt(dim_head)) v; then
    x' = h + W_2 GELU(W_1 LN2(h) + b_1) + b_2, GELU the exact erf form;
  * head: the SEP tokens dropped, the mean over the patch tokens, LayerNorm,
    Linear to the classes, sigmoid.

Dropout, attention dropout and drop-path are 0, the source class's defaults,
so a train step has no masks. LayerNorm eps is 1e-5 (nn.LayerNorm's).

Parameters are a flat dict under the source's state_dict keys
(`param_shapes`): to_patch_embedding.1, pos_embedding [1, n + 2, width],
sep_embedding, lead_embeddings.<l>, block<i>.attn.norm, block<i>.attn.fn.to_qkv,
block<i>.attn.fn.to_out.0, block<i>.ff.norm, block<i>.ff.fn.net.0 / .net.3,
norm and head. `init_stmem` draws Linear layers at torch's default, the
embeddings normal(0, 0.02), LayerNorm affines 1 and 0; the published model
starts a fine-tune from pretrained weights instead.

The forward records the span ecgpan.stmem.forward with the children
ecgpan.stmem.embed, .blocks and .head, and in every block
ecgpan.stmem.attention (q kᵀ, the softmax and the product with v, without
the projections) and ecgpan.stmem.mlp, each with the input's device
(utils/profiling.py: they record only under a profiler session or
`recording()`).
"""

from __future__ import annotations

import torch

from electrocardio_panorama_tpu_torch.models import init as inits
from electrocardio_panorama_tpu_torch.ops import gelu, layer_norm, linear
from electrocardio_panorama_tpu_torch.ops.attention import attention
from electrocardio_panorama_tpu_torch.utils.profiling import span

# MODEL.arch -> the encoder's widths and input: samples a lead (9 s at 250 Hz)
# and samples a patch, as ST-MEM fine-tunes it
VIT_ARCHS = {
    "vit_base": {"width": 768, "depth": 12, "heads": 12, "dim_head": 64, "mlp_dim": 3072, "seq_len": 2250,
                 "patch": 75},
}
EMBED_STD = 0.02


def stmem_meta(arch: str = "vit_base", *, num_leads: int = 12, num_classes: int = 55, **widths) -> dict:
    """The static shape of one encoder: `arch`'s widths and input, any of
    them overridden by `widths`, the leads and the classes."""
    if arch not in VIT_ARCHS:
        raise ValueError(f"MODEL.arch {arch!r} under model_st_mem_vit: registered {sorted(VIT_ARCHS)}")
    meta = {**VIT_ARCHS[arch], **widths, "num_leads": num_leads, "num_classes": num_classes}
    if meta["seq_len"] % meta["patch"]:
        raise ValueError(f"{meta['seq_len']} samples a lead is not a multiple of the patch, {meta['patch']}")
    return {**meta, "num_patches": meta["seq_len"] // meta["patch"]}


def param_shapes(meta: dict) -> dict[str, tuple]:
    """{state_dict key: shape} in the source's order."""
    w, inner, mlp = meta["width"], meta["heads"] * meta["dim_head"], meta["mlp_dim"]
    out = {"to_patch_embedding.1.weight": (w, meta["patch"]), "to_patch_embedding.1.bias": (w,),
           "pos_embedding": (1, meta["num_patches"] + 2, w), "sep_embedding": (w,)}
    out.update({f"lead_embeddings.{i}": (w,) for i in range(meta["num_leads"])})
    for i in range(meta["depth"]):
        b = f"block{i}"
        out.update({f"{b}.attn.norm.weight": (w,), f"{b}.attn.norm.bias": (w,),
                    f"{b}.attn.fn.to_qkv.weight": (3 * inner, w), f"{b}.attn.fn.to_qkv.bias": (3 * inner,),
                    f"{b}.attn.fn.to_out.0.weight": (w, inner), f"{b}.attn.fn.to_out.0.bias": (w,),
                    f"{b}.ff.norm.weight": (w,), f"{b}.ff.norm.bias": (w,),
                    f"{b}.ff.fn.net.0.weight": (mlp, w), f"{b}.ff.fn.net.0.bias": (mlp,),
                    f"{b}.ff.fn.net.3.weight": (w, mlp), f"{b}.ff.fn.net.3.bias": (w,)})
    out.update({"norm.weight": (w,), "norm.bias": (w,), "head.weight": (meta["num_classes"], w),
                "head.bias": (meta["num_classes"],)})
    return out


def init_stmem(generator: torch.Generator, meta: dict, *, dtype=torch.float32, device="cpu") -> dict:
    """Parameters drawn from `generator` (a CPU generator) in `param_shapes`'
    order, moved to `device`."""
    params = {}
    for name, shape in param_shapes(meta).items():
        t = torch.empty(shape)
        if name.endswith("embedding") or name.startswith("lead_embeddings."):
            t.normal_(0.0, EMBED_STD, generator=generator)
        elif "norm." in name:
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("weight"):
            inits.uniform_(t, shape[1] ** -0.5, generator)
        else:
            inits.uniform_(t, params[name[: -len("bias")] + "weight"].shape[1] ** -0.5, generator)
        params[name] = t
    return {k: v.to(device=device, dtype=dtype) for k, v in params.items()}


def embed(p: dict, meta: dict, x):
    """x [B, L, T] -> tokens [B, L (n + 2), width]."""
    B, L, _ = x.shape
    n, w = meta["num_patches"], meta["width"]
    pos = p["pos_embedding"][0]
    tokens = linear(x.reshape(B, L, n, meta["patch"]), p["to_patch_embedding.1.weight"],
                    p["to_patch_embedding.1.bias"]) + pos[1:n + 1]
    sep = p["sep_embedding"].expand(B, L, 1, w)
    tokens = torch.cat([sep + pos[:1], tokens, sep + pos[n + 1:]], dim=2)
    lead = torch.stack([p[f"lead_embeddings.{i}"] for i in range(L)])
    return (tokens + lead[None, :, None, :]).reshape(B, L * (n + 2), w)


def block(p: dict, meta: dict, i: int, x):
    """One pre-norm transformer block on tokens [B, N, width]."""
    b, dev = f"block{i}", x.device
    B, N, _ = x.shape
    H, D = meta["heads"], meta["dim_head"]
    qkv = linear(layer_norm(x, p[f"{b}.attn.norm.weight"], p[f"{b}.attn.norm.bias"]),
                 p[f"{b}.attn.fn.to_qkv.weight"], p[f"{b}.attn.fn.to_qkv.bias"])
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    with span("ecgpan.stmem.attention", device=dev):
        a = attention(q, k, v, D ** -0.5)
    h = x + linear(a.transpose(1, 2).reshape(B, N, H * D), p[f"{b}.attn.fn.to_out.0.weight"],
                   p[f"{b}.attn.fn.to_out.0.bias"])
    with span("ecgpan.stmem.mlp", device=dev):
        u = gelu(linear(layer_norm(h, p[f"{b}.ff.norm.weight"], p[f"{b}.ff.norm.bias"]),
                        p[f"{b}.ff.fn.net.0.weight"], p[f"{b}.ff.fn.net.0.bias"]))
        return h + linear(u, p[f"{b}.ff.fn.net.3.weight"], p[f"{b}.ff.fn.net.3.bias"])


def stmem_apply(params: dict, meta: dict, x):
    """x [B, L, T] -> sigmoid multi-label scores [B, num_classes]."""
    p, dev = params, x.device
    B, L, T = x.shape
    if (L, T) != (meta["num_leads"], meta["seq_len"]):
        raise ValueError(f"records of {L} leads x {T} samples under model_st_mem_vit: the encoder takes "
                         f"{meta['num_leads']} x {meta['seq_len']} (DATA.in_channel, DATA.cls_input '12lead_250hz')")
    with span("ecgpan.stmem.forward", device=dev):
        with span("ecgpan.stmem.embed", device=dev):
            h = embed(p, meta, x)
        with span("ecgpan.stmem.blocks", device=dev):
            for i in range(meta["depth"]):
                h = block(p, meta, i, h)
        with span("ecgpan.stmem.head", device=dev):
            pooled = h.reshape(B, L, meta["num_patches"] + 2, meta["width"])[:, :, 1:-1].mean(dim=(1, 2))
            pooled = layer_norm(pooled, p["norm.weight"], p["norm.bias"])
            return torch.sigmoid(linear(pooled, p["head.weight"], p["head.bias"]))
