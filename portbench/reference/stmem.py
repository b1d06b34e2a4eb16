"""Plain ST-MEM ViT classifier in PyTorch, float32: the yardstick that decides
`correct` for the ViT's cells.

ST-MEM's encoder (Na et al., ICLR 2024, arXiv:2402.09450; github.com/bakqui/
ST-MEM, models/encoder/st_mem_vit.py, `st_mem_vit_base`) with its linear
head, written from its layer equations with `torch` and
`torch.nn.functional` alone: no kernel, no fused attention, no cache. It
imports nothing of the program, of JAX or of the JAX package, and runs its
matmuls at full float32 (TF32 off) unless asked for the TF32 control.

A record x of L leads x T samples is cut into n = T / patch patches a lead,
p[l, j] (j = 1..n):

  * embedding: t[l, j] = W_e p[l, j] + b_e + pos[j]; t[l, 0] = sep + pos[0]
    and t[l, n + 1] = sep + pos[n + 1], the SEP tokens at each end of the
    lead; lead[l] added to every token of lead l; the leads concatenated into
    N = L (n + 2) tokens;
  * each pre-norm block: h = x + W_o softmax(Q Kᵀ / sqrt(d)) V + b_o, with Q,
    K, V from W_qkv LN1(x) + b_qkv split into the heads (the first third of
    the projection is Q, head-major, then K, then V);
    x' = h + W_2 GELU(W_1 LN2(h) + b_1) + b_2, GELU the exact erf form and
    LN torch's LayerNorm (biased variance, eps 1e-5);
  * head: the 2L SEP tokens dropped, the mean over the L n patch tokens,
    LayerNorm, Linear to the classes, sigmoid;
  * Adam written out (lr, beta1 0.9, beta2 0.999, eps 1e-8): m = b1 m +
    (1 - b1) g, v = b2 v + (1 - b2) g², p -= lr m / (1 - b1^t) /
    (sqrt(v / (1 - b2^t)) + eps), t counting from 1.

Departures from the source, each as the program has them:
  * dropout, attention dropout and drop-path are 0, the source class's
    defaults, so a step draws nothing;
  * the loss is the mean binary cross-entropy of the sigmoid scores, each log
    clamped at -100 as torch's `binary_cross_entropy` clamps it;
  * the published fine-tuning steps AdamW; at weight decay 0 that is this
    Adam (no weight decay, no layer-wise learning-rate decay).

Weights are a flat {state_dict key: tensor} dict under the source's keys
(`param_table` gives names, shapes and the draws the benchmark makes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.resnet1d import bce, matmul_precision

LN_EPS = 1e-5
EMBED_STD = 0.02
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


class Arch:
    """The static shape of one encoder and its head."""

    def __init__(self, *, width: int = 768, depth: int = 12, heads: int = 12, dim_head: int = 64,
                 mlp_dim: int = 3072, patch: int = 75, leads: int = 12, samples: int = 2250, num_classes: int = 55):
        self.width, self.depth, self.heads, self.dim_head, self.mlp_dim = width, depth, heads, dim_head, mlp_dim
        self.patch, self.leads, self.samples, self.num_classes = patch, leads, samples, num_classes
        self.n = samples // patch
        self.tokens = leads * (self.n + 2)


# ------------------------------------------------------------------ parameters
def param_table(a: Arch) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter: init 'uniform' (bound
    scale, torch's Linear default 1/sqrt(fan_in)), 'normal' (std scale, the
    embeddings), 'ln_weight' or 'ln_bias'."""
    w, inner = a.width, a.heads * a.dim_head
    rows = []

    def linear(name, out, fan_in):
        rows.extend([(f"{name}.weight", (out, fan_in), "uniform", 1 / math.sqrt(fan_in)),
                     (f"{name}.bias", (out,), "uniform", 1 / math.sqrt(fan_in))])

    def ln(name):
        rows.extend([(f"{name}.weight", (w,), "ln_weight", 1.0), (f"{name}.bias", (w,), "ln_bias", 1.0)])

    linear("to_patch_embedding.1", w, a.patch)
    rows.append(("pos_embedding", (1, a.n + 2, w), "normal", EMBED_STD))
    rows.append(("sep_embedding", (w,), "normal", EMBED_STD))
    rows.extend((f"lead_embeddings.{i}", (w,), "normal", EMBED_STD) for i in range(a.leads))
    for i in range(a.depth):
        ln(f"block{i}.attn.norm")
        linear(f"block{i}.attn.fn.to_qkv", 3 * inner, w)
        linear(f"block{i}.attn.fn.to_out.0", w, inner)
        ln(f"block{i}.ff.norm")
        linear(f"block{i}.ff.fn.net.0", a.mlp_dim, w)
        linear(f"block{i}.ff.fn.net.3", w, a.mlp_dim)
    ln("norm")
    linear("head", a.num_classes, w)
    return rows


# ------------------------------------------------------------------ forward
def layer_norm(p, name, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def dense(p, name, x):
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def embed(a: Arch, p, x):
    """x [B, L, T] -> tokens [B, L (n + 2), width]."""
    B = x.shape[0]
    pos = p["pos_embedding"][0]                                          # [n + 2, w]
    patches = x[:, :, : a.n * a.patch].reshape(B, a.leads, a.n, a.patch)
    t = dense(p, "to_patch_embedding.1", patches) + pos[1:a.n + 1]       # [B, L, n, w]
    left = (p["sep_embedding"] + pos[0]).expand(B, a.leads, 1, a.width)
    right = (p["sep_embedding"] + pos[a.n + 1]).expand(B, a.leads, 1, a.width)
    t = torch.cat([left, t, right], dim=2)
    lead = torch.stack([p[f"lead_embeddings.{i}"] for i in range(a.leads)])   # [L, w]
    return (t + lead[None, :, None, :]).reshape(B, a.tokens, a.width)


def attention(a: Arch, p, name, x):
    B, N, _ = x.shape
    qkv = dense(p, f"{name}.to_qkv", x)
    q, k, v = (t.reshape(B, N, a.heads, a.dim_head).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    scores = (q @ k.transpose(-2, -1)) / math.sqrt(a.dim_head)
    out = torch.softmax(scores, dim=-1) @ v                              # [B, H, N, d]
    return dense(p, f"{name}.to_out.0", out.transpose(1, 2).reshape(B, N, a.heads * a.dim_head))


def forward(a: Arch, p, x):
    """x [B, L, T] -> sigmoid scores [B, num_classes]."""
    h = embed(a, p, x)
    for i in range(a.depth):
        b = f"block{i}"
        h = h + attention(a, p, f"{b}.attn.fn", layer_norm(p, f"{b}.attn.norm", h))
        u = F.gelu(dense(p, f"{b}.ff.fn.net.0", layer_norm(p, f"{b}.ff.norm", h)), approximate="none")
        h = h + dense(p, f"{b}.ff.fn.net.3", u)
    patches = h.reshape(x.shape[0], a.leads, a.n + 2, a.width)[:, :, 1:a.n + 1]
    pooled = layer_norm(p, "norm", patches.mean(dim=(1, 2)))
    return torch.sigmoid(dense(p, "head", pooled))


# ------------------------------------------------------------------ train step
def train_steps(a: Arch, params, batches, lr, *, tf32=False, beta1=BETAS[0], beta2=BETAS[1], eps=ADAM_EPS,
                weight_decay=0.0, rows=None, past_grads=()):
    """Run len(batches) Adam steps from `params`; a batch is {'data': [B, L,
    T], 'label': [B, C]} in the params' dtype. Returns {'losses': [steps,
    1], 'grads': {name: first step's gradient}, 'params': after the steps,
    'bn_state': {}} on the params' device; nothing of the inputs is modified.

    `past_grads`, the gradients of the steps before these (oldest first),
    restarts a run in the middle: Adam's moments and step count start as
    those gradients made them. `rows` keeps only each batch's first rows, and
    `weight_decay` adds weight_decay * p to each gradient before the moments
    (0 in every cell): faults that the comparison has to catch, as are a
    beta1 or lr other than the cell's."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first, t = [], None, 0

    def moments(k, g):
        m[k].mul_(beta1).add_((1 - beta1) * g)
        s[k].mul_(beta2).add_((1 - beta2) * g * g)

    for past in past_grads:
        t += 1
        for k, g in past.items():
            moments(k, g)
    with matmul_precision(tf32):
        for batch in batches:
            x, y = batch["data"], batch["label"]
            if rows is not None:
                x, y = x[:rows], y[:rows]
            loss = bce(forward(a, p, x), y)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(loss.detach()[None])
            t += 1
            with torch.no_grad():
                for (k, v), g in zip(p.items(), grads):
                    moments(k, g + weight_decay * v if weight_decay else g)
                    v.sub_(lr * (m[k] / (1 - beta1 ** t)) / (torch.sqrt(s[k] / (1 - beta2 ** t)) + eps))
            if first is None:
                first = {k: g.detach() for k, g in zip(p, grads)}
            del grads, loss
    return {"losses": torch.stack(losses), "grads": first, "params": {k: v.detach() for k, v in p.items()},
            "bn_state": {}}
