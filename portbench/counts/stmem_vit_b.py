"""ST-MEM ViT-B's operation counts, by hand from its shapes (ST-MEM's
st_mem_vit.py, `st_mem_vit_base`: the patch embedding, 12 pre-norm blocks of
width 768 with 12 heads of 64 and an MLP of 3,072 over 384 tokens, the
linear head), over counts/convs.py's layer list. LayerNorm, GELU, the
softmax, the embeddings' sums, the pooling, the sigmoid, the loss and Adam
are elementwise and left out, as convs.py says.

At the published sizes (12 leads x 2,250 samples, patch 75, 55 labels) a
record's forward is 70.71 GFLOP, 5.44 of it attention's q kᵀ and its product
with v, and a train step at batch 128 is 27.15 TFLOP: every matmul three
times but the patch embedding, whose input takes no gradient.
"""

from __future__ import annotations

from portbench.counts.convs import Layer, step_flops

SIZES = {"width": 768, "depth": 12, "heads": 12, "dim_head": 64, "mlp_dim": 3072, "patch": 75, "leads": 12,
         "samples": 2250, "num_classes": 55}


def _sizes(sizes: dict) -> dict:
    out = {**SIZES, **sizes}
    out["n"] = out["samples"] // out["patch"]
    out["tokens"] = out["leads"] * (out["n"] + 2)
    return out


def attention_layers(**sizes) -> list[Layer]:
    """q kᵀ and its product with v of every block, per record."""
    s = _sizes(sizes)
    macs = s["heads"] * s["tokens"] * s["tokens"] * s["dim_head"]
    return [Layer(macs, "beat", True, True)] * (2 * s["depth"])


def layers(**sizes) -> list[Layer]:
    """Every matmul of one record's forward, in order."""
    s = _sizes(sizes)
    w, inner, N = s["width"], s["heads"] * s["dim_head"], s["tokens"]
    out = [Layer(s["leads"] * s["n"] * s["patch"] * w, "beat", False, True)]  # the patch embedding
    qk_av = attention_layers(**sizes)[:2]
    for _ in range(s["depth"]):
        out += ([Layer(N * w * 3 * inner, "beat", True, True)] + qk_av
                + [Layer(N * inner * w, "beat", True, True), Layer(N * w * s["mlp_dim"], "beat", True, True),
                   Layer(N * s["mlp_dim"] * w, "beat", True, True)])
    out.append(Layer(w * s["num_classes"], "beat", True, True))  # the head
    return out


def forward_flops(batch: int, **sizes) -> float:
    """The forward of `batch` records (stmem_forward_roofline's count)."""
    return step_flops(layers(**sizes), batch, 1, backward=False)


def train_step_flops(batch: int, lead_num: int = 1, backward: bool = True, **sizes) -> float:
    """One train step at `batch` records: the forward and every data and
    weight gradient (train_mfu's count). `lead_num` is the harness's
    argument and is not read: the leads are part of the tokens."""
    return step_flops(layers(**sizes), batch, 1, backward)


def attention_flops(batch: int, **sizes) -> float:
    """The forward's q kᵀ and products with v, over `batch` records
    (stmem_attention_roofline's operations)."""
    return step_flops(attention_layers(**sizes), batch, 1, backward=False)


def attention_bytes(batch: int, dtype_bytes: int = 4, **sizes) -> float:
    """The forward attention's least traffic over `batch` records: q, k and
    v read once and the output written once, in every block."""
    s = _sizes(sizes)
    return float(4 * batch * s["heads"] * s["tokens"] * s["dim_head"] * dtype_bytes * s["depth"])
