"""Bounds of the program's hand-written kernels at the shapes a cell runs,
each counted on the function the kernel computes: the operations of that
function (taps over zero padding included, as the kernels run them) and the
bytes of the inputs it needs and the outputs it returns, each read or written
once. What one implementation keeps between a forward and its backward (A2's
tower planes, A4f's planes for A4b) is not counted. Frozen from the program's
chip_smoke.py (CONV1_MACS, TAIL_MACS, a1_bound_ms, encoder_convs,
encoder_bound_ms, the A4 bounds), with A4f's and A4b's kept planes taken out.

Each `*_work` returns (operations, bytes) of one launch and `bound_of(kernel,
...)` its least seconds (counts/peaks.py).
"""

from __future__ import annotations

from portbench.counts.peaks import bound_s

ITEMSIZE = {"float32": 4, "bfloat16": 2}

# decoder multiply-adds per view (or per train sample): conv1 on the upsampled
# gated latent, and conv2..conv5, every tap
CONV1_MACS = 128 * 256 * 3 * 256
TAIL_MACS = 128 * 128 * 3 * 256 + 64 * 128 * 3 * 512 + 64 * 64 * 3 * 512 + 64 * 3 * 512
TAIL_WEIGHTS = 3 * (128 * 128 + 64 * 128 + 64 * 64 + 64)   # w2..w5
TAIL_BIASES = 128 + 64 + 64 + 1
DECODER_WEIGHTS = 3 * 128 * 256 + TAIL_WEIGHTS
DECODER_F32 = 128 + TAIL_BIASES + 2 * (128 + 128 + 64 + 64)  # biases, BN scales and offsets


def a1_work(beats: int, views: int, dtype: str, j: int = 13) -> tuple[float, float]:
    """A1, one launch over beats x views: the view mix of the J basis
    planes and conv2..conv5 + sigmoid of every view. Reads the basis planes
    U [beats, J, 128, 256] (storage dtype), the mix coefficients
    [beats, views, J] (float32) and the tail's weights; writes [beats, views,
    512] float32."""
    n = beats * views
    flops = 2.0 * (j * 128 * 256 + TAIL_MACS) * n
    sz = ITEMSIZE[dtype]
    n_bytes = (beats * j * 128 * 256 * sz + n * j * 4 + TAIL_WEIGHTS * sz + (128 + TAIL_BIASES) * 4
               + n * 512 * 4)
    return flops, n_bytes


def encoder_convs(lead_num: int) -> list[tuple[int, int, int, int]]:
    """(output channels, input channels per output, taps, output steps) of
    every convolution in the A2 chain, per beat."""
    C, Cz, Ch = 128 * lead_num, 896 * lead_num, 448 * lead_num
    zblock = [(C, 64, 3, 128), (C, 128, 3, 128), (C, 64, 1, 128)]
    return ([(C, 1, 15, 256)] + [(C, 128, 7, 128)] * 6 + [(C, 128, 3, 128)] * 2 + zblock * 2
            + [(Cz, 128, 3, 16)] * 2 + [(Ch, 128, 1, 32)]
            + [(Cz, 64, 3, 32), (Cz, 128, 3, 32), (Cz, 64, 1, 32)])


def encoder_weights(lead_num: int) -> int:
    """Elements of the weights A2 reads (the program's encoder_fused
    WEIGHT_KEYS): every conv of the chain and the three residual biases and
    the transposed conv's bias."""
    C, Cz = 128 * lead_num, 896 * lead_num
    convs = encoder_convs(lead_num)
    weights = sum(co * ci * k for co, ci, k, _ in convs)
    return weights + C + C + Cz + Cz // 2  # z1/z2 residual, z2_conv2.2 residual, convT biases


def _encoder_io(batch: int, lead_num: int, train: bool) -> int:
    """Elements of A2's inputs but the weights (x, gate, ramp, and in the
    train form the dropout masks) and of its outputs (z1, the z2 grid)."""
    C, Cz = 128 * lead_num, 896 * lead_num
    ins = batch * (lead_num * 512 + lead_num * 128 + 7 * 16)
    if train:
        ins += 6 * batch * C * 128 + batch * Cz * (16 + 32)
    return ins + batch * (C * 128 + Cz * 32)


def encoder_forward_flops(batch: int, lead_num: int) -> float:
    return 2.0 * batch * sum(co * ci * k * t for co, ci, k, t in encoder_convs(lead_num))


def a2_work(batch: int, lead_num: int, dtype: str) -> tuple[float, float]:
    """A2 in its train form, one launch: every conv of the encode chain.
    Reads x, the gate, the ROI ramp, the dropout masks and the weights, and
    writes z1 and the z2 grid, all in the storage dtype."""
    sz = ITEMSIZE[dtype]
    n_bytes = sz * (_encoder_io(batch, lead_num, True) + encoder_weights(lead_num))
    return encoder_forward_flops(batch, lead_num), n_bytes


def a3_work(batch: int, lead_num: int, dtype: str) -> tuple[float, float]:
    """A3, one launch: every data gradient but the input's and every weight
    gradient of the chain. Reads what A2 reads and the two output gradients,
    and writes float32 weight and gate gradients."""
    co, ci, k, t = encoder_convs(lead_num)[0]
    flops = 2.0 * encoder_forward_flops(batch, lead_num) - 2.0 * batch * co * ci * k * t
    sz = ITEMSIZE[dtype]
    n_bytes = (sz * (_encoder_io(batch, lead_num, True) + encoder_weights(lead_num))
               + 4 * (encoder_weights(lead_num) + batch * lead_num * 128))
    return flops, n_bytes


def a4f_work(nb: int, dtype: str, groups: int = 3) -> tuple[float, float]:
    """A4f, one launch over `groups` decodes of nb samples: the decoder's
    convs. Reads x [G, 256, nb*128] and the weights, and writes the output
    [G, nb, 512] float32 and the moments [G, 4, 128] (mean and variance)
    float32; the planes it keeps for A4b are not counted."""
    sz = ITEMSIZE[dtype]
    flops = 2.0 * (CONV1_MACS + TAIL_MACS) * groups * nb
    n_bytes = (groups * 256 * nb * 128 * sz + DECODER_WEIGHTS * sz + DECODER_F32 * 4
               + groups * nb * 512 * 4 + 2 * groups * 4 * 128 * 4)
    return flops, n_bytes


def a4b_work(nb: int, dtype: str, groups: int = 3) -> tuple[float, float]:
    """A4b, one launch: every data and weight gradient of the decoder,
    twice A4f's operations. Reads x, the output's gradient [G, nb, 512]
    float32 and the weights, and writes dx (storage dtype) and float32
    weight gradients; the planes A4f kept are not counted."""
    sz = ITEMSIZE[dtype]
    flops = 4.0 * (CONV1_MACS + TAIL_MACS) * groups * nb
    x = groups * 256 * nb * 128
    n_bytes = (2 * x * sz + groups * nb * 512 * 4 + DECODER_WEIGHTS * sz + DECODER_F32 * 4
               + (DECODER_WEIGHTS + DECODER_F32) * 4)
    return flops, n_bytes


WORK = {"a1": a1_work, "a2": a2_work, "a3": a3_work, "a4f": a4f_work, "a4b": a4b_work}


def bound_of(kernel: str, *shape, dtype: str) -> float:
    """Least seconds of one launch of `kernel` at `shape`."""
    return bound_s(*WORK[kernel](*shape, dtype), dtype)
