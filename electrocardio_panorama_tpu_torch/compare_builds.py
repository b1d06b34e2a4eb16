"""Hold the fused kernels of this checkout against another checkout's, bit for bit.

    python -m electrocardio_panorama_tpu_torch.compare_builds OTHER_ROOT [--dtype bfloat16 float32]

Runs, with this checkout's package and with the package under OTHER_ROOT
(for example a parent commit unpacked with `git archive`; it needs
`profile_encoder.inputs`), each in a process of its own:
  * kernels A2 and A3 (`encoder_ckpt` tower) once at B=32, L=3 on the seeded
    inputs of `profile_encoder.inputs`: 55 forward planes and gradients;
  * kernels A4f and A4b (the fused train decoder) through the autograd path,
    `train_decode_groups(w, x)` then `out.backward(dout)`, at 3 groups of 32
    on inputs made here from a seed: out, mean, var, dx and the 18 parameter
    gradients;
  * kernel A4b alone (`backward_cuda`) on one set of planes, the ones the
    other checkout's A4f fills on the same inputs: dx and the 18 parameter
    gradients ("A4b on shared planes"), which stay bitwise equal while A4b's
    code does, whatever A4f does.
Prints per dtype and kernel family one JSON line: how many tensors are
bitwise equal, which differ, and their largest difference; which tensors
this checkout's kernels are meant to change against the other's
(`EXPECTED_TO_DIFFER`), and whether exactly those differ. In float32 it then
prints how far each checkout's A4 out, moments and gradients lie from a
float64 pass of this checkout's plain version on the same inputs.

With --time it then times A4f and A4b at 3 groups of 32 in each checkout,
in turns (other, this, this, other), each in a process of its own, and
prints one JSON line per run and dtype: ms per launch (CUDA events) of A4f,
of A4b as the trainer runs it (on A4f's kept planes where the checkout's
`backward_cuda` takes them, else recomputing the forward) and of the pair,
and the device ms by kernel of one A4f and of one A4b launch
(`torch.profiler`). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel families of a dump, by key prefix
FAMILIES = {"A2/A3": ("plane ", "grad "), "A4": ("A4 ",), "A4b on shared planes": ("A4b ",)}
# dx and the 18 parameter gradients of an A4 run (decoder_train.WNAMES order)
A4_GRADS = ["dx", "w1", "b1", "g1", "o1", "w2", "b2", "g2", "o2", "w3", "b3", "g3", "o3", "w4", "b4", "g4", "o4",
            "w5", "b5"]
# A4f's conv kernels in any checkout: the SIMT one of earlier checkouts, the
# float32 FMA engine's, the bfloat16 tensor-core engine's
A4F_CONV_KERNELS = ("conv3_kernel", "conv_fwd_kernel_fma", "conv_fwd_kernel_tc")
# (dtype, family) -> the tensors that this checkout's kernels change against
# the parent's; every other tensor must stay bitwise equal. This checkout
# moves bfloat16 A4f's conv stages to the tensor-core engine (another order
# of the float32 sums): its out and moments move, and so does every gradient
# of the A4 run, whose A4b reads the planes that A4f filled. A4b on shared
# planes, A2/A3 and every float32 tensor stay the parent's.
EXPECTED_TO_DIFFER: dict[tuple[str, str], list[str]] = {
    ("bfloat16", "A4"): ["A4 out", "A4 mean", "A4 var", *(f"A4 grad {k}" for k in A4_GRADS)],
}


def a4_inputs(dtype: str, dev, nb: int = 32):
    """(w, x, dout) of one A4 call at 3 groups of nb, from a seed alone:
    conv weights scaled to unit gain, non-trivial BN affines, x and the
    cotangent dout."""
    rng = np.random.default_rng(10)
    sd = getattr(torch, dtype)
    w = {}
    for i, (co, ci) in enumerate(((128, 256), (128, 128), (64, 128), (64, 64), (1, 64)), start=1):
        w[f"w{i}"] = torch.tensor(rng.normal(0, (3 * ci) ** -0.5, (3, co, ci)), dtype=torch.float32).to(dev, sd)
        w[f"b{i}"] = torch.tensor(rng.normal(0, 0.05, co), dtype=torch.float32, device=dev)
        if i < 5:
            w[f"g{i}"] = torch.tensor(1 + rng.normal(0, 0.2, co), dtype=torch.float32, device=dev)
            w[f"o{i}"] = torch.tensor(rng.normal(0, 0.2, co), dtype=torch.float32, device=dev)
    x = torch.tensor(rng.normal(0, 0.5, (3, 256, nb * 128)), dtype=torch.float32).to(dev, sd)
    dout = torch.tensor(rng.normal(0, 1, (3, nb, 512)), dtype=torch.float32, device=dev)
    return w, x, dout


def a4_dump(a4, dtype: str, dev, nb: int = 32) -> dict:
    """out, mean, var, dx and the 18 parameter gradients of one run of the
    `decoder_train` module `a4` through its autograd path, at 3 groups of nb,
    on `a4_inputs`."""
    w, x, dout = a4_inputs(dtype, dev, nb)
    w = {k: v.requires_grad_(True) for k, v in w.items()}
    x.requires_grad_(True)
    out, mean, var = a4.train_decode_groups(w, x)
    out.backward(dout)
    return {"A4 out": out.detach(), "A4 mean": mean, "A4 var": var, "A4 grad dx": x.grad,
            **{f"A4 grad {k}": v.grad for k, v in w.items()}}


def a4b_shared_dump(a4, dtype: str, dev, planes_file: str, nb: int = 32) -> dict:
    """dx and the 18 parameter gradients of one A4b launch of the
    `decoder_train` module `a4` on `a4_inputs` and the planes saved in
    `planes_file`; where that file does not exist yet, `a4`'s A4f fills the
    planes first and saves them there."""
    w, x, dout = a4_inputs(dtype, dev, nb)
    if not os.path.exists(planes_file):
        torch.save({k: v.cpu() for k, v in a4.forward_cuda(w, x).items()}, planes_file)
    planes = {k: v.to(dev) for k, v in torch.load(planes_file).items()}
    return {f"A4b grad {k}": g for k, g in zip(A4_GRADS, a4.backward_cuda(w, x, dout, planes), strict=True)}


def a4_float64_truth(dev, nb: int = 32) -> dict:
    """out, mean, var, dx and the 18 parameter gradients of `a4_dump`'s
    float32 run, computed by this checkout's plain version in float64."""
    sys.path.insert(0, HERE)
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as a4

    w, x, dout = a4_inputs("float32", dev, nb)
    w = {k: v.requires_grad_(True) for k, v in w.items()}
    x.requires_grad_(True)
    out, mean, var = a4.train_decode_groups_plain(w, x, float64=True)
    out.backward(dout.double())
    return {"A4 out": out.detach(), "A4 mean": mean, "A4 var": var, "A4 grad dx": x.grad,
            **{f"A4 grad {k}": v.grad for k, v in w.items()}}


def float64_distance(d: dict, truth: dict) -> dict:
    """A float32 A4 dump against `a4_float64_truth`: out's and the moments'
    largest absolute difference, whether the moments lie within 1e-5 of it
    (relative and absolute: the moments bar of PERF.md section 2), and the
    gradients' worst L2 relative distance (the conv biases before a BN,
    rounding noise on every side, left out)."""
    noise = {f"A4 grad b{i}" for i in range(1, 5)}
    l2 = {k: float((d[k].double() - truth[k].double()).norm() / truth[k].double().norm().clamp_min(1e-30))
          for k in truth if k.startswith("A4 grad") and k not in noise}
    worst = max(l2, key=l2.get)
    moments = ("A4 mean", "A4 var")
    return {"out_max_abs": float((d["A4 out"].double() - truth["A4 out"].double()).abs().max()),
            "moments_max_abs": max(float((d[k].double() - truth[k].double()).abs().max()) for k in moments),
            "moments_within_1e-5": all(torch.allclose(d[k].double(), truth[k].double(), rtol=1e-5, atol=1e-5)
                                       for k in moments),
            "worst_grad": worst, "worst_grad_l2": l2[worst]}


def dump(root: str, dtype: str, out: str, planes_file: str) -> None:
    """Save every forward plane and gradient of one A2 + A3 run, one A4f +
    A4b run, and one A4b launch on the planes in `planes_file`
    (`a4b_shared_dump`) with the package under `root` to `out`."""
    sys.path.insert(0, root)
    from electrocardio_panorama_tpu_torch import profile_encoder as PE
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as a4
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2

    for mod in (a2, a4):
        if not os.path.abspath(mod.__file__).startswith(os.path.abspath(root) + os.sep):
            raise SystemExit(f"imported {mod.__file__}, not the package under {root}")
    t = PE.inputs(32, getattr(torch, dtype), torch.device("cuda"))
    args = (t["w"], t["x"], t["gate"], t["ramp"], t["masks"])
    planes = a2.forward_cuda(*args, lead_num=PE.LEADS)
    kept = {n: planes[n] for n in a2._KEEP["tower"]}
    grads = a2.backward_cuda(*args, kept, t["dz1"], t["dz2"], lead_num=PE.LEADS, mode="tower")
    dec = a4_dump(a4, dtype, torch.device("cuda"))
    dec.update(a4b_shared_dump(a4, dtype, torch.device("cuda"), planes_file))
    torch.save({**{f"plane {n}": v.cpu() for n, v in planes.items()},
                **{f"grad {n}": g.cpu() for n, g in zip(["gate", *a2.WEIGHT_KEYS.values()], grads)},
                **{k: v.cpu() for k, v in dec.items()}}, out)


def a4_times(root: str, dtypes: list[str]) -> None:
    """Print one JSON line per dtype: ms per launch of A4f, A4b and the pair
    with the package under `root`, and A4f's and A4b's device ms by kernel
    (A4f's conv stages, conv3_kernel, conv_fwd_kernel_fma or
    conv_fwd_kernel_tc, also summed)."""
    sys.path.insert(0, root)
    from electrocardio_panorama_tpu_torch.ops.kernels import decoder_train as a4
    from electrocardio_panorama_tpu_torch.profile_encoder import cuda_ms
    from electrocardio_panorama_tpu_torch.utils.profiling import device_window

    if not os.path.abspath(a4.__file__).startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"imported {a4.__file__}, not the package under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    kept = "planes" in inspect.signature(a4.backward_cuda).parameters
    dev = torch.device("cuda")
    for dtype in dtypes:
        w, x, dout = a4_inputs(dtype, dev)
        # the trainer's A4b reads the planes its A4f kept; without them it
        # recomputes the forward (and then backward_cuda alone is the pair)
        planes = (a4.forward_cuda(w, x),) if kept else ()

        def bwd():
            return a4.backward_cuda(w, x, dout, *planes)

        def pair():
            return a4.backward_cuda(w, x, dout) if kept else (a4.forward_cuda(w, x), a4.backward_cuda(w, x, dout))

        rec = {"root": root, "dtype": dtype, "groups": 3, "nb": 32, "a4b_on_kept_planes": kept,
               "a4f_ms": cuda_ms(lambda: a4.forward_cuda(w, x), reps=20), "a4b_ms": cuda_ms(bwd, reps=20),
               "pair_ms": cuda_ms(pair, reps=20)}
        fwin = device_window(lambda: [a4.forward_cuda(w, x) for _ in range(5)], 5, top=16)
        rec.update(a4f_device_ms_by_kernel=fwin["by_kernel"], a4f_device_kernel_sum_ms=fwin["kernel_sum_ms"],
                   a4f_device_busy_ms=fwin["busy_ms"],
                   a4f_conv_device_ms=sum(v for k, v in fwin["by_kernel"].items()
                                          if any(c in k for c in A4F_CONV_KERNELS)))
        win = device_window(lambda: [bwd() for _ in range(5)], 5, top=16)
        rec.update(a4b_device_ms_by_kernel=win["by_kernel"], a4b_device_kernel_sum_ms=win["kernel_sum_ms"],
                   a4b_device_busy_ms=win["busy_ms"], card=card)
        print(json.dumps(rec), flush=True)


def compare(a: dict, b: dict) -> dict:
    """Tensors of two dumps: how many are bitwise equal, which differ, and the
    largest absolute difference among those."""
    if a.keys() != b.keys():
        raise ValueError(f"the dumps hold other tensors: {sorted(set(a) ^ set(b))}")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    return {"tensors": len(a), "bitwise_equal": len(a) - len(differ), "differ": differ,
            "max_abs_diff": max((float((a[k].double() - b[k].double()).abs().max()) for k in differ), default=0.0)}


def against_expectation(result: dict, dtype: str, family: str) -> dict:
    """`result` of `compare` with the tensors expected to differ for this
    (dtype, family) and whether exactly those differ."""
    expected = EXPECTED_TO_DIFFER.get((dtype, family), [])
    return {**result, "expected_to_differ": expected, "as_expected": sorted(result["differ"]) == sorted(expected)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="root of the other checkout (holds electrocardio_panorama_tpu_torch/)")
    p.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"], choices=["float32", "bfloat16"])
    p.add_argument("--time", action="store_true", help="then time A4f and A4b in both checkouts, in turns")
    p.add_argument("--dump", nargs=3, metavar=("DTYPE", "OUT", "PLANES"), help=argparse.SUPPRESS)
    p.add_argument("--times", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dump:
        dump(args.other, *args.dump)
        return
    if args.times:
        a4_times(args.other, args.dtype)
        return
    if not torch.cuda.is_available():
        raise SystemExit("compare_builds needs a CUDA device: the kernels have no CPU mode")
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in args.dtype:
            dumps = {}
            # the other checkout runs first: its A4f fills the shared planes
            shared = os.path.join(tmp, f"planes_{dtype}.pt")
            for label, root in (("other", os.path.abspath(args.other)), ("this", HERE)):
                out = os.path.join(tmp, f"{label}_{dtype}.pt")
                subprocess.run([sys.executable, os.path.abspath(__file__), root, "--dump", dtype, out, shared],
                               check=True)
                dumps[label] = torch.load(out)
            for family, prefixes in FAMILIES.items():
                a, b = ({k: v for k, v in d.items() if k.startswith(prefixes)} for d in dumps.values())
                print(json.dumps({"dtype": dtype, "kernels": family, "this": HERE, "other": os.path.abspath(args.other),
                                  **against_expectation(compare(a, b), dtype, family)}), flush=True)
            if dtype == "float32":
                truth = {k: v.cpu() for k, v in a4_float64_truth(torch.device("cuda")).items()}
                print(json.dumps({"dtype": dtype, "kernels": "A4", "distance_from_float64": {
                    label: float64_distance(d, truth) for label, d in dumps.items()}}), flush=True)
    if args.time:
        other = os.path.abspath(args.other)
        for root in (other, HERE, HERE, other):
            subprocess.run([sys.executable, os.path.abspath(__file__), root, "--times", "--dtype", *args.dtype],
                           check=True)


if __name__ == "__main__":
    main()
