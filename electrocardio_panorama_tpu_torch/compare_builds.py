"""Hold the fused encoder of this checkout against another checkout's, bit for bit.

    python -m electrocardio_panorama_tpu_torch.compare_builds OTHER_ROOT [--dtype bfloat16 float32]

Runs kernels A2 and A3 (`encoder_ckpt` tower) once at B=32, L=3 on the
seeded inputs of `profile_encoder.inputs`, with this checkout's package and
with the package under OTHER_ROOT (for example a parent commit unpacked with
`git archive`; it needs `profile_encoder.inputs`), each in a process of its
own, and prints per dtype one JSON line: how many of the forward planes and
gradients are bitwise equal, which differ, and their largest difference.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dump(root: str, dtype: str, out: str) -> None:
    """Save every forward plane and gradient of one A2 + A3 run with the
    package under `root` to `out`."""
    sys.path.insert(0, root)
    from electrocardio_panorama_tpu_torch import profile_encoder as PE
    from electrocardio_panorama_tpu_torch.ops.kernels import encoder_fused as a2

    if not os.path.abspath(a2.__file__).startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"imported {a2.__file__}, not the package under {root}")
    t = PE.inputs(32, getattr(torch, dtype), torch.device("cuda"))
    args = (t["w"], t["x"], t["gate"], t["ramp"], t["masks"])
    planes = a2.forward_cuda(*args, lead_num=PE.LEADS)
    kept = {n: planes[n] for n in a2._KEEP["tower"]}
    grads = a2.backward_cuda(*args, kept, t["dz1"], t["dz2"], lead_num=PE.LEADS, mode="tower")
    torch.save({**{f"plane {n}": v.cpu() for n, v in planes.items()},
                **{f"grad {n}": g.cpu() for n, g in zip(["gate", *a2.WEIGHT_KEYS.values()], grads)}}, out)


def compare(a: dict, b: dict) -> dict:
    """Tensors of two dumps: how many are bitwise equal, which differ, and the
    largest absolute difference among those."""
    if a.keys() != b.keys():
        raise ValueError(f"the dumps hold other tensors: {sorted(set(a) ^ set(b))}")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    return {"tensors": len(a), "bitwise_equal": len(a) - len(differ), "differ": differ,
            "max_abs_diff": max((float((a[k].double() - b[k].double()).abs().max()) for k in differ), default=0.0)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="root of the other checkout (holds electrocardio_panorama_tpu_torch/)")
    p.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"], choices=["float32", "bfloat16"])
    p.add_argument("--dump", nargs=2, metavar=("DTYPE", "OUT"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dump:
        dump(args.other, *args.dump)
        return
    if not torch.cuda.is_available():
        raise SystemExit("compare_builds needs a CUDA device: the kernels have no CPU mode")
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in args.dtype:
            dumps = {}
            for label, root in (("this", HERE), ("other", os.path.abspath(args.other))):
                out = os.path.join(tmp, f"{label}_{dtype}.pt")
                subprocess.run([sys.executable, os.path.abspath(__file__), root, "--dump", dtype, out], check=True)
                dumps[label] = torch.load(out)
            print(json.dumps({"dtype": dtype, "this": HERE, "other": os.path.abspath(args.other),
                              **compare(dumps["this"], dumps["other"])}), flush=True)


if __name__ == "__main__":
    main()
