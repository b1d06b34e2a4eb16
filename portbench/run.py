"""The benchmark of electrocardio_panorama_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. Runs one cell of BENCHMARK.json on the
card(s) of this machine and prints, as the last line of standard output, one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`, with
--trace 1 `breakdown`, and last `check`, each compared number beside its
limit (also the last lines of standard error). Without a card, or with fewer
cards than the cell asks for, it exits with 2 and prints no result; if JAX or
the JAX package is loaded once the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "_portbench_cache")


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own CUDA libraries build into its `_build/`)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=[0, 1])
    args = p.parse_args(argv)
    pin_caches()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is False); nothing measured", file=sys.stderr)
        return 2
    chips = cell.workload["chips"]
    if torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)} (JAX or the JAX package); no result", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
