"""Builds the port's CUDA kernels at first use, from the sources in `csrc/`.

Each source compiles with `nvcc` for sm_90a into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by a
hash of the source and flags, in `electrocardio_panorama_tpu_torch/_build/`.
The library is loaded with ctypes. A missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from source at first use")


def library_path(name: str) -> str:
    """`_build/lib{name}-{hash}.so` for `csrc/{name}.cu`, the shared headers
    `csrc/*.cuh` and NVCC_FLAGS."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source not built yet, all nvcc processes at once.
    Returns {name: ptxas report} for the sources compiled in this call; the
    report also lands beside the library as `.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: library_path(n) for n in names if not os.path.exists(library_path(n))}
    procs = {}
    for n, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[n])  # atomic: concurrent builders never see a partial file
        with open(todo[n][:-3] + ".log", "w") as f:
            f.write(log)
        reports[n] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/{name}.cu`, building it first if needed."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(library_path(name))
    return _libs[name]
