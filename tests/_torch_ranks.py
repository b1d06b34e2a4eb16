"""Start N gloo ranks of a child script as torchrun would, for the port's
multi-process CPU tests (tests/test_torch_parallel.py,
tests/test_torch_lead_parallel.py)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import pytest
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(child: str, n: int, *args: str) -> list[subprocess.Popen]:
    """n ranks of `child` with RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT /
    LOCAL_RANK set, two threads each."""
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": str(n),
           "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return [subprocess.Popen([sys.executable, child, *args], cwd=REPO, text=True,
                             env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]


def wait_ranks(procs: list[subprocess.Popen], deadline: float, timeout_s: float) -> list[str]:
    """Every rank's output; fails with all of it if a rank exits non-zero,
    prints no CHILD_OK, or the deadline (time.monotonic) passes."""
    outs = {}
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for r, p in enumerate(procs):
            outs.setdefault(r, p.communicate()[0])
        pytest.fail(f"the ranks did not finish within {timeout_s} s:\n"
                    + "\n".join(f"--- rank {r}\n{outs[r][-3000:]}" for r in outs))
    for r, p in enumerate(procs):
        assert p.returncode == 0 and "CHILD_OK" in outs[r], f"rank {r} failed:\n{outs[r][-4000:]}"
    return [outs[r] for r in range(len(procs))]


def run_ranks(child: str, n: int, *args: str, timeout_s: float = 150) -> list[str]:
    """n ranks of `child`, waited for under one deadline."""
    procs = start_ranks(child, n, *args)
    return wait_ranks(procs, time.monotonic() + timeout_s, timeout_s)


@pytest.fixture
def no_group():
    """Each test starts and ends without a process group in this process."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
