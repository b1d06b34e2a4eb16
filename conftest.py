"""Loaded before tests/conftest.py, in the controller and in every xdist worker."""

import os

# Six workers times torch's default of one thread per core oversubscribe the
# cores: inside xdist, each worker gets its share of them.
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _share = str(max(1, len(os.sched_getaffinity(0)) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, _share)
