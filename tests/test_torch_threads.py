"""The thread cap of the port's tests.

The tests run on several xdist workers at once on one host, and torch's
intra-op pool would start as many threads as there are cores in every
worker. Importing this module caps the pool at the worker's share of the
cores (all of them where the tests run in one process); every port test file
imports it, and a subprocess a test starts gets the same cap through
OMP_NUM_THREADS (`subprocess_env`). The cap changes how many threads compute,
not what: no input and no tolerance depends on it.
"""
import os
import subprocess
import sys

import torch

THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)


def subprocess_env() -> dict:
    """This process's environment with the cap set for a child's torch."""
    return {**os.environ, "OMP_NUM_THREADS": str(THREADS)}


def test_torch_threads_are_capped_at_the_workers_share_of_the_cores():
    assert torch.get_num_threads() == THREADS


def test_a_subprocess_gets_the_same_cap():
    proc = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) == THREADS
