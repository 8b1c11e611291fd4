"""Intra-op threads of the port's tests under pytest-xdist.

The suite runs in worker processes on one machine (``-n 6``), and PyTorch
starts one intra-op thread per core in each: six workers' products then
fight over the cores, and every port test slows by its share of that
contention. Importing this module caps a worker at ``WORKER_THREADS``
(two beat one and the default on an 8-core machine); a run without
xdist keeps PyTorch's default. Every worker collects every test module
before it runs any, so the cap holds for all of a worker's tests.
"""

import os

import torch

#: Intra-op threads a pytest-xdist worker keeps.
WORKER_THREADS = 2

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(min(WORKER_THREADS, torch.get_num_threads()))
