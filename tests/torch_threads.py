"""Divide the host's cores among pytest-xdist's workers for torch's threads.

Every ``tests/test_torch_*.py`` imports this module before its first torch
work. Each xdist worker collects every file, so the cap holds before any test
of that worker runs. Without it, every worker runs torch's intra-op pool at
its default of one thread a core, and six workers on eight cores spin 48
threads that mostly wait on each other.

A run without xdist keeps torch's default, and so does a process whose
``OMP_NUM_THREADS`` is set: the worker subprocesses of
``test_torch_dp.py`` and ``test_torch_tp.py`` inherit the xdist variables
and keep the two threads their parent gives them.
"""

import os

import torch

if "PYTEST_XDIST_WORKER_COUNT" in os.environ and "OMP_NUM_THREADS" not in os.environ:
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
