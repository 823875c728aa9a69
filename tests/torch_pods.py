"""Pod functions for `compat.run_pods` tests (`tests/test_torch_migrate.py`).

A spawned pod imports the module that holds its function. These live
here, apart from the test modules, so that a pod imports only `time`,
`torch` and `repro_torch.compat` and meets its deadline even when the
host is busy with a full parallel test run.
"""
import time

import torch

from repro_torch import compat


def _failing_pod(rank, n_pods):
    if rank == 1:
        raise ValueError("pod one gives up")
    compat.ppermute(torch.ones(3), 1)       # the others wait on pod 1


def _sleeping_pod(rank, n_pods):
    time.sleep(120)
