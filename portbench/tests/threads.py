"""Pins torch to one CPU thread in every process a benchmark test runs
torch in (set where the caller has not): the test command runs several
workers side by side, and a torch thread pool as wide as the host in
each of them oversubscribes the CPUs.  Every test file here imports it
first; pytest does not collect it."""
import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(int(os.environ.get("MKL_NUM_THREADS")
                          or os.environ["OMP_NUM_THREADS"]))
try:
    torch.set_num_interop_threads(torch.get_num_threads())
except RuntimeError:        # the inter-op pool has already started
    pass
