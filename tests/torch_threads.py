"""Pins torch's CPU thread pools in every process that a port test runs
torch in.  Every ``tests/test_torch_*.py`` imports it before its first
torch op; pytest does not collect it (its name does not start with
``test_``).

The tier-1 command runs six xdist workers, and each imports every test
module.  Left alone, each worker's torch starts an OpenMP pool as wide as
the host, and six such pools, beside the gloo ranks and reference
processes the tests spawn, keep threads spinning on cores they do not
hold: on an 8-CPU host the train step's parity case took 37 s alone and
375 s in the full run.  Six copies of it side by side took 52-55 s each
at one thread, 45-50 s at two (which leaves no core to what the tests
spawn), and had not ended after 400 s at the default.

At import this module sets ``OMP_NUM_THREADS`` where the caller has not
(the processes a test spawns inherit it), and gives this process's
intra-op pool, and its inter-op pool where torch still allows it, that
many threads.  It leaves ``MKL_NUM_THREADS`` alone: torch reads it before
``OMP_NUM_THREADS``, so setting it would override the ``OMP_NUM_THREADS``
that some tests pass to their children.  The port's package sets no
thread count: that is its users' choice.
"""
import os

import torch

THREADS = 1

os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
N_THREADS = int(os.environ.get("MKL_NUM_THREADS")
                or os.environ["OMP_NUM_THREADS"])

torch.set_num_threads(N_THREADS)
try:
    torch.set_num_interop_threads(N_THREADS)
except RuntimeError:        # the inter-op pool has already started
    pass
