"""Multi-host process initialisation (``repro.launch.distributed``).

One process a rank.  The environment contract is the reference's:

  REPRO_COORDINATOR    host:port of process 0
  REPRO_NUM_PROCESSES  total process count
  REPRO_PROCESS_ID     this process's index

Without ``REPRO_COORDINATOR`` the process reads torchrun's environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The backend
is ``launch.train.backend_for``'s: NCCL where every rank has a card of
its own, gloo otherwise.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.launch.train import backend_for


def initialize_distributed(device="cuda") -> None:
    """Idempotent bring-up of the default process group from the
    environment contract; rank r takes card r % cards."""
    if dist.is_initialized():
        return
    env = os.environ
    if env.get("REPRO_COORDINATOR"):
        init = f"tcp://{env['REPRO_COORDINATOR']}"
        world = int(env["REPRO_NUM_PROCESSES"])
        rank = int(env["REPRO_PROCESS_ID"])
    else:
        init = "env://"
        world = int(env["WORLD_SIZE"])
        rank = int(env["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev, world), init_method=init,
                            rank=rank, world_size=world)


def assert_production_topology(multi_pod: bool) -> None:
    """Fail fast if the fleet does not match the assumed mesh."""
    want = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != want:
        raise RuntimeError(
            f"expected {want} ranks for the "
            f"{'2x16x16' if multi_pod else '16x16'} mesh, found {have}; "
            "check the REPRO_* or torchrun environment")


def host_local_batch_slice(global_batch: int):
    """The index range of the global batch this process feeds (one
    process a rank: its contiguous share)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // n
    return i * per, (i + 1) * per
