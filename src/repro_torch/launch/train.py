"""Training entry point for the paper's CNN experiment
(``repro.launch.train``, CNN branch): a CIFAR CNN trained data-parallel
with one of the five gradient-sync strategies, SGD with momentum 0.9.

Examples:
  # full-width MobileNet, MLLess, on one GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch mobilenet-cifar \
      --strategy mlless --steps 30 --batch 96

  # reduced MobileNet on two CPU ranks (gloo)
  PYTHONPATH=src python -m repro_torch.launch.train --arch mobilenet-cifar \
      --reduced --device cpu --world-size 2 --steps 5 --batch 8

One process per rank: NCCL on the GPU (rank r on card r), gloo on the
CPU, rendezvous through a ``file://`` init method in a fresh temporary
directory.  Every rank draws the same global batch from the seed and
trains on its own contiguous shard of it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step, get_strategy
from repro_torch.core.strategies import STRATEGIES
from repro_torch.data import cifar_like
from repro_torch.device import resolve_device
from repro_torch.models import build_cnn


def _rank_device(device, rank):
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def train(*, arch: str, strategy: str = "allreduce", steps: int = 50,
          batch: int = 16, lr: float = 3e-3, device="cuda",
          reduced: bool = False, seed: int = 0, rank: int = 0,
          world_size: int = 1, init_method=None, log_every: int = 10,
          log=print) -> dict:
    """Train ``steps`` steps as ``rank`` of ``world_size`` and return a
    summary: per-step losses, the last metrics, timings and, on a GPU,
    peak device memory.  Joins the default process group when it is
    already initialised; otherwise creates it from ``init_method`` (with
    one rank, a fresh ``file://`` path when None) and destroys it after.
    """
    if batch % world_size:
        raise ValueError(f"global batch {batch} is not divisible by "
                         f"world size {world_size}")
    dev = _rank_device(device, rank)
    own_group = not dist.is_initialized()
    if own_group:
        if init_method is None:
            if world_size != 1:
                raise ValueError("init_method is required with world_size "
                                 "> 1")
            init_method = "file://" + os.path.join(
                tempfile.mkdtemp(prefix="repro_torch_pg_"), "rendezvous")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method, rank=rank, world_size=world_size)
    try:
        return _train(arch, strategy, steps, batch, lr, dev, reduced, seed,
                      log_every, log if rank == 0 else None)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(arch, strategy, steps, batch, lr, dev, reduced, seed, log_every,
           log):
    rank, W = dist.get_rank(), dist.get_world_size()
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_cnn(cfg, device=dev, seed=seed)
    ts = build_train_step(model, optim.sgd(lr, momentum=0.9),
                          get_strategy(strategy))
    state = ts.init_state()
    n_params = sum(p.numel() for p in state["params"])
    if log:
        log(f"arch={cfg.name} strategy={strategy} params={n_params:,} "
            f"world_size={W} device={dev}")

    imgs, labels = cifar_like(batch * 64, seed=seed)
    imgs, labels = torch.from_numpy(imgs).to(dev), \
        torch.from_numpy(labels).to(dev)
    rs = np.random.RandomState(seed)
    B_local = batch // W

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, metrics = [], {}
    sync()
    t0 = t1 = time.perf_counter()
    for step in range(steps):
        idx = rs.randint(0, len(imgs), batch)[rank * B_local:
                                              (rank + 1) * B_local]
        idx = torch.from_numpy(idx).to(dev)
        state, metrics = ts.step_fn(state, {"images": imgs[idx],
                                            "labels": labels[idx]})
        losses.append(metrics["loss"])
        if step == 0:
            sync()
            t1 = time.perf_counter()
        if log and (step % log_every == 0 or step == steps - 1):
            extra = "".join(f" {k}={float(v):.3f}" for k, v in
                            metrics.items() if k not in ("loss", "step"))
            log(f"step {step:4d}  loss {float(metrics['loss']):.4f}{extra}"
                f"  ({time.perf_counter() - t0:.1f}s)")
    sync()
    t2 = time.perf_counter()
    out = {
        "arch": cfg.name, "strategy": strategy, "params": n_params,
        "world_size": W, "device": str(dev),
        "losses": [float(l) for l in losses],
        "metrics": {k: float(v) for k, v in metrics.items()},
        "first_step_ms": (t1 - t0) * 1e3,
        "ms_per_step": ((t2 - t1) * 1e3 / (steps - 1)) if steps > 1
        else None,
    }
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _worker(rank, kwargs):
    train(rank=rank, **kwargs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=["mobilenet-cifar", "resnet18-cifar"])
    ap.add_argument("--strategy", default="allreduce",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16, help="global batch")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced width (CPU-trainable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    kwargs = dict(arch=args.arch, strategy=args.strategy, steps=args.steps,
                  batch=args.batch, lr=args.lr, device=args.device,
                  reduced=args.reduced, seed=args.seed,
                  world_size=args.world_size)
    if args.world_size == 1:
        res = train(**kwargs)
        print(f"ms/step {res['ms_per_step']}  first step "
              f"{res['first_step_ms']:.1f} ms")
        return res
    kwargs["init_method"] = "file://" + os.path.join(
        tempfile.mkdtemp(prefix="repro_torch_pg_"), "rendezvous")
    torch.multiprocessing.spawn(_worker, args=(kwargs,),
                                nprocs=args.world_size)


if __name__ == "__main__":
    main()
