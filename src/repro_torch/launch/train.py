"""Training entry point (``repro.launch.train``): a model trained
data-parallel with one of the five gradient-sync strategies.  A CIFAR CNN
(the paper's experiment) trains with SGD, momentum 0.9, on the synthetic
CIFAR-like set; a transformer LM trains with AdamW (b2 0.95) on the
synthetic Markov token stream, its attention or its RWKV6 WKV recurrence
through the Hopper kernels (``use_kernel=True``), and with
``--fused-optimizer`` its update through the fused AdamW kernel.
``--layers`` cuts the depth and nothing else (a full-width model that
does not fit one card).

Examples:
  # full-width MobileNet, MLLess, on one GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch mobilenet-cifar \
      --strategy mlless --steps 30 --batch 96

  # reduced MobileNet on two CPU ranks (gloo)
  PYTHONPATH=src python -m repro_torch.launch.train --arch mobilenet-cifar \
      --reduced --device cpu --world-size 2 --steps 5 --batch 8

  # full-width SmolLM-135M through both LM kernels on one GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --fused-optimizer --steps 30 --batch 16 --seq 128

  # reduced SmolLM on the CPU, its trained parameters saved
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --device cpu --steps 3 --batch 4 --seq 64 --fused-optimizer \
      --checkpoint /tmp/smollm_params.msgpack

  # full-width RWKV6-7B cut to 4 layers, through the WKV kernel, one GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \
      --layers 4 --fused-optimizer --steps 20 --batch 4 --seq 512

One process per rank: NCCL on the GPU (rank r on card r % cards), gloo on
the CPU and wherever ranks outnumber cards (NCCL refuses two ranks on
one GPU), rendezvous through a ``file://`` init method in a fresh
temporary directory.  Every rank draws the same global batch from the
seed and trains on its own contiguous shard of it.  ``--checkpoint PATH``
saves the trained parameter tree in the reference's checkpoint format
(``repro_torch.checkpoint``), which ``repro.checkpoint.restore(path,
like=params)`` reads.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step, get_strategy
from repro_torch.core.strategies import STRATEGIES
from repro_torch.data import cifar_like, lm_batches, token_stream
from repro_torch.device import resolve_device
from repro_torch.models import build_cnn, build_model, param_tree

CNN_ARCHS = ("mobilenet-cifar", "resnet18-cifar")
LM_ARCHS = ("smollm-135m", "phi3-mini-3.8b", "qwen1.5-4b", "gemma3-4b",
            "rwkv6-7b")


def _rank_device(device, rank):
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def backend_for(dev, world_size: int) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@contextlib.contextmanager
def process_group(dev, rank: int, world_size: int, init_method=None):
    """Joins the default process group when it is already initialised;
    otherwise creates it from ``init_method`` (with one rank, a fresh
    ``file://`` path when None) and destroys it on exit."""
    if dist.is_initialized():
        yield
        return
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_method is required with world_size > 1")
        init_method = "file://" + os.path.join(
            tempfile.mkdtemp(prefix="repro_torch_pg_"), "rendezvous")
    dist.init_process_group(backend_for(dev, world_size),
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def train(*, arch: str, strategy: str = "allreduce", steps: int = 50,
          batch: int = 16, seq: int = 128, lr: float = 3e-3,
          fused_optimizer: bool = False, device="cuda",
          reduced: bool = False, n_layers=None, seed: int = 0,
          rank: int = 0, world_size: int = 1, init_method=None,
          init_params=None, checkpoint=None, log_every: int = 10,
          log=print) -> dict:
    """Train ``steps`` steps as ``rank`` of ``world_size`` and return a
    summary: per-step losses, the last metrics, timings and, on a GPU,
    peak device memory.  ``batch`` is the global batch; each rank trains
    on its contiguous shard of it.  ``seq`` and ``fused_optimizer`` apply
    to an LM.  ``n_layers`` replaces the config's depth (after
    ``reduced``), widths unchanged.  ``init_params`` is a state dict to
    start from (for instance ``params_from_reference`` of a reference
    tree) instead of the seeded draw.  ``checkpoint`` is a path where rank 0
    saves the trained parameter tree in the reference's format.  Joins the
    default process group when it is already initialised; otherwise
    creates it from ``init_method`` (with one rank, a fresh ``file://``
    path when None) and destroys it after.
    """
    if batch % world_size:
        raise ValueError(f"global batch {batch} is not divisible by "
                         f"world size {world_size}")
    dev = _rank_device(device, rank)
    with process_group(dev, rank, world_size, init_method):
        return _train(arch, strategy, steps, batch, seq, lr, fused_optimizer,
                      dev, reduced, n_layers, seed, init_params, checkpoint,
                      log_every, log if rank == 0 else None)


def _cnn_setup(cfg, batch, lr, dev, seed, rank, B_local):
    model = build_cnn(cfg, device=dev, seed=seed)
    imgs, labels = cifar_like(batch * 64, seed=seed)
    imgs, labels = torch.from_numpy(imgs).to(dev), \
        torch.from_numpy(labels).to(dev)
    rs = np.random.RandomState(seed)

    def next_batch():
        idx = rs.randint(0, len(imgs), batch)[rank * B_local:
                                              (rank + 1) * B_local]
        idx = torch.from_numpy(idx).to(dev)
        return {"images": imgs[idx], "labels": labels[idx]}
    return model, optim.sgd(lr, momentum=0.9), next_batch


def _lm_setup(cfg, batch, seq, lr, fused_optimizer, dev, seed, rank,
              B_local):
    model = build_model(cfg, use_kernel=True, device=dev, seed=seed)
    it = lm_batches(token_stream(batch * seq * 64, cfg.vocab_size,
                                 seed=seed), batch, seq, seed=seed)

    def next_batch():
        return {k: torch.from_numpy(v[rank * B_local:(rank + 1) * B_local])
                .to(dev) for k, v in next(it).items()}
    return model, optim.adamw(lr, use_fused=fused_optimizer), next_batch


def _train(arch, strategy, steps, batch, seq, lr, fused_optimizer, dev,
           reduced, n_layers, seed, init_params, checkpoint, log_every,
           log):
    rank, W = dist.get_rank(), dist.get_world_size()
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if n_layers is not None:
        if cfg.family == "cnn":
            raise ValueError(f"{arch}: the depth of a CNN cannot be cut")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    B_local = batch // W
    if cfg.family == "cnn":
        model, opt, next_batch = _cnn_setup(cfg, batch, lr, dev, seed, rank,
                                            B_local)
    else:
        model, opt, next_batch = _lm_setup(cfg, batch, seq, lr,
                                           fused_optimizer, dev, seed, rank,
                                           B_local)
    if init_params is not None:
        model.load_state_dict(init_params)
    ts = build_train_step(model, opt, get_strategy(strategy))
    state = ts.init_state()
    n_params = sum(p.numel() for p in state["params"])
    if log:
        log(f"arch={cfg.name} strategy={strategy} params={n_params:,} "
            f"world_size={W} device={dev}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, metrics = [], {}
    sync()
    t0 = t1 = time.perf_counter()
    for step in range(steps):
        state, metrics = ts.step_fn(state, next_batch())
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
    if checkpoint and rank == 0:
        ckpt.save(checkpoint, param_tree(model))
        if log:
            log(f"saved params to {checkpoint}")
    return out


def _worker(rank, kwargs):
    train(rank=rank, **kwargs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=CNN_ARCHS + LM_ARCHS)
    ap.add_argument("--strategy", default="allreduce",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16, help="global batch")
    ap.add_argument("--seq", type=int, default=128, help="LM sequence length")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fused-optimizer", action="store_true",
                    help="LM: AdamW through the fused kernel")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced width (CPU-trainable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM: cut the depth to this many layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="save the trained parameters here, in the "
                         "reference's checkpoint format")
    args = ap.parse_args(argv)
    kwargs = dict(arch=args.arch, strategy=args.strategy, steps=args.steps,
                  batch=args.batch, seq=args.seq, lr=args.lr,
                  fused_optimizer=args.fused_optimizer, device=args.device,
                  reduced=args.reduced, n_layers=args.layers,
                  seed=args.seed, checkpoint=args.checkpoint,
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
