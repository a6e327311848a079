"""Byzantine-robustness training driver (``repro.launch.byzantine_train``).

Trains a CIFAR CNN (reduced MobileNet by default, as the reference) on
the synthetic CIFAR set, data-parallel over W ranks, with a byzantine
rank set wrapped in ``ByzantineGradients`` under any registered attack
(``repro_torch.serverless.adversarial``: sign_flip / scale /
gaussian_noise / little_is_enough / zero) and any inner strategy,
including the robust family (``trimmed_mean``, ``coordinate_median``,
``krum``, ``geometric_median``).  SGD with momentum 0.9, SPIRT's K = 4
microbatches for the robust inners.

One process per rank.  On the GPU, ranks that outnumber the cards share
them (rank r on card r % cards) over gloo, since NCCL refuses two ranks on
one card.  Examples:

  # 4 ranks on the GPU(s), full-width MobileNet
  PYTHONPATH=src python -m repro_torch.launch.byzantine_train \\
      --world-size 4 --inner trimmed_mean --steps 30 --batch 96 --lr 0.01

  # 4 gloo ranks on the CPU, reduced MobileNet
  PYTHONPATH=src python -m repro_torch.launch.byzantine_train \\
      --world-size 4 --reduced --device cpu --steps 6 --data-size 512

Rank 0 prints one machine-readable line:

  RESULT,inner=<name>,attack=<name>,steps=<n>,acc=<f>,final_loss=<f>,\\
max_loss=<f>,head_loss=<f>,tail_loss=<f>

The in-process :func:`run` also returns the full loss trace
(``"losses"``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step, get_strategy
from repro_torch.core.losses import accuracy
from repro_torch.core.strategies import ROBUST
from repro_torch.data import cifar_like
from repro_torch.launch import _subprocess
from repro_torch.launch.train import _rank_device, process_group
from repro_torch.models import build_cnn


def run(inner: str = "trimmed_mean", *, attack: str = "scale",
        steps: int = 150, batch: int = 64, data_size: int = 4096,
        trim: int = 1, krum_f: int = 0, microbatches: int = 4,
        byz_scale: Optional[float] = None,
        byz_workers: Tuple[int, ...] = (0,), lr: float = 0.1,
        eval_size: int = 512, seed: int = 0,
        arch: str = "mobilenet-cifar", reduced: bool = True,
        device="cuda", rank: int = 0, world_size: int = 1,
        init_method=None, log=None) -> Dict[str, Any]:
    """One training run under an active byzantine rank set, as ``rank``
    of the default process group (joined when initialised, else created
    as in ``launch.train.train``).

    ``byz_scale=None`` keeps the calibrated -8x magnitude for the
    ``scale`` attack and the attack's own default otherwise.
    ``krum_f=0`` because 4 ranks satisfy Krum's ``W >= 2f + 3`` only at
    ``f = 0``.  Returns the accuracy on a held-out set, the loss summary
    and the full per-step loss trace (``"losses"``), plus the step time
    on the host clock."""
    dev = _rank_device(device, rank)
    with process_group(dev, rank, world_size, init_method):
        rank, W = dist.get_rank(), dist.get_world_size()
        if batch % W:
            raise ValueError(f"global batch {batch} is not divisible by "
                             f"world size {W}")
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
        imgs, labels = cifar_like(data_size, seed=0)
        timgs, tlabels = cifar_like(eval_size, seed=99)
        model = build_cnn(cfg, device=dev, seed=seed)

        if inner in ROBUST:
            kw = {"microbatches": microbatches}
            if inner == "trimmed_mean":
                kw["trim"] = trim
            elif inner == "krum":
                kw["f"] = krum_f
            inner_strat = get_strategy(inner, **kw)
        else:
            inner_strat = get_strategy(inner)
        if byz_scale is None and attack == "scale":
            byz_scale = -8.0               # the calibrated attack
        strat = get_strategy("byzantine", inner=inner_strat,
                             workers=tuple(byz_workers), attack=attack,
                             scale=byz_scale, seed=seed, n_workers=W)
        ts = build_train_step(model, optim.sgd(lr, momentum=0.9), strat)
        state = ts.init_state()
        imgs, labels = torch.from_numpy(imgs).to(dev), \
            torch.from_numpy(labels).to(dev)
        rs = np.random.RandomState(seed)
        B = batch // W
        if log and rank == 0:
            log(f"arch={cfg.name} inner={inner} attack={attack} "
                f"workers={strat.workers} scale={strat.scale} world_size={W} "
                f"backend={dist.get_backend()} device={dev}")

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        seen = []
        sync()
        t0 = t1 = time.perf_counter()
        for step in range(steps):
            idx = rs.randint(0, len(imgs), batch)[rank * B:(rank + 1) * B]
            idx = torch.from_numpy(idx).to(dev)
            state, m = ts.step_fn(state, {"images": imgs[idx],
                                          "labels": labels[idx]})
            seen.append(float(m["loss"]))
            if step == 0:
                t1 = time.perf_counter()
            if log and rank == 0 and (step % 10 == 0 or step == steps - 1):
                log(f"step {step:4d}  loss {seen[-1]:.4f}  "
                    f"({time.perf_counter() - t0:.1f}s)")
        sync()
        t2 = time.perf_counter()
        with torch.no_grad():
            logits = model(torch.from_numpy(timgs).to(dev))
        acc = float(accuracy(logits, torch.from_numpy(tlabels).to(dev)))
        k = min(10, len(seen))
        return {"acc": acc, "final_loss": seen[-1], "max_loss": max(seen),
                "head_loss": float(np.mean(seen[:k])),
                "tail_loss": float(np.mean(seen[-k:])),
                "losses": tuple(seen),
                "first_step_ms": (t1 - t0) * 1e3,
                "ms_per_step": ((t2 - t1) * 1e3 / (steps - 1)) if steps > 1
                else None}


def _worker(rank, kwargs):
    r = run(rank=rank, **kwargs)
    if rank == 0:
        print(f"RESULT,inner={kwargs['inner']},attack={kwargs['attack']},"
              f"steps={kwargs['steps']},acc={r['acc']},"
              f"final_loss={r['final_loss']},max_loss={r['max_loss']},"
              f"head_loss={r['head_loss']},tail_loss={r['tail_loss']}",
              flush=True)


def run_in_subprocess(inner: str, *, steps: int, attack: str = "scale",
                      data_size: int = 4096, world_size: int = 4,
                      seed: int = 0, device: str = "cuda",
                      reduced: bool = True,
                      timeout: float = 1800.0) -> Dict[str, Any]:
    """Run this module's ``main`` in a child process with ``world_size``
    ranks; parse its RESULT line (numbers as floats)."""
    argv = ["--inner", inner, "--attack", attack, "--steps", str(steps),
            "--data-size", str(data_size), "--seed", str(seed),
            "--world-size", str(world_size), "--device", device,
            *(["--reduced"] if reduced else [])]
    out = _subprocess.run_module("repro_torch.launch.byzantine_train", argv,
                                 timeout=timeout)
    return _subprocess.parse_result_line(out,
                                         numeric_except=("inner", "attack"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--inner", default="trimmed_mean")
    ap.add_argument("--attack", default="scale")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--data-size", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64, help="global batch")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--arch", default="mobilenet-cifar",
                    choices=["mobilenet-cifar", "resnet18-cifar"])
    ap.add_argument("--reduced", action="store_true",
                    help="reduced width (CPU-trainable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--world-size", type=int, default=4)
    args = ap.parse_args(argv)
    kwargs = dict(inner=args.inner, attack=args.attack, steps=args.steps,
                  data_size=args.data_size, seed=args.seed,
                  batch=args.batch, lr=args.lr, arch=args.arch,
                  reduced=args.reduced, device=args.device,
                  world_size=args.world_size,
                  init_method="file://" + os.path.join(
                      tempfile.mkdtemp(prefix="repro_torch_pg_"),
                      "rendezvous"))
    torch.multiprocessing.spawn(_worker, args=(kwargs,),
                                nprocs=args.world_size)


if __name__ == "__main__":
    main()
