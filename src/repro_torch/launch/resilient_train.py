"""Resilient-training launcher (``repro.launch.resilient_train``).

Runs one chaos scenario, a transformer config trained data-parallel with
a worker killed mid-step, three times over one fleet of rank processes:
the uninterrupted baseline, recovery by **checkpoint restore** (roll
back and replay) and recovery by **peer takeover** (survivors adopt the
dead peer's in-DB partition, no replay).  One fleet means one warm-up,
so the three runs differ only in policy.

``main`` spawns ``--n-workers`` ranks (one process each; gloo where
ranks share a card or run on the CPU, NCCL where each has a card of its
own).  From the parent, use :func:`run_in_subprocess`, or directly:

  # reduced SmolLM on 4 CPU ranks
  PYTHONPATH=src python -m repro_torch.launch.resilient_train \\
      --device cpu --steps 5 --kill-step 3 --checkpoint-every 2 --seq 8

The config is reduced, as in the reference's launcher; ``chip_smoke.py``'s
``resilience`` phase runs the harness at full width.

Rank 0 prints one machine-readable line:

  RESULT,arch=<id>,sim_arch=<id>,kill_step=<n>,bitexact=<0|1>,\\
restore_wall_s=<f>,takeover_wall_s=<f>,restore_replayed=<n>,\\
takeover_loss_gap=<f>

and (with ``--json-out``) writes the full traces and recovery rows as
JSON, in the reference's schema (a recovery row also carries its wall
time by part, ``split_s``).  ``--init-from`` starts from a checkpoint: a
parameter tree (``launch.train --checkpoint``, or the reference's) or a
whole harness state.  ``--fsdp`` is refused: the port has no FSDP yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional

import torch


def run_experiment(*, arch: str = "smollm-135m", sim_arch: str = "spirt",
                   n_workers: int = 4, steps: int = 12,
                   global_batch: int = 12, seq: int = 16,
                   kill_step: int = 6, kill_worker: int = 1,
                   checkpoint_every: int = 4, lr: float = 1e-2,
                   fsdp: bool = False, restore_reinvoke: bool = True,
                   seed: int = 0,
                   modes: str = "baseline,restore,takeover",
                   device="cuda", init_from: Optional[str] = None
                   ) -> Dict[str, Any]:
    """Baseline + restore + takeover for one kill scenario, as one rank
    of an initialised default process group of ``n_workers`` ranks.

    Returns a JSON-ready dict, the same on every rank; ``bitexact``
    compares the restored run's full loss trace to the uninterrupted
    baseline (only meaningful with ``restore_reinvoke=True``)."""
    from repro_torch.resilience import (FaultSchedule, ResilienceConfig,
                                        ResilientTrainer)
    from repro_torch.serverless.recovery import (CheckpointRestore,
                                                 PeerTakeover)

    cfg = ResilienceConfig(
        arch=arch, sim_arch=sim_arch, n_workers=n_workers, steps=steps,
        global_batch=global_batch, seq=seq, lr=lr,
        checkpoint_every=checkpoint_every, fsdp=fsdp,
        restore_reinvoke=restore_reinvoke, seed=seed)
    trainer = ResilientTrainer(cfg, device=device, init_from=init_from)
    schedule = FaultSchedule.single(kill_step, kill_worker)
    want = tuple(m.strip() for m in modes.split(",") if m.strip())

    out: Dict[str, Any] = {
        "config": dataclasses.asdict(cfg),
        "kill": {"step": kill_step, "worker": kill_worker},
        "runs": {},
    }

    def pack(res):
        return {
            "losses": list(res.losses),
            "final_loss": res.final_loss,
            "n_params": res.n_params,
            "state_bytes": res.state_bytes,
            "step_s": res.step_s,
            "n_workers_end": res.n_workers_end,
            "replay_exact": res.replay_exact,
            "recoveries": [dataclasses.asdict(r)
                           for r in res.recoveries],
        }

    baseline = None
    if "baseline" in want:
        baseline = trainer.run()
        out["runs"]["baseline"] = pack(baseline)
    if "restore" in want:
        res = trainer.run(schedule, CheckpointRestore(
            checkpoint_every=checkpoint_every))
        row = pack(res)
        if baseline is not None:
            row["bitexact_vs_baseline"] = (
                res.losses == baseline.losses)
        out["runs"]["restore"] = row
    if "takeover" in want:
        res = trainer.run(schedule, PeerTakeover())
        row = pack(res)
        if baseline is not None:
            row["final_loss_gap"] = abs(
                res.final_loss - baseline.final_loss)
        out["runs"]["takeover"] = row
    return out


def run_in_subprocess(*, arch: str = "smollm-135m",
                      sim_arch: str = "spirt", steps: int = 12,
                      kill_step: int = 6, kill_worker: int = 1,
                      n_workers: int = 4, global_batch: int = 12,
                      seq: int = 16, checkpoint_every: int = 4,
                      lr: float = 1e-2, restore_reinvoke: bool = True,
                      seed: int = 0,
                      modes: str = "baseline,restore,takeover",
                      device: str = "cuda", init_from: Optional[str] = None,
                      timeout: float = 1800.0) -> Dict[str, Any]:
    """Run this module's ``main`` in a child process (which spawns the
    ranks); return the ``--json-out`` payload."""
    from repro_torch.launch import _subprocess
    fd, path = tempfile.mkstemp(suffix=".json", prefix="resil_")
    os.close(fd)
    try:
        argv = ["--arch", arch, "--sim-arch", sim_arch,
                "--steps", str(steps), "--kill-step", str(kill_step),
                "--kill-worker", str(kill_worker),
                "--n-workers", str(n_workers),
                "--global-batch", str(global_batch),
                "--seq", str(seq),
                "--checkpoint-every", str(checkpoint_every),
                "--lr", str(lr), "--seed", str(seed), "--modes", modes,
                "--device", device, "--json-out", path]
        if not restore_reinvoke:
            argv.append("--no-reinvoke")
        if init_from is not None:
            argv += ["--init-from", init_from]
        _subprocess.run_module("repro_torch.launch.resilient_train", argv,
                               timeout=timeout)
        return _subprocess.read_json_out(path)
    finally:
        os.unlink(path)


def result_line(out: Dict[str, Any]) -> str:
    """The launcher's ``RESULT,...`` line for a ``run_experiment`` payload."""
    runs = out["runs"]
    rw = (runs.get("restore", {}).get("recoveries") or
          [{}])[0].get("wall_s", float("nan"))
    tw = (runs.get("takeover", {}).get("recoveries") or
          [{}])[0].get("wall_s", float("nan"))
    rr = (runs.get("restore", {}).get("recoveries") or
          [{}])[0].get("replayed_steps", 0)
    bx = runs.get("restore", {}).get("bitexact_vs_baseline", False)
    gap = runs.get("takeover", {}).get("final_loss_gap", float("nan"))
    cfg = out["config"]
    return (f"RESULT,arch={cfg['arch']},sim_arch={cfg['sim_arch']},"
            f"kill_step={out['kill']['step']},bitexact={int(bool(bx))},"
            f"restore_wall_s={rw},takeover_wall_s={tw},"
            f"restore_replayed={rr},takeover_loss_gap={gap}")


def _worker(rank, kwargs, init_method, json_out):
    from repro_torch.launch.train import _rank_device, process_group
    W = kwargs["n_workers"]
    with process_group(_rank_device(kwargs["device"], rank), rank, W,
                       init_method):
        out = run_experiment(**kwargs)
    if rank == 0:
        if json_out:
            with open(json_out, "w", encoding="utf-8") as fh:
                json.dump(out, fh, indent=1, sort_keys=True)
        print(result_line(out), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="chaos-test one data-parallel training scenario")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--sim-arch", default="spirt")
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--global-batch", type=int, default=12)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--kill-step", type=int, default=6)
    ap.add_argument("--kill-worker", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--modes", default="baseline,restore,takeover")
    ap.add_argument("--no-reinvoke", action="store_true",
                    help="restore onto the W-1 survivors instead of "
                         "re-invoking the dead worker")
    ap.add_argument("--fsdp", action="store_true",
                    help="refused: the port has no FSDP yet")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--init-from", default=None, metavar="PATH",
                    help="start from this checkpoint (a parameter tree or "
                         "a harness state)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.resilience import ResilienceConfig
    kwargs = dict(
        arch=args.arch, sim_arch=args.sim_arch,
        n_workers=args.n_workers, steps=args.steps,
        global_batch=args.global_batch, seq=args.seq,
        kill_step=args.kill_step, kill_worker=args.kill_worker,
        checkpoint_every=args.checkpoint_every, lr=args.lr,
        fsdp=args.fsdp, restore_reinvoke=not args.no_reinvoke,
        seed=args.seed, modes=args.modes,
        device=args.device, init_from=args.init_from)
    # refuse a bad scenario (fsdp among them) before spawning a rank
    ResilienceConfig(**{k: kwargs[k] for k in (
        "arch", "sim_arch", "n_workers", "steps", "global_batch", "seq",
        "lr", "checkpoint_every", "fsdp", "seed")},
        restore_reinvoke=not args.no_reinvoke)
    init_method = "file://" + os.path.join(
        tempfile.mkdtemp(prefix="repro_torch_pg_"), "rendezvous")
    torch.multiprocessing.spawn(
        _worker, args=(kwargs, init_method, args.json_out),
        nprocs=args.n_workers)


if __name__ == "__main__":
    main()
