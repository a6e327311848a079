"""Fault-injecting harness for real data-parallel training
(``repro.resilience.harness``).

A transformer config trains data-parallel under a deterministic
:class:`~repro_torch.resilience.schedule.FaultSchedule`; at a scheduled
step a worker is lost mid-step, and the run recovers through the *same
policy objects* the event runtime scores, via their ``real_apply`` hooks
(``repro_torch.serverless.recovery``):

  CheckpointRestore  the λML / MLLess model: the supervisor re-invokes
      the lost worker, rolls the fleet back to the last mid-epoch
      ``repro_torch.checkpoint`` file and *replays* the lost steps.  With
      deterministic data the replayed trace is bit-identical to the
      uninterrupted same-seed run; the harness records the overlap.  With
      ``restore_reinvoke=False`` the snapshot restores onto the W-1
      survivors instead, which drop the dead worker's row of the
      strategy state, replay and absorb its share of the batch.

  PeerTakeover  SPIRT (arXiv 2309.14148): the state's bytes live in the
      in-memory "in-DB" store (:class:`~repro_torch.resilience.store.
      InMemoryStore`), pushed every ``push_every`` steps as W partitions.
      Survivors reassemble the state from the store's bytes (the dead
      peer's partition is the one transfer recovery buys), adopt it and
      continue *without replay* on W-1 workers, absorbing the dead
      worker's share of the same global batch.

One process a worker, where the reference runs one process over W host
devices: every rank builds a ``ResilientTrainer`` over the default
process group (W ranks) and calls :meth:`~ResilientTrainer.run` with the
same arguments.  Parameters and optimizer moments are replicated, so
every rank builds the same checkpoint blob (the strategy's per-rank rows
are all-gathered into it) and pushes its W partitions into a store of
its own; the lowest live rank writes the checkpoint file, into a
directory every rank shares.  A killed rank takes no part in any later
collective of the run: the survivors continue on a process group over
the surviving ranks in rank order, created with the run's other
survivor groups before the first step.  Once the run ends, the lowest
surviving rank sends its :class:`RunResult` to every rank, the killed
one included.

Wall-clock accounting: each fleet width's step runs once on throwaway
state before the first run that needs it (``warm``), so recovery wall
times measure state movement and replay, not first-call costs.  Each
recovery's wall time is split into ``split_s``: read (the file, or the
store's partitions), decode, to-device and replay.

FSDP (``fsdp=True``): each fleet is the reference's ("data", "model")
mesh of W x 1 ranks, and the block leaves whose spec divides over the
fleet shard over it with their moments (``core.train_step``).  Every
checkpoint and in-DB blob is the whole state, gathered; a fleet that
shrinks re-derives the specs on ``sharding.survivor_mesh``, where a leaf
that no longer divides goes back to replication, and keeps its shards
of the restored whole state.

Differences from the reference: ``ResilienceConfig.fsdp`` defaults to
False (the reference's default is True), so existing scenarios keep their
replicated state; an encoder-decoder refuses ``fsdp=True`` (the
reference's step fails there, ROADMAP §3);
``jax.random`` draws cannot be reproduced, so a run starts from the
parameters passed in (``init_params``, for instance
``params_from_reference`` of the reference's tree), from a checkpoint
(``init_from``) or from a seeded ``torch.Generator`` draw.
On a GPU the update runs the fused AdamW kernel (the same bits as the
plain update the CPU runs) and attention runs the Hopper kernel.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint, optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step
from repro_torch.data import lm_batches, token_stream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model, param_tree, reference_leaves
from repro_torch.models.params import global_shapes, set_leaves
from repro_torch.resilience import state as bridge
from repro_torch.resilience.schedule import FaultSchedule
from repro_torch.resilience.store import InMemoryStore
from repro_torch.serverless.archs import get_arch
from repro_torch.serverless.recovery import CheckpointRestore
from repro_torch.serverless.runtime import default_recovery


def _now() -> float:
    return time.perf_counter()  # repro: allow[no-wallclock] -- measured recovery and step wall times are this harness's deliverable


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """One resilient-training scenario (pure data, eagerly validated).

    ``arch`` names a ``repro_torch.configs`` model (transformer family);
    ``sim_arch`` names the serverless :class:`~repro_torch.serverless.
    archs.ArchSpec` twin: the harness trains with that spec's strategy
    (``spec.make_strategy()``), so the simulated scenario and the real
    run share one architecture definition.  ``fsdp`` shards the block
    leaves over the fleet (the reference's default is True, the port's
    False)."""
    arch: str = "smollm-135m"
    sim_arch: str = "spirt"
    n_workers: int = 4
    steps: int = 12
    global_batch: int = 12
    seq: int = 16
    lr: float = 1e-2
    checkpoint_every: int = 4
    push_every: int = 1
    fsdp: bool = False
    reduced: bool = True
    restore_reinvoke: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.fsdp and get_config(self.arch).is_encoder_decoder:
            raise ValueError(
                f"fsdp=True: {self.arch} shards its encoder's leaves, "
                "which the reference never gathers (its step fails; "
                "ROADMAP §3, M8)")
        if self.n_workers < 2:
            raise ValueError(
                f"n_workers must be >= 2 (a one-worker fleet has no "
                f"survivors), got {self.n_workers}")
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.checkpoint_every < 1 or self.push_every < 1:
            raise ValueError(
                f"checkpoint_every/push_every must be >= 1, got "
                f"{self.checkpoint_every}/{self.push_every}")
        if self.global_batch % self.n_workers:
            raise ValueError(
                f"global_batch {self.global_batch} must divide over "
                f"{self.n_workers} workers")
        if self.global_batch % (self.n_workers - 1):
            raise ValueError(
                f"global_batch {self.global_batch} must also divide "
                f"over {self.n_workers - 1} survivors (takeover "
                f"re-shards the same batch onto the shrunk fleet)")
        if self.seq < 2:
            raise ValueError(f"seq must be >= 2, got {self.seq}")


@dataclasses.dataclass
class RecoveryOutcome:
    """What one real recovery cost (one row of the recovery report)."""
    step: int                       # kill step (in-flight work lost)
    worker: int
    mode: str                       # "restore" | "takeover"
    replayed_steps: int             # steps re-run from the snapshot
    wall_s: float                   # state movement + replay
    bytes_moved: int                # ckpt read | dead partition fetched
    n_workers_after: int
    ckpt_step: Optional[int] = None  # restore: snapshot rolled back to
    split_s: Optional[Dict[str, float]] = None
    # ^ wall_s by part: read, decode, to_device, replay


@dataclasses.dataclass
class RunResult:
    """One training run (faulted or not) of the harness."""
    arch: str
    sim_arch: str
    losses: Tuple[float, ...]
    recoveries: List[RecoveryOutcome]
    n_params: int
    state_bytes: int                # serialized full-state blob size
    step_s: float                   # median fault-free step wall time
    n_workers_end: int
    replay_checks: Tuple[Tuple[int, float, float], ...] = ()
    # ^ (step, loss before kill, loss re-computed during replay)
    first_step: int = 0             # step of losses[0] (a resumed run)
    step_s_by_width: Dict[int, float] = dataclasses.field(
        default_factory=dict)      # median fault-free step per fleet size
    snapshot_s: float = 0.0         # host time in snapshots (blob + file)

    @property
    def final_loss(self) -> float:
        return self.losses[-1]

    @property
    def replay_exact(self) -> bool:
        """Every replayed step reproduced its pre-kill loss bit-exactly
        (vacuously true when nothing was replayed)."""
        return all(a == b for _, a, b in self.replay_checks)


class ResilientTrainer:
    """Drives one config through faulted and unfaulted runs, as one rank
    of the default process group, whose size must be
    ``config.n_workers``.

    ``device`` is this rank's device type (rank r takes card r % cards).
    ``init_params`` is a state dict of initial parameters (for instance
    ``params_from_reference`` of the reference's tree), as
    ``launch.train.train`` takes; ``init_from`` is a checkpoint path holding either a parameter tree or
    a whole harness state (a run then resumes at its step); with neither,
    the parameters are drawn from ``config.seed``.  ``ckpt_dir`` must be
    the same directory on every rank (None: rank 0 makes a temporary
    one); ``keep_checkpoints=False`` deletes each checkpoint file once a
    newer one is written.  :meth:`run` owns the lifecycle (fresh state,
    store and checkpoints), so repeated calls with equal seeds replay
    bit-identically.
    """

    def __init__(self, config: ResilienceConfig,
                 ckpt_dir: Optional[str] = None, *, device="cuda",
                 init_params=None, init_from: Optional[str] = None,
                 keep_checkpoints: bool = True):
        if not dist.is_initialized() or \
                dist.get_world_size() != config.n_workers:
            raise RuntimeError(
                f"run one ResilientTrainer on each of {config.n_workers} "
                "ranks of an initialised default process group")
        self.config = config
        self.rank = dist.get_rank()
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", self.rank % torch.cuda.device_count())
        self.device = dev
        mcfg = get_config(config.arch)
        if config.reduced:
            mcfg = mcfg.reduced()
        if mcfg.family == "cnn":
            raise ValueError(
                f"{config.arch!r} is a CNN; the resilience harness "
                "targets the transformer configs")
        self.model_config = mcfg
        self.model = build_model(mcfg, use_kernel=True, remat=False,
                                 device=dev, seed=config.seed)
        self.optimizer = optim.adamw(config.lr,
                                     use_fused=dev.type == "cuda")
        self.strategy = get_arch(config.sim_arch).make_strategy()
        self._all = tuple(range(config.n_workers))
        self._fleet: Tuple[int, ...] = self._all
        self._groups: Dict[Tuple[int, ...], Any] = {self._all: None}
        self._steps: Dict[Tuple[int, ...], Any] = {}
        self._warmed: set = set()
        self._keep = keep_checkpoints
        if ckpt_dir is None:
            box = [tempfile.mkdtemp(prefix="resil_")
                   if self.rank == 0 else None]
            dist.broadcast_object_list(box, src=0)
            ckpt_dir = box[0]
        os.makedirs(ckpt_dir, exist_ok=True)
        self._ckpt_dir = ckpt_dir

        # deterministic per-step batches: a pure function of
        # (config.seed, step), so a replay re-reads what the lost steps
        # consumed
        stream = token_stream(
            max(config.global_batch, 64) * (config.seq + 1) * 8,
            mcfg.vocab_size, seed=config.seed)
        it = lm_batches(stream, config.global_batch, config.seq,
                        seed=config.seed)
        self._batches = [next(it) for _ in range(config.steps)]

        if init_params is not None:
            self.model.load_state_dict(init_params)
        self._resume = None
        if init_from is not None:
            self._load_init(init_from)
        self._init = [p.detach().clone()
                      for p in reference_leaves(self.model)]

        # run-scoped state (set up by run())
        self.store = InMemoryStore()
        self._fleet: Tuple[int, ...] = self._all
        self._ts = self._state = None
        self._alive = True
        self._first = 0
        self._completed = 0
        self._losses: Dict[int, float] = {}
        self._ckpt_steps: Dict[int, str] = {}
        self._replay_checks: List[Tuple[int, float, float]] = []

    # ------------------------------------------------------------------
    # fleet / step plumbing
    # ------------------------------------------------------------------
    def _load_init(self, path):
        """A parameter tree sets the initial parameters; a whole state
        is kept and every run resumes from it."""
        with open(path, "rb") as f:
            data = f.read()
        ptree = param_tree(self.model)
        if checkpoint.stored_treedef(data) == checkpoint.treedef(ptree):
            tree = checkpoint.loads(data, like=bridge.describe(ptree))
            with torch.no_grad():
                for dst, src in zip(reference_leaves(self.model),
                                    checkpoint.flatten(tree)):
                    dst.copy_(src)
            return
        self._resume = checkpoint.loads(data, like=bridge.template(
            self._fresh_state(), self.model, self.config.n_workers))

    def _group(self, fleet):
        return self._groups[fleet]

    def _train_step(self, fleet):
        """The fleet's ``TrainStep`` on its W x 1 ("data", "model") mesh
        (the reference's harness mesh), built once."""
        if fleet not in self._steps:
            mesh = Mesh(np.asarray(fleet).reshape(-1, 1), ("data", "model"))
            self._steps[fleet] = build_train_step(
                self.model, self.optimizer, self.strategy, mesh,
                group=self._group(fleet), data_axes=("data",),
                model_axis="model", fsdp=self.config.fsdp)
        return self._steps[fleet]

    def _step_fn(self, fleet):
        return self._train_step(fleet).step_fn

    def _layout(self):
        """The current fleet's FSDP layout (None without FSDP)."""
        return self._train_step(self._fleet).layout

    def _fresh_state(self):
        params = reference_leaves(self.model)
        layout = self._layout() if self._fleet in self._steps else None
        sync = params if layout is None else \
            [p for p, m in zip(params, layout.mask) if not m]
        return {"params": params, "opt": self.optimizer.init(params),
                "strat": self.strategy.init_state(sync), "step": 0}

    def _reset(self):
        """Initial parameters (laid out for the current fleet), fresh
        optimizer and strategy state, or the resumed checkpoint's
        state."""
        layout = self._layout()
        set_leaves(self.model, self._init, layout)
        self._state = self._fresh_state()
        if self._resume is not None:
            bridge.from_reference(self._resume, self._state, self.rank,
                                  layout, self.model)
        self._first = self._state["step"]

    def _fleets(self, schedule, policy):
        """The fleets the schedule leads to: a kill removes the worker
        unless the policy re-invokes it."""
        fleet, out = self._all, []
        shrinks = not (isinstance(policy, CheckpointRestore)
                       and self.config.restore_reinvoke)
        for _, w in schedule.kills:
            if shrinks:
                dead = fleet[w % len(fleet)]
                fleet = tuple(r for r in fleet if r != dead)
            out.append(fleet)
        return out

    def warm(self, schedule: Optional[FaultSchedule] = None, policy=None):
        """Create the process groups of every fleet ``schedule`` leads to
        (collective over the default group) and run each fleet width's
        step once on throwaway state, on that fleet's ranks.  :meth:`run`
        calls it; call it first to keep its launches out of a count."""
        schedule = schedule or FaultSchedule()
        if policy is None and schedule.n_kills:
            policy = default_recovery(
                self.config.sim_arch,
                checkpoint_every=self.config.checkpoint_every)
        fleets = [self._all] + self._fleets(schedule, policy)
        for fleet in fleets:
            if fleet not in self._groups:
                self._groups[fleet] = dist.new_group(list(fleet))
        for fleet in fleets:
            if fleet in self._warmed:
                continue
            self._warmed.add(fleet)
            if self.rank in fleet:
                self._fleet = fleet
                self._reset()
                self._do_step(0, self._step_fn(fleet))
        self._state = None

    def fault_free_steps(self, n: int, start: int = 0) -> List[float]:
        """Steps ``start`` to ``start + n - 1`` on the whole fleet, with
        no fault, snapshot or store, on every rank; returns the losses.
        ``start`` 0 begins from the initial state, a later one goes on
        from the state the previous call left.  For a profiler window or
        a determinism probe outside :meth:`run`."""
        if start == 0:
            self._fleet, self._ts = self._all, self._step_fn(self._all)
            self._reset()
        elif self._state is None or self._fleet != self._all:
            raise RuntimeError("fault_free_steps(start > 0) goes on from "
                               "an earlier fault_free_steps call")
        return [self._do_step(s) for s in range(start, start + n)]

    def _batch(self, step):
        pos, B = self._fleet.index(self.rank), \
            self.config.global_batch // len(self._fleet)
        return {k: torch.from_numpy(v[pos * B:(pos + 1) * B]).to(
            self.device) for k, v in self._batches[step].items()}

    def _do_step(self, step, step_fn=None) -> float:
        step_fn = step_fn or self._ts
        self._state, m = step_fn(self._state, self._batch(step))
        return float(m["loss"])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # snapshots (checkpoint cadence + in-DB partitions)
    # ------------------------------------------------------------------
    def _blob(self):
        return checkpoint.dumps(bridge.to_reference(
            self._state, self.model, self._group(self._fleet),
            self._layout()))

    def _snapshot(self) -> Optional[int]:
        """Persist the current state: a checkpoint file every
        ``checkpoint_every`` completed steps (restore path) and the
        partitioned in-DB blob every ``push_every`` (takeover path).
        Returns the blob's size when one was built."""
        c, cfg = self._completed, self.config
        push = c % cfg.push_every == 0 or c == self._first
        save = c % cfg.checkpoint_every == 0
        if not (push or save):
            return None
        blob = self._blob()
        if push:
            # slices of a view: each partition is copied once, by the store
            self.store.push_partitions(memoryview(blob), len(self._fleet))
        if save:
            path = os.path.join(self._ckpt_dir, f"step_{c:06d}.msgpack")
            if self.rank == self._fleet[0]:
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)
                if not self._keep:
                    for old in self._ckpt_steps.values():
                        if old != path and os.path.exists(old):
                            os.remove(old)
            # the file is whole before any rank takes the next step
            dist.barrier(group=self._group(self._fleet))
            if not self._keep:
                self._ckpt_steps.clear()
            self._ckpt_steps[c] = path
        return len(blob)

    def _template(self):
        return bridge.template(self._state, self.model, len(self._fleet),
                               self._layout())

    def _adopt(self, tree, row, fleet, split, t):
        """Switch to ``fleet`` and write a restored host tree into the
        state on the device, laid out for that fleet, as row ``row`` of
        the strategy state."""
        self._fleet, self._ts = fleet, self._step_fn(fleet)
        bridge.from_reference(tree, self._state, row, self._layout(),
                              self.model)
        self._sync()
        split["to_device"] = _now() - t

    def _die(self):
        """This rank is the lost worker: it drops its state and store and
        takes no part in the rest of the run."""
        self._alive = False
        self._state = None
        self.store.reset()

    # ------------------------------------------------------------------
    # recovery paths (driven by RecoveryPolicy.real_apply)
    # ------------------------------------------------------------------
    def recover_restore(self, worker: int) -> RecoveryOutcome:
        """Roll back to the last checkpoint and replay the lost steps.

        ``restore_reinvoke=True`` (default, the simulator's
        CheckpointRestore semantics): the dead worker is re-invoked and
        every rank, the new one included, restores from the file, so the
        replayed and continued trace is bit-identical to the
        uninterrupted same-seed run.  ``False``: the snapshot restores
        onto the W-1 survivors, which replay, absorbing the dead worker's
        share: convergent, but not bit-comparable across widths.
        """
        t0 = _now()
        completed = self._completed
        ckpt_step = max(s for s in self._ckpt_steps if s <= completed)
        path = self._ckpt_steps[ckpt_step]
        replay = completed - ckpt_step
        row = self._fleet.index(self.rank)
        fleet = self._fleet
        if not self.config.restore_reinvoke:
            fleet = tuple(r for r in fleet if r != fleet[worker])
        out = RecoveryOutcome(
            step=completed, worker=worker, mode="restore",
            replayed_steps=replay, wall_s=0.0,
            bytes_moved=os.path.getsize(path), n_workers_after=len(fleet),
            ckpt_step=ckpt_step)
        if self.rank not in fleet:
            self._die()
            return out
        split = {}
        with open(path, "rb") as f:
            data = f.read()
        t = _now()
        split["read"] = t - t0
        # the snapshot's rows are the old fleet's: a survivor keeps its
        # own row, and the dead worker's row goes with it
        host = checkpoint.loads(data, like=self._template())
        del data
        t1 = _now()
        split["decode"] = t1 - t
        self._adopt(host, row, fleet, split, t1)
        t = _now()
        self._completed = ckpt_step
        for s in range(ckpt_step, completed):
            loss = self._do_step(s)
            if s in self._losses:
                self._replay_checks.append((s, self._losses[s], loss))
            self._losses[s] = loss
            self._completed = s + 1
        t1 = _now()
        split["replay"] = t1 - t
        out.wall_s, out.split_s = t1 - t0, split
        return out

    def recover_takeover(self, worker: int) -> RecoveryOutcome:
        """Survivors adopt the dead peer's in-DB partition and continue
        without replay on the survivor group."""
        t0 = _now()
        completed = self._completed
        row = self._fleet.index(self.rank)
        fleet = tuple(r for r in self._fleet if r != self._fleet[worker])
        out = RecoveryOutcome(
            step=completed, worker=worker, mode="takeover",
            replayed_steps=0, wall_s=0.0, bytes_moved=0,
            n_workers_after=len(fleet))
        if self.rank not in fleet:
            self._die()
            return out
        split = {}
        blob, out.bytes_moved = self.store.fetch_state(
            len(self._fleet), dead=worker)
        t = _now()
        split["read"] = t - t0
        host = checkpoint.loads(blob, like=self._template())
        del blob
        t1 = _now()
        split["decode"] = t1 - t
        self._adopt(host, row, fleet, split, t1)
        split["replay"] = 0.0
        out.wall_s, out.split_s = _now() - t0, split
        return out

    # ------------------------------------------------------------------
    # the training loop
    # ------------------------------------------------------------------
    def run(self, schedule: Optional[FaultSchedule] = None,
            policy=None) -> RunResult:
        """One training run under ``schedule``, on every rank; ``policy``
        (a :class:`~repro_torch.serverless.recovery.RecoveryPolicy`)
        defaults to the ``sim_arch``'s registry default
        (``recovery="auto"``).  Every rank returns the same result."""
        cfg = self.config
        schedule = schedule or FaultSchedule()
        if policy is None and schedule.n_kills:
            policy = default_recovery(
                cfg.sim_arch, checkpoint_every=cfg.checkpoint_every)
        for step, _ in schedule.kills:
            if step >= cfg.steps:
                raise ValueError(
                    f"kill at step {step} beyond the run's "
                    f"{cfg.steps} steps")
        self.warm(schedule, policy)

        # fresh lifecycle
        self.store.reset()
        self._ckpt_steps, self._replay_checks, self._losses = {}, [], {}
        self._alive, self._fleet = True, self._all
        self._ts = self._step_fn(self._all)
        self._reset()
        self._completed = self._first
        state_bytes = self._snapshot() or len(self._blob())
        n_params = sum(int(np.prod(s)) for s in global_shapes(self.model))

        recoveries: List[RecoveryOutcome] = []
        step_walls: Dict[int, List[float]] = {}
        snapshot_s = 0.0
        step = self._first
        while step < cfg.steps:
            w = schedule.kill_at(step)
            if w is not None and not any(r.step == step
                                         for r in recoveries):
                # mid-step loss: the step's in-flight gradient work is
                # gone; the policy decides restore vs takeover
                recoveries.append(
                    policy.real_apply(self, w % len(self._fleet)))
                if not self._alive:
                    break
                step = self._completed   # restore may have rolled back
                continue
            t0 = _now()
            self._losses[step] = self._do_step(step)
            step_walls.setdefault(len(self._fleet), []).append(
                _now() - t0)
            self._completed = step + 1
            t0 = _now()
            self._snapshot()
            snapshot_s += _now() - t0
            step += 1

        result = RunResult(
            arch=cfg.arch, sim_arch=cfg.sim_arch,
            losses=tuple(self._losses[s] for s in sorted(self._losses)),
            recoveries=recoveries, n_params=n_params,
            state_bytes=state_bytes,
            step_s=float(np.median(sum(step_walls.values(), [])))
            if step_walls else 0.0,
            n_workers_end=len(self._fleet),
            replay_checks=tuple(self._replay_checks),
            first_step=self._first,
            step_s_by_width={w: float(np.median(t))
                             for w, t in step_walls.items()},
            snapshot_s=snapshot_s)
        # the lowest rank of the final fleet reports, to every rank
        final = ([self._all] + self._fleets(schedule, policy))[-1]
        box = [result]
        dist.broadcast_object_list(box, src=final[0])
        self._state = None
        return box[0]
