"""Fault taxonomy and seeded injection (``repro.serverless.faults``).

Four fault classes for the serverless event runtime, numpy only and
copied from the reference with its arithmetic and random streams:

  WorkerCrash     a Lambda invocation dies mid-epoch; its in-flight
                  round is lost.  What happens next is the recovery
                  policy's job (``recovery.py``): checkpoint-restore
                  re-invokes and replays, SPIRT peer takeover reassigns
                  the partition because state lives in the database.
  Straggler       a worker computes ``slowdown`` x slower inside a time
                  window (noisy neighbour / throttled vCPU).  Under
                  synchronous training every barrier inherits the
                  straggler's finish time.
  ColdStartStorm  a fraction of the fleet pays ``extra_s`` additional
                  cold start (concurrent-invocation burst, arXiv
                  2105.07806's dominant serverless overhead).
  ByzantineWorker a worker ships poisoned gradients.  Timing is
                  unaffected; correctness bookkeeping flows through the
                  runtime's robust-aggregation accounting.

``FaultPlan`` bundles specs; ``FaultPlan.random`` draws a reproducible
plan from per-class rates, and ``FaultPlan.from_trace`` resamples one
from measured empirical distributions (``traces.py``).  Every class
draws from its own ``np.random.SeedSequence`` sub-stream of the plan
seed, so no fault class's outcome can perturb another's.

The real-training analogue is :class:`ByzantineGradients`: a strategy
wrapper under which designated ranks ship gradients corrupted by any
attack of the ``repro_torch.serverless.adversarial`` registry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.core.strategies import Strategy
from repro_torch.serverless.adversarial import get_attack

if TYPE_CHECKING:                      # avoid a runtime import cycle
    from repro_torch.serverless.traces import Trace

# per-class sub-stream keys; appending is fine, reordering breaks replay
(_STREAM_CRASH, _STREAM_STRAGGLER, _STREAM_BYZANTINE, _STREAM_STORM,
 _STREAM_STORM_VICTIMS, _STREAM_COLD_START,
 _STREAM_TRACE_STRAGGLER) = range(7)


def _stream_rng(seed: int, stream: int) -> np.random.Generator:
    """Seeded generator on a sub-stream statistically disjoint from
    every other (seed, stream) pair."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(stream,)))


@dataclasses.dataclass(frozen=True)
class WorkerCrash:
    worker: int
    time_s: float


@dataclasses.dataclass(frozen=True)
class Straggler:
    worker: int
    slowdown: float = 4.0
    start_s: float = 0.0
    end_s: float = math.inf


@dataclasses.dataclass(frozen=True)
class ColdStartStorm:
    extra_s: float = 10.0
    fraction: float = 0.5


@dataclasses.dataclass(frozen=True)
class ByzantineWorker:
    worker: int
    scale: float = -10.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, fully-resolved set of faults for one epoch run.

    ``cold_start_extra_s`` is the per-worker cold-start heterogeneity
    vector (index = worker id, additive seconds on top of the plan's
    base cold start) that trace replay resamples; workers beyond its
    length — e.g. autoscaled joiners — pay no extra.
    """
    crashes: Tuple[WorkerCrash, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()
    storm: Optional[ColdStartStorm] = None
    byzantine: Tuple[ByzantineWorker, ...] = ()
    seed: int = 0
    cold_start_extra_s: Tuple[float, ...] = ()

    def storm_victims(self, n_workers: int) -> Tuple[int, ...]:
        """Seeded choice of which workers the cold-start storm hits.

        Drawn from a sub-stream of its own, so the victim set is
        independent of every other fault class's draws; ``fraction=0``
        hits nobody and ``fraction >= 1`` hits the whole fleet (k is
        clamped to [0, n_workers])."""
        if self.storm is None:
            return ()
        k = min(max(int(round(self.storm.fraction * n_workers)), 0),
                n_workers)
        if k == 0:
            return ()
        rng = _stream_rng(self.seed, _STREAM_STORM_VICTIMS)
        return tuple(sorted(
            int(v) for v in rng.choice(n_workers, size=k, replace=False)))

    def cold_extra(self, worker: int) -> float:
        """Per-worker additive cold-start seconds (trace replay)."""
        v = self.cold_start_extra_s
        return v[worker] if 0 <= worker < len(v) else 0.0

    def slowdown(self, worker: int, t: float) -> float:
        f = 1.0
        for s in self.stragglers:
            if s.worker == worker and s.start_s <= t < s.end_s:
                f = max(f, s.slowdown)
        return f

    def byzantine_workers(self) -> Tuple[int, ...]:
        return tuple(sorted({b.worker for b in self.byzantine}))

    @classmethod
    def random(cls, *, seed: int, n_workers: int, horizon_s: float,
               crash_rate: float = 0.0, straggler_rate: float = 0.0,
               byzantine_fraction: float = 0.0,
               storm_prob: float = 0.0) -> "FaultPlan":
        """Draw a reproducible plan.  Rates are expected events per
        worker per epoch (Poisson-thinned to at most one per worker);
        each fault class draws from its own (seed, class) sub-stream,
        so e.g. raising the straggler rate never shifts crash times."""
        crashes = _draw_crashes(seed, n_workers, horizon_s, crash_rate)
        rng = _stream_rng(seed, _STREAM_STRAGGLER)
        stragglers = []
        for w in range(n_workers):
            if rng.random() < straggler_rate:
                t0 = float(rng.uniform(0.0, 0.7) * horizon_s)
                stragglers.append(Straggler(
                    w, slowdown=float(rng.uniform(2.0, 6.0)),
                    start_s=t0, end_s=t0 + 0.3 * horizon_s))
        byz = _draw_byzantine(seed, n_workers, byzantine_fraction)
        storm_u = _stream_rng(seed, _STREAM_STORM).random()
        storm = ColdStartStorm() if storm_u < storm_prob else None
        return cls(crashes=crashes, stragglers=tuple(stragglers),
                   storm=storm, byzantine=byz, seed=seed)

    @classmethod
    def from_trace(cls, trace: "Trace", *, seed: int, n_workers: int,
                   horizon_s: float, base_cold_start_s: float = 0.0,
                   crash_rate: float = 0.0,
                   byzantine_fraction: float = 0.0,
                   n_spare_workers: int = 0) -> "FaultPlan":
        """Resample a replayable plan from an empirical :class:`Trace`.

        Per-worker cold-start extras and straggler windows come from the
        trace's measured distributions by inverse CDF over seeded
        sub-streams, with a *fixed* number of uniforms per worker — the
        plan is a pure function of (trace, seed, n_workers, horizon_s)
        and one worker's draws never shift a neighbour's.

        ``trace.cold_start_s`` samples are absolute measured latencies;
        each worker's extra is ``max(0, sample - base_cold_start_s)`` so
        the runtime's plan-level base cold start is not double counted.
        A straggler window's start is placed uniformly so the whole
        window fits inside the horizon (clamped to start at 0 when a
        sampled duration exceeds it).

        Crashes and byzantine workers are not part of the measured
        trace; the optional rates draw them exactly as :meth:`random`
        does, from the same sub-streams, so a trace-replayed grid and a
        synthetic one with equal seeds share crash/byzantine draws —
        any difference between the two isolates the tail behaviour.

        ``n_spare_workers`` extends the cold-start vector past the
        epoch-start fleet so workers an autoscaler spawns mid-epoch pay
        measured cold starts too (otherwise every joiner would get the
        best-case base — a bias, not a measurement).  Spares only
        append draws: the first ``n_workers`` extras, and all
        crash/straggler draws, are unchanged by the spare count.
        """
        u_cold = _stream_rng(seed, _STREAM_COLD_START).random(
            n_workers + n_spare_workers)
        extras = tuple(max(0.0, float(c) - base_cold_start_s)
                       for c in trace.sample("cold_start_s", u_cold))
        u = _stream_rng(seed, _STREAM_TRACE_STRAGGLER).random(
            (n_workers, 4))
        stragglers = []
        for w in range(n_workers):
            occur, u_slow, u_dur, u_start = u[w]
            if occur < trace.straggler_prob:
                dur = float(trace.sample("straggler_duration_s", u_dur))
                t0 = float(u_start) * max(horizon_s - dur, 0.0)
                stragglers.append(Straggler(
                    w,
                    slowdown=float(trace.sample("straggler_slowdown",
                                                u_slow)),
                    start_s=t0, end_s=t0 + dur))
        return cls(crashes=_draw_crashes(seed, n_workers, horizon_s,
                                         crash_rate),
                   stragglers=tuple(stragglers), storm=None,
                   byzantine=_draw_byzantine(seed, n_workers,
                                             byzantine_fraction),
                   seed=seed, cold_start_extra_s=extras)


def _draw_crashes(seed: int, n_workers: int, horizon_s: float,
                  crash_rate: float) -> Tuple[WorkerCrash, ...]:
    rng = _stream_rng(seed, _STREAM_CRASH)
    crashes = []
    for w in range(n_workers):
        if rng.random() < crash_rate:
            crashes.append(WorkerCrash(w, float(
                rng.uniform(0.1, 0.9) * horizon_s)))
    return tuple(crashes)


def _draw_byzantine(seed: int, n_workers: int,
                    fraction: float) -> Tuple[ByzantineWorker, ...]:
    # same [0, n_workers] clamp as storm_victims: fraction > 1 must not
    # ask choice() for a larger sample than the fleet
    n_byz = min(max(int(round(fraction * n_workers)), 0), n_workers)
    if n_byz <= 0:
        return ()
    rng = _stream_rng(seed, _STREAM_BYZANTINE)
    return tuple(ByzantineWorker(int(w))
                 for w in rng.choice(n_workers, size=n_byz, replace=False))




@dataclasses.dataclass(frozen=True)
class ByzantineGradients(Strategy):
    """Wrap any Strategy; the ranks in ``workers`` ship corrupted
    gradients.

    The corruption runs before the inner strategy's collective, so a
    robust aggregator downstream sees exactly what a poisoned worker
    would have pushed.  ``attack`` names a registered
    :class:`~repro_torch.serverless.adversarial.AttackSpec`; ``scale`` is
    its magnitude (``None``: the attack's default) and ``seed`` feeds the
    stochastic attacks' per-rank noise streams.

    Every argument is validated here, at construction: a bad worker set,
    an unknown attack, a non-finite magnitude, or a byzantine majority
    (``len(workers) > (n_workers-1)/2`` when the fleet size is declared).
    The strategy state is ``(sync-step counter, inner state)``.
    """
    name: str = "byzantine"
    inner: Optional[Strategy] = None
    workers: Tuple[int, ...] = (0,)
    attack: str = "scale"
    scale: Optional[float] = None      # None => the attack's default
    seed: int = 0                      # stochastic attacks' noise stream
    n_workers: Optional[int] = None    # declared fleet size (validation)

    def __post_init__(self):
        if self.inner is None:
            raise ValueError("ByzantineGradients needs an inner strategy")
        # the wrapper rides the inner strategy's accumulation schedule
        # (SPIRT etc.); a conflicting explicit value would silently
        # change training semantics, so reject it
        if self.microbatches not in (1, self.inner.microbatches):
            raise ValueError(
                f"microbatches={self.microbatches} conflicts with "
                f"inner.microbatches={self.inner.microbatches}; set it on "
                "the inner strategy instead")
        object.__setattr__(self, "microbatches", self.inner.microbatches)
        workers = tuple(self.workers)
        if not workers:
            raise ValueError(
                "ByzantineGradients needs a non-empty workers tuple "
                "(an attack with no attackers is a plain wrapper bug)")
        if len(set(workers)) != len(workers) \
                or any(not isinstance(w, (int, np.integer)) or w < 0
                       for w in workers):
            raise ValueError(
                f"workers must be distinct non-negative ints, got "
                f"{workers!r}")
        object.__setattr__(self, "workers", workers)
        if self.n_workers is not None:
            if self.n_workers < 1:
                raise ValueError(
                    f"n_workers must be >= 1, got {self.n_workers}")
            if any(w >= self.n_workers for w in workers):
                raise ValueError(
                    f"workers {workers!r} out of range for a fleet of "
                    f"{self.n_workers}")
            # a corrupted majority out-votes every robust statistic
            max_byz = (self.n_workers - 1) // 2
            if len(workers) > max_byz:
                raise ValueError(
                    f"{len(workers)} byzantine workers of {self.n_workers}"
                    f" is a corrupted majority; at most {max_byz} "
                    f"(fraction <= (W-1)/2W) are aggregatable")
        spec = get_attack(self.attack)   # unknown names raise here
        scale = spec.default_scale if self.scale is None else self.scale
        if not math.isfinite(scale):
            raise ValueError(f"attack scale must be finite, got {scale}")
        object.__setattr__(self, "scale", float(scale))

    def init_state(self, grads_like):
        return (0, self.inner.init_state(grads_like))

    def sync(self, grads, state, group=None):
        step, inner_state = state
        bad = dist.get_rank(group) in self.workers
        corrupted = get_attack(self.attack).torch_apply(
            grads, bad, group, self.scale, self.seed, step)
        out, inner_state, info = self.inner.sync(corrupted, inner_state,
                                                 group)
        return out, (step + 1, inner_state), info

    def comm_bytes(self, grads_like, n_workers):
        return self.inner.comm_bytes(grads_like, n_workers)
