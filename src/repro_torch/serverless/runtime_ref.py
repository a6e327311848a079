"""Reference discrete-event serverless training runtime (frozen).

This is the original closure-per-event engine, kept verbatim as the
semantic reference for the optimized ``repro_torch.serverless.runtime``: the
parity suite (``tests/test_torch_serverless.py``) asserts the
optimized engine reproduces this engine's ``RuntimeReport`` numbers
*exactly* on seeded fault scenarios.  Do not optimize
this file — its slowness is the baseline being measured.

Event model
-----------
A single priority queue of ``(time, seq, callback)`` events drives the
whole fleet.  Each worker is a lifecycle state machine

    COLD_START -> STATE_LOAD -> COMPUTE -> SYNC -> (barrier) -> UPDATE
         ^                                                        |
         |                 next round / re-invocation             |
         +--------------------------------------------------------+

whose stage *durations* come from :func:`repro_torch.serverless.simulator.
round_plan` — the identical closed-form terms the analytic
``simulate_epoch`` sums.  With homogeneous fault-free workers every
barrier is free, so the event makespan reproduces the analytic
per-worker time exactly; ``simulate_epoch`` is therefore the engine's
validated fast path, and everything the analytic model *cannot*
express — crashes, stragglers, cold-start storms, byzantine gradients,
elastic fleets — is layered on top as events.

Synchronous-training semantics: a round's barrier releases when every
*expected* worker has finished its sync stage (and any recovery holds
have cleared); all workers then apply the update and enter the next
round.  The epoch's work is a shared pool of ``W0 x total_batches``
minibatches, so an autoscaler that grows the fleet genuinely shortens
the epoch (fewer rounds), and peer takeover after a crash genuinely
lengthens per-worker rounds (survivors absorb the partition).

Fault taxonomy lives in ``faults.py``; recovery semantics (checkpoint
replay vs SPIRT in-database peer takeover) in ``recovery.py``; scaling
policies in ``autoscale.py``.  Billing follows
``repro_torch.costmodel.pricing``: Lambda workers bill GB-seconds for their
entire invocation wall-clock (barrier waits included — stalls are not
free, which is exactly why stragglers show up in the cost column), the
GPU baseline bills instance-hours for the makespan.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.costmodel import pricing
from repro_torch.serverless.faults import FaultPlan
from repro_torch.serverless.recovery import (CheckpointRestore, PeerTakeover,
                                             RecoveryEvent, RecoveryPolicy)
from repro_torch.serverless.simulator import (RoundPlan, ServerlessSetup,
                                              round_plan)

# worker lifecycle states
COLD_START, STATE_LOAD, COMPUTE, SYNC, WAIT_BARRIER, UPDATE, DONE, DEAD = (
    "cold_start", "state_load", "compute", "sync", "wait_barrier",
    "update", "done", "dead")


@dataclasses.dataclass
class _Worker:
    id: int
    state: str = COLD_START
    gen: int = 0                 # bumped on crash; stale events ignored
    alive: bool = True
    spawn_time: float = 0.0
    done_time: Optional[float] = None
    joined: bool = False         # finished cold start + first load
    work_mult: float = 1.0       # >1 after absorbing a peer's partition
    replay_rounds: int = 0       # pending checkpoint replay after restore
    byzantine: bool = False
    restoring: bool = False      # crashed, checkpoint-restore in flight
    initial: bool = False        # part of the epoch-start fleet
    pending_recovery: Optional[RecoveryEvent] = None
    # per-stage busy-time accounting (excludes barrier waits)
    stage_s: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"cold_start": 0.0, "fetch": 0.0,
                                 "compute": 0.0, "sync": 0.0,
                                 "update": 0.0, "wait": 0.0, "replay": 0.0})
    _stage_started: float = 0.0


@dataclasses.dataclass
class RuntimeReport:
    """What one event-driven epoch produced."""
    arch: str
    makespan_s: float
    analytic_s: float                  # simulate_epoch's fault-free time
    rounds: int
    work_done_batches: float
    n_workers_start: int
    n_workers_peak: int
    n_workers_end: int
    total_cost: float
    stage_totals: Dict[str, float]     # summed across workers
    recoveries: List[RecoveryEvent]
    poisoned_updates: int              # byzantine contributions applied
    masked_updates: int                # byzantine contributions masked
    scale_events: List[Tuple[float, int]]   # (time, delta)
    timeline: List[Tuple[float, int, str]]  # (time, worker, event)

    @property
    def time_to_recover_s(self) -> float:
        return max((r.time_to_recover_s for r in self.recoveries),
                   default=0.0)

    @property
    def overhead_vs_analytic(self) -> float:
        return self.makespan_s / self.analytic_s - 1.0


class EventRuntime:
    """Heap-scheduled execution of one epoch of a :class:`RoundPlan`."""

    def __init__(self, plan: RoundPlan, setup: ServerlessSetup, *,
                 faults: Optional[FaultPlan] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 autoscaler=None, robust_trim: int = 0,
                 max_timeline: int = 4096):
        self.plan = plan
        self.setup = setup
        self.faults = faults or FaultPlan()
        self.recovery = recovery or CheckpointRestore()
        self.autoscaler = autoscaler
        self.robust_trim = robust_trim
        self.max_timeline = max_timeline

        self.t = 0.0
        self._heap: List[Tuple[float, int, int, int, Callable]] = []
        self._seq = itertools.count()
        self.workers: List[_Worker] = []
        self.round_idx = 0
        # shared epoch work pool: W0 workers x per-worker batches
        self.pool = plan.n_workers * plan.total_batches
        self.arrived: set = set()
        self.barrier_not_before = 0.0
        self.recoveries: List[RecoveryEvent] = []
        self.scale_events: List[Tuple[float, int]] = []
        self.timeline: List[Tuple[float, int, str]] = []
        self.poisoned = 0
        self.masked = 0
        self._pending_scale_in = 0

    # ------------------------------------------------------------ events
    def _schedule(self, t: float, w: Optional[_Worker], fn: Callable):
        gen = w.gen if w is not None else -1
        wid = w.id if w is not None else -1
        heapq.heappush(self._heap, (t, next(self._seq), wid, gen, fn))

    def _log(self, w: int, event: str):
        if len(self.timeline) < self.max_timeline:
            self.timeline.append((self.t, w, event))

    # ------------------------------------------------------------ stages
    def _begin_stage(self, w: _Worker, state: str):
        w.state = state
        w._stage_started = self.t

    def _end_stage(self, w: _Worker, key: str):
        w.stage_s[key] += self.t - w._stage_started

    def _spawn_worker(self, t: float, *, byzantine: bool = False,
                      replay_rounds: int = 0,
                      existing: Optional[_Worker] = None) -> _Worker:
        """(Re-)invoke a worker: cold start, then first state load."""
        if existing is None:
            w = _Worker(id=len(self.workers), byzantine=byzantine)
            self.workers.append(w)
        else:
            w = existing
            w.alive, w.state = True, COLD_START
        w.spawn_time = t if existing is None else w.spawn_time
        w.replay_rounds = replay_rounds
        cold = self.plan.cold_start_s
        if w.id in self._storm_victims:
            cold += self.faults.storm.extra_s
        self._log(w.id, f"invoke(cold={cold:.2f}s)")

        def after_cold():
            w.stage_s["cold_start"] += cold
            self._begin_load(w)
        self._begin_stage(w, COLD_START)
        self._schedule(t + cold, w, after_cold)
        return w

    def _begin_load(self, w: _Worker):
        self._begin_stage(w, STATE_LOAD)
        dur = self.plan.fetch_s
        if w.replay_rounds:
            # replay compute for rounds lost since the last checkpoint
            dur += w.replay_rounds * (self.plan.batches_per_round
                                      * self.plan.compute_s_per_batch)

        def loaded():
            w.stage_s["fetch"] += self.plan.fetch_s
            if w.replay_rounds:
                w.stage_s["replay"] += dur - self.plan.fetch_s
                self._log(w.id, f"replayed {w.replay_rounds} rounds")
                w.replay_rounds = 0
            w.joined = True
            self._begin_compute(w)
        self._schedule(self.t + dur, w, loaded)

    def _round_fetch_needed(self) -> bool:
        return (not self.plan.fetch_first_round_only) and self.round_idx > 0

    def _begin_round(self, w: _Worker):
        """Top of a round for an already-joined worker."""
        if self._round_fetch_needed():
            self._begin_stage(w, STATE_LOAD)

            def loaded():
                self._end_stage(w, "fetch")
                self._begin_compute(w)
            self._schedule(self.t + self.plan.fetch_s, w, loaded)
        else:
            self._begin_compute(w)

    def _begin_compute(self, w: _Worker):
        self._begin_stage(w, COMPUTE)
        slow = self.faults.slowdown(w.id, self.t)
        dur = (self.plan.batches_per_round * w.work_mult
               * self.plan.compute_s_per_batch * slow)
        if slow > 1.0:
            self._log(w.id, f"straggling x{slow:.1f}")

        def computed():
            self._end_stage(w, "compute")
            self._begin_sync(w)
        self._schedule(self.t + dur, w, computed)

    def _begin_sync(self, w: _Worker):
        self._begin_stage(w, SYNC)

        def synced():
            self._end_stage(w, "sync")
            w.state = WAIT_BARRIER
            w._stage_started = self.t
            if w.pending_recovery is not None:
                # back at the barrier: recovery complete
                w.pending_recovery.rejoined_time_s = self.t
                w.pending_recovery = None
                w.restoring = False
            self.arrived.add(w.id)
            self._maybe_release_barrier()
        self._schedule(self.t + self.plan.sync_s * w.work_mult, w, synced)

    # ------------------------------------------------------------ barrier
    def _expected(self) -> List[_Worker]:
        """Workers the current barrier must wait for.  A checkpoint-
        restoring worker stays expected (synchronous training cannot
        proceed without its gradient — the fleet stalls, which is the
        measured time-to-recover); a taken-over worker does not.  The
        epoch-start fleet is expected from t=0 (a cold-start storm gates
        the first barrier); autoscaled workers only once they join."""
        return [w for w in self.workers
                if (w.alive or w.restoring)
                and (w.joined or w.initial)
                and w.done_time is None]

    def _maybe_release_barrier(self):
        expected = self._expected()
        if not expected or any(w.id not in self.arrived for w in expected):
            return
        release_at = max(self.t, self.barrier_not_before)
        self._schedule(release_at, None, self._release_barrier)

    def _release_barrier(self):
        expected = self._expected()
        if any(w.id not in self.arrived for w in expected):
            return                      # a recovery hold re-queued us
        if self.barrier_not_before > self.t:
            self._schedule(self.barrier_not_before, None,
                           self._release_barrier)
            return
        # byzantine accounting for this aggregation round; masking needs
        # a feasible trimmed aggregate (W > 2*trim, see recovery.py) AND
        # no more byzantine contributions than the trim width
        n_byz = sum(1 for w in expected if w.byzantine)
        if n_byz:
            feasible = len(expected) > 2 * self.robust_trim
            if feasible and n_byz <= self.robust_trim:
                self.masked += n_byz
            else:
                self.poisoned += n_byz
        batches = sum(self.plan.batches_per_round * w.work_mult
                      for w in expected)
        self.pool -= batches
        self.round_idx += 1
        self.arrived.clear()
        self._log(-1, f"barrier round={self.round_idx} "
                      f"workers={len(expected)}")
        for w in expected:
            w.stage_s["wait"] += self.t - w._stage_started
            self._begin_update(w)
        if self.autoscaler is not None:
            self._autoscale_hook()

    def _begin_update(self, w: _Worker):
        self._begin_stage(w, UPDATE)

        def updated():
            self._end_stage(w, "update")
            if self.pool > 1e-9 and not self._retire_if_requested(w):
                self._begin_round(w)
            elif w.alive and w.done_time is None:
                w.state = DONE
                w.done_time = self.t
                self._log(w.id, "done")
        self._schedule(self.t + self.plan.update_s, w, updated)

    def _retire_if_requested(self, w: _Worker) -> bool:
        if self._pending_scale_in > 0 and len(self._expected()) > 1:
            self._pending_scale_in -= 1
            w.alive = False
            w.state = DONE
            w.done_time = self.t
            self._log(w.id, "scaled in")
            return True
        return False

    # ------------------------------------------------------------ faults
    def _on_crash(self, w: _Worker, t: float):
        if not w.alive or w.done_time is not None:
            return
        w.gen += 1                      # invalidate in-flight events
        w.alive = False
        w.state = DEAD
        self.arrived.discard(w.id)
        self._log(w.id, "CRASH")
        ch = self.setup.channel
        if isinstance(self.recovery, PeerTakeover):
            # survivors fetch the dead worker's in-DB partition and
            # absorb its share of the remaining work; the dead Lambda
            # stops billing at the crash
            w.done_time = t
            rejoin = (t + self.recovery.detection_s
                      + ch.transfer(self.plan.model_bytes, ops=1))
            survivors = [v for v in self.workers
                         if v.alive and v.id != w.id]
            if survivors:
                extra = w.work_mult / len(survivors)
                for v in survivors:
                    v.work_mult += extra
            self.barrier_not_before = max(self.barrier_not_before, rejoin)
            self.recoveries.append(RecoveryEvent(
                worker=w.id, crash_time_s=t, rejoined_time_s=rejoin,
                mode="takeover"))
            self._log(w.id, f"takeover by {len(survivors)} peers")
            self._schedule(rejoin, None, self._maybe_release_barrier)
        else:
            replay = self.recovery.replay_rounds(self.round_idx)
            rec = RecoveryEvent(worker=w.id, crash_time_s=t,
                                rejoined_time_s=math.nan, mode="restore")
            self.recoveries.append(rec)
            w.restoring = True
            w.pending_recovery = rec

            def respawn():
                self._spawn_worker(self.t, replay_rounds=replay,
                                   existing=w)
            self._schedule(t + self.recovery.detection_s, None, respawn)

    # ------------------------------------------------------------ scaling
    def _autoscale_hook(self):
        expected = self._expected()
        ideal = (self.plan.fetch_s * (0 if self.plan.fetch_first_round_only
                                      else 1)
                 + self.plan.batches_per_round
                 * self.plan.compute_s_per_batch
                 + self.plan.sync_s + self.plan.update_s)
        delta = self.autoscaler.observe(
            round_idx=self.round_idx, now_s=self.t,
            active_workers=len(expected),
            remaining_batches=max(self.pool, 0.0),
            batches_per_round=self.plan.batches_per_round,
            ideal_round_s=ideal)
        if delta > 0:
            for _ in range(delta):
                self._log(-1, "scale out +1")
                self._spawn_worker(self.t)
            self.scale_events.append((self.t, delta))
        elif delta < 0:
            self._pending_scale_in += -delta
            self.scale_events.append((self.t, delta))

    # --------------------------------------------------------- main loop
    def run(self) -> RuntimeReport:
        plan, setup = self.plan, self.setup
        self._storm_victims = set(self.faults.storm_victims(plan.n_workers))
        byz = set(self.faults.byzantine_workers())
        for i in range(plan.n_workers):
            self._spawn_worker(0.0, byzantine=i in byz).initial = True
        for c in self.faults.crashes:
            if c.worker < len(self.workers):
                w = self.workers[c.worker]
                self._schedule(c.time_s, None,
                               lambda w=w, t=c.time_s:
                               self._on_crash(w, max(t, self.t)))

        guard = 0
        while self._heap:
            t, _, wid, gen, fn = heapq.heappop(self._heap)
            if wid >= 0 and self.workers[wid].gen != gen:
                continue                # event from a crashed incarnation
            self.t = max(self.t, t)
            fn()
            guard += 1
            if guard > 2_000_000:
                raise RuntimeError("event-loop runaway (>2M events)")

        makespan = max((w.done_time for w in self.workers
                        if w.done_time is not None), default=self.t)
        # simulate_epoch's closed form, from the same plan terms
        analytic = (setup.cold_start_s
                    + plan.fetch_s * (1 if plan.fetch_first_round_only
                                      else plan.n_rounds)
                    + plan.total_batches * plan.compute_s_per_batch
                    + plan.n_rounds * (plan.sync_s + plan.update_s))

        # billing: lambda bills each worker's invocation wall-clock;
        # the GPU baseline bills instances for the whole makespan
        if plan.arch == "gpu":
            total_cost = pricing.gpu_cost(makespan,
                                          n_instances=len(self.workers))
        else:
            total_cost = sum(
                pricing.lambda_cost((w.done_time or makespan)
                                    - w.spawn_time, plan.ram_gb)
                for w in self.workers)

        stage_totals: Dict[str, float] = {}
        for w in self.workers:
            for k, v in w.stage_s.items():
                stage_totals[k] = stage_totals.get(k, 0.0) + v
        alive_end = sum(1 for w in self.workers if w.alive)
        return RuntimeReport(
            arch=plan.arch, makespan_s=makespan, analytic_s=analytic,
            rounds=self.round_idx,
            work_done_batches=plan.n_workers * plan.total_batches
            - max(self.pool, 0.0),
            n_workers_start=plan.n_workers,
            n_workers_peak=len(self.workers),
            n_workers_end=alive_end, total_cost=total_cost,
            stage_totals=stage_totals, recoveries=self.recoveries,
            poisoned_updates=self.poisoned, masked_updates=self.masked,
            scale_events=self.scale_events, timeline=self.timeline)


def run_event_epoch(arch: str, *, n_params: int, compute_s_per_batch: float,
                    setup: ServerlessSetup = ServerlessSetup(),
                    significant_fraction: float = 0.3,
                    accumulation: int = 24,
                    faults: Optional[FaultPlan] = None,
                    recovery: Optional[RecoveryPolicy] = None,
                    autoscaler=None, robust_trim: int = 0) -> RuntimeReport:
    """One event-driven epoch; mirrors ``simulate_epoch``'s signature."""
    plan = round_plan(arch, n_params=n_params,
                      compute_s_per_batch=compute_s_per_batch, setup=setup,
                      significant_fraction=significant_fraction,
                      accumulation=accumulation)
    return EventRuntime(plan, setup, faults=faults, recovery=recovery,
                        autoscaler=autoscaler,
                        robust_trim=robust_trim).run()
