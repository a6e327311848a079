"""Discrete-event serverless training runtime (optimized hot path).

Event model
-----------
A single priority queue of ``(time, seq, worker, gen, opcode, arg)``
events drives the whole fleet.  Each worker is a lifecycle state machine

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

Hot-path design — this engine exists to be swept
thousands of times per chart by ``repro_torch.serverless.sweep``, so the
per-event machinery of the reference implementation
(``runtime_ref.py``, kept frozen for regression) is replaced by:

  * ``__slots__`` workers with plain float stage accumulators instead
    of a per-worker dict;
  * integer event opcodes dispatched through a bound-method table —
    no per-event closure allocation;
  * timeline logging off by default (``max_timeline=0``); enabling it
    also disables round batching so the recorded timeline has full
    per-event granularity;
  * a lazy heap: when nothing can interleave with the next round (no
    scheduled crash/respawn/rejoin/spawn at or before the projected
    barrier release, no restoring worker, no pending scale-in), the
    whole update -> fetch -> compute -> sync -> barrier sequence for
    every worker is executed inline with the *same floating-point
    operation order* as the event path, so ``RuntimeReport`` numbers
    are byte-identical to the reference engine
    (``tests/test_torch_serverless.py`` asserts this).

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
import itertools
import math
from heapq import heappop, heappush
from typing import Dict, List, Optional, Tuple

from repro_torch.guards import no_tracer_fields
from repro_torch.serverless.archs import get_arch
from repro_torch.serverless.faults import FaultPlan
from repro_torch.serverless.recovery import (CheckpointRestore, PeerTakeover,
                                             RecoveryEvent, RecoveryPolicy)
from repro_torch.serverless.simulator import (RoundPlan, ServerlessSetup,
                                              round_plan)


def resolve_recovery(arch: str, name: str, *,
                     checkpoint_every: int = 4) -> RecoveryPolicy:
    """THE string -> :class:`RecoveryPolicy` mapping (one place —
    :func:`run_event_epoch`, the sweep engine and the benchmarks all
    route through here).  ``"auto"`` resolves the architecture's own
    :class:`~repro_torch.serverless.archs.ArchSpec` default: in-DB-state
    designs (SPIRT and its hybrids) take over from peers, everything
    else re-invokes and replays from a checkpoint."""
    if name == "auto":
        name = get_arch(arch).default_recovery
    if name == "takeover":
        return PeerTakeover()
    if name == "restore":
        return CheckpointRestore(checkpoint_every=checkpoint_every)
    raise ValueError(f"unknown recovery {name!r}; expected 'auto', "
                     "'restore', 'takeover' or a RecoveryPolicy")


def default_recovery(arch: str, *,
                     checkpoint_every: int = 4) -> RecoveryPolicy:
    """The architecture's ``recovery="auto"`` policy (see
    :func:`resolve_recovery`)."""
    return resolve_recovery(arch, "auto",
                            checkpoint_every=checkpoint_every)

# worker lifecycle states
COLD_START, STATE_LOAD, COMPUTE, SYNC, WAIT_BARRIER, UPDATE, DONE, DEAD = (
    "cold_start", "state_load", "compute", "sync", "wait_barrier",
    "update", "done", "dead")

# integer event opcodes; heap entries are (t, seq, wid, gen, op, arg)
(_OP_COLD_DONE, _OP_LOADED, _OP_ROUND_LOADED, _OP_COMPUTED, _OP_SYNCED,
 _OP_UPDATED, _OP_RELEASE, _OP_MAYBE_RELEASE, _OP_CRASH,
 _OP_RESPAWN) = range(10)

# _fast_round outcomes
_CLASSIC, _EPOCH_DONE, _NEXT_BARRIER = 0, 1, 2


class _Worker:
    """Per-worker state; slotted — this is the hot allocation."""
    __slots__ = ("id", "state", "gen", "alive", "spawn_time", "done_time",
                 "joined", "work_mult", "replay_rounds", "byzantine",
                 "restoring", "initial", "pending_recovery",
                 "async_reserve",
                 "s_cold", "s_fetch", "s_compute", "s_sync", "s_update",
                 "s_wait", "s_replay", "_stage_started")

    def __init__(self, wid: int, byzantine: bool = False):
        self.id = wid
        self.state = COLD_START
        self.gen = 0                 # bumped on crash; stale events ignored
        self.alive = True
        self.spawn_time = 0.0
        self.done_time: Optional[float] = None
        self.joined = False          # finished cold start + first load
        self.work_mult = 1.0         # >1 after absorbing a peer's partition
        self.replay_rounds = 0       # pending checkpoint replay after restore
        self.byzantine = byzantine
        self.restoring = False       # crashed, checkpoint-restore in flight
        self.initial = False         # part of the epoch-start fleet
        self.pending_recovery: Optional[RecoveryEvent] = None
        self.async_reserve = 0.0     # in-flight pool claim (barrier-free)
        # per-stage busy-time accounting (excludes barrier waits)
        self.s_cold = 0.0
        self.s_fetch = 0.0
        self.s_compute = 0.0
        self.s_sync = 0.0
        self.s_update = 0.0
        self.s_wait = 0.0
        self.s_replay = 0.0
        self._stage_started = 0.0


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

    def __post_init__(self):
        # runtime backstop: a report built from tensors would tie device
        # or autograd values into golden snapshots
        no_tracer_fields(self)

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
                 max_timeline: int = 0):
        self.plan = plan
        self.setup = setup
        self.faults = faults or FaultPlan()
        self.recovery = recovery or CheckpointRestore()
        self.autoscaler = autoscaler
        self.robust_trim = robust_trim
        self.max_timeline = max_timeline
        self._tl = max_timeline > 0    # timeline off by default (hot path)

        self.t = 0.0
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self.workers: List[_Worker] = []
        self.round_idx = 0
        # shared epoch work pool: W0 workers x per-worker batches
        self.pool = plan.n_workers * plan.total_batches
        self.arrived: set = set()
        self.barrier_not_before = 0.0
        # barrier-free plans: committed syncs since the last
        # fleet-equivalent round tick (n_workers commits ~ one round)
        self._async_syncs = 0
        # barrier-free mode: pool batches claimed by in-flight rounds —
        # a worker may only start a round against pool MINUS what its
        # peers have already claimed, or cold-start spread lets fast
        # workers overdraft the epoch with phantom rounds
        self._async_reserved = 0.0
        self.recoveries: List[RecoveryEvent] = []
        self.scale_events: List[Tuple[float, int]] = []
        self.timeline: List[Tuple[float, int, str]] = []
        self.poisoned = 0
        self.masked = 0
        self._pending_scale_in = 0
        # hot-path indices: per-worker straggler lists (preserving the
        # FaultPlan tuple order so max-of-overlaps matches bit-for-bit),
        # byzantine presence, and work_mult uniformity (falsified by
        # peer takeover, which skews survivor partitions)
        self._strag_by_worker: Dict[int, list] = {}
        for s in self.faults.stragglers:
            self._strag_by_worker.setdefault(s.worker, []).append(s)
        self._has_byz = bool(self.faults.byzantine)
        self._uniform = True

    # ------------------------------------------------------------ events
    def _schedule(self, t: float, w: Optional[_Worker], op: int, arg=None):
        if w is None:
            heappush(self._heap, (t, next(self._seq), -1, -1, op, arg))
        else:
            heappush(self._heap, (t, next(self._seq), w.id, w.gen, op,
                                  arg))

    def _log(self, w: int, event: str):
        if len(self.timeline) < self.max_timeline:
            self.timeline.append((self.t, w, event))

    # ------------------------------------------------------------ stages
    def _spawn_worker(self, t: float, *, byzantine: bool = False,
                      replay_rounds: int = 0,
                      existing: Optional[_Worker] = None) -> _Worker:
        """(Re-)invoke a worker: cold start, then first state load."""
        if existing is None:
            w = _Worker(len(self.workers), byzantine)
            self.workers.append(w)
        else:
            w = existing
            w.alive, w.state = True, COLD_START
        w.spawn_time = t if existing is None else w.spawn_time
        w.replay_rounds = replay_rounds
        # heterogeneous cold starts: the trace-replay per-worker vector
        # (every (re-)invocation of a worker id re-pays its extra, like
        # a storm victim re-pays the storm's) on top of the storm
        cold = self.plan.cold_start_s + self.faults.cold_extra(w.id)
        if w.id in self._storm_victims:
            cold += self.faults.storm.extra_s
        if not self.plan.barrier:
            # claim the first round's quantum at invocation: a peer
            # finishing early must not overdraft the pool share of a
            # worker still paying its cold start
            self._async_reserved -= w.async_reserve
            w.async_reserve = self.plan.batches_per_round * w.work_mult
            self._async_reserved += w.async_reserve
        if self._tl:
            self._log(w.id, f"invoke(cold={cold:.2f}s)")
        w.state = COLD_START
        w._stage_started = self.t
        self._schedule(t + cold, w, _OP_COLD_DONE, cold)
        return w

    def _h_cold_done(self, w: _Worker, cold):
        w.s_cold += cold
        self._begin_load(w)

    def _begin_load(self, w: _Worker):
        w.state = STATE_LOAD
        w._stage_started = self.t
        dur = self.plan.fetch_s
        if w.replay_rounds:
            # replay compute for rounds lost since the last checkpoint
            dur += w.replay_rounds * (self.plan.batches_per_round
                                      * self.plan.compute_s_per_batch)
        self._schedule(self.t + dur, w, _OP_LOADED, dur)

    def _h_loaded(self, w: _Worker, dur):
        w.s_fetch += self.plan.fetch_s
        if w.replay_rounds:
            w.s_replay += dur - self.plan.fetch_s
            if self._tl:
                self._log(w.id, f"replayed {w.replay_rounds} rounds")
            w.replay_rounds = 0
        w.joined = True
        self._begin_compute(w)

    def _round_fetch_needed(self) -> bool:
        if self.plan.fetch_first_round_only:
            return False
        # barrier mode only reaches _begin_round again after round 0's
        # barrier (round_idx >= 1); a barrier-free worker re-fetches at
        # the top of every self-paced round
        return self.round_idx > 0 or not self.plan.barrier

    def _begin_round(self, w: _Worker):
        """Top of a round for an already-joined worker."""
        if self._round_fetch_needed():
            w.state = STATE_LOAD
            w._stage_started = self.t
            self._schedule(self.t + self.plan.fetch_s, w, _OP_ROUND_LOADED)
        else:
            self._begin_compute(w)

    def _h_round_loaded(self, w: _Worker, arg):
        w.s_fetch += self.t - w._stage_started
        self._begin_compute(w)

    def _begin_compute(self, w: _Worker):
        if not self.plan.barrier:
            # claim this round's quantum up front (released at commit,
            # or at crash for a round that will never commit); the
            # re-subtract makes the claim idempotent across the
            # fetch -> compute hand-off
            self._async_reserved -= w.async_reserve
            w.async_reserve = self.plan.batches_per_round * w.work_mult
            self._async_reserved += w.async_reserve
        w.state = COMPUTE
        w._stage_started = self.t
        slow = self.faults.slowdown(w.id, self.t)
        dur = (self.plan.batches_per_round * w.work_mult
               * self.plan.compute_s_per_batch * slow)
        if slow > 1.0 and self._tl:
            self._log(w.id, f"straggling x{slow:.1f}")
        self._schedule(self.t + dur, w, _OP_COMPUTED)

    def _h_computed(self, w: _Worker, arg):
        w.s_compute += self.t - w._stage_started
        self._begin_sync(w)

    def _begin_sync(self, w: _Worker):
        w.state = SYNC
        w._stage_started = self.t
        self._schedule(self.t + self.plan.sync_s * w.work_mult, w,
                       _OP_SYNCED)

    def _h_synced(self, w: _Worker, arg):
        w.s_sync += self.t - w._stage_started
        if not self.plan.barrier:
            self._commit_async_sync(w)
            return
        w.state = WAIT_BARRIER
        w._stage_started = self.t
        if w.pending_recovery is not None:
            # back at the barrier: recovery complete
            w.pending_recovery.rejoined_time_s = self.t
            w.pending_recovery = None
            w.restoring = False
        self.arrived.add(w.id)
        self._maybe_release_barrier()

    def _commit_async_sync(self, w: _Worker):
        """Barrier-free commit: the worker's push lands in the shared
        store immediately — no WAIT_BARRIER state, no fleet stall.  The
        pool drains per commit (instead of per barrier round), and
        every ``n_workers`` commits count as one fleet-equivalent round
        for reporting and autoscaler pacing."""
        if w.pending_recovery is not None:
            # first committed sync after the respawn: recovery complete
            w.pending_recovery.rejoined_time_s = self.t
            w.pending_recovery = None
            w.restoring = False
        if self._has_byz and w.byzantine:
            # the in-DB aggregate masks this worker's contribution only
            # when the robust statistic is feasible over the live fleet
            # (same feasibility rule as the barrier path)
            expected = self._expected()
            n_byz = sum(1 for v in expected if v.byzantine)
            if len(expected) > 2 * self.robust_trim \
                    and n_byz <= self.robust_trim:
                self.masked += 1
            else:
                self.poisoned += 1
        # drain exactly what this round claimed at its start (work_mult
        # changes from a mid-round takeover apply from the next round)
        self.pool -= w.async_reserve
        self._async_reserved -= w.async_reserve
        w.async_reserve = 0.0
        self._async_syncs += 1
        if self._async_syncs % self.plan.n_workers == 0:
            self.round_idx += 1
            if self._tl:
                self._log(-1, f"async round={self.round_idx} "
                              f"commits={self._async_syncs}")
            if self.autoscaler is not None:
                self._autoscale_hook()
        self._begin_update(w)

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
        if not expected:
            return
        arrived = self.arrived
        for w in expected:
            if w.id not in arrived:
                return
        release_at = max(self.t, self.barrier_not_before)
        self._schedule(release_at, None, _OP_RELEASE)

    def _h_release(self, w, arg):
        expected = self._expected()
        for v in expected:
            if v.id not in self.arrived:
                return                  # a recovery hold re-queued us
        if self.barrier_not_before > self.t:
            self._schedule(self.barrier_not_before, None, _OP_RELEASE)
            return
        self._barrier_rounds()

    def _barrier_rounds(self):
        """Process the barrier at ``self.t``, then keep executing whole
        rounds inline for as long as :meth:`_fast_round` allows; fall
        back to per-event scheduling the moment anything (fault,
        respawn, rejoin hold, scale event, restoring worker) could
        interleave."""
        plan = self.plan
        # a committed inline round processes no events, so the expected
        # fleet (and therefore its per-round work quantum) is invariant
        # across loop iterations — compute both once
        expected = self._expected()
        batches = sum(plan.batches_per_round * v.work_mult
                      for v in expected)
        while True:
            # byzantine accounting for this aggregation round; masking
            # needs a feasible trimmed aggregate (W > 2*trim, see
            # recovery.py) AND no more byzantine contributions than the
            # trim width
            if self._has_byz:
                n_byz = 0
                for v in expected:
                    if v.byzantine:
                        n_byz += 1
                if n_byz:
                    feasible = len(expected) > 2 * self.robust_trim
                    if feasible and n_byz <= self.robust_trim:
                        self.masked += n_byz
                    else:
                        self.poisoned += n_byz
            self.pool -= batches
            self.round_idx += 1
            self.arrived.clear()
            if self._tl:
                self._log(-1, f"barrier round={self.round_idx} "
                              f"workers={len(expected)}")
            T = self.t
            for v in expected:
                v.s_wait += T - v._stage_started
            if self.autoscaler is not None:
                self._autoscale_hook()
            if not expected:
                # the whole fleet is gone (e.g. every worker crashed
                # under takeover): mirror the reference engine, which
                # accounts this barrier once and schedules nothing —
                # looping would commit zero-batch rounds forever
                return
            fate = self._fast_round(expected, T)
            if fate == _CLASSIC:
                for v in expected:
                    self._begin_update(v)
                return
            if fate == _EPOCH_DONE:
                return
            # _NEXT_BARRIER: round committed inline, self.t is the next
            # barrier's release time; loop

    def _fast_round(self, expected: List[_Worker], T: float) -> int:
        """Attempt to run update -> (fetch) -> compute -> sync ->
        barrier for every expected worker inline, bypassing the heap.

        Legal only when nothing can interleave before the projected
        barrier release: no pending scale-in, no restoring/replaying
        worker, and no scheduled event at or before the release.  The
        arithmetic reproduces the event path's floating-point operation
        order exactly, so reports stay byte-identical to the reference
        engine.  Timeline mode disables batching for full granularity.
        """
        if self._pending_scale_in or self._tl:
            return _CLASSIC
        plan = self.plan
        heap = self._heap
        t1 = T + plan.update_s
        if self.pool <= 1e-9:
            # final update, then the whole fleet retires
            if heap and heap[0][0] <= t1:
                return _CLASSIC
            for v in expected:
                v.s_update += t1 - T
                if v.alive and v.done_time is None:
                    v.state = DONE
                    v.done_time = t1
            self.t = t1
            return _EPOCH_DONE
        # Invariant: every expected worker here is alive, joined and
        # fully recovered — a restoring worker cannot have arrived at
        # the barrier (restoring clears in _h_synced, before arrival),
        # and replay_rounds clears in _h_loaded, before its compute.
        fetch = (not plan.fetch_first_round_only) and self.round_idx > 0
        t2 = t1 + plan.fetch_s if fetch else t1
        arrived = self.arrived
        strag = self._strag_by_worker
        if self._uniform and not strag:
            # homogeneous fleet: one worker's arithmetic is everyone's
            # (x * 1.0 is exact, so folding work_mult/slowdown away
            # preserves the event path's floats bit-for-bit)
            t3 = t2 + plan.batches_per_round * plan.compute_s_per_batch
            t4 = t3 + plan.sync_s
            release = t4 if t4 > self.barrier_not_before \
                else self.barrier_not_before
            if heap and heap[0][0] <= release:
                return _CLASSIC
            du, dc, ds = t1 - T, t3 - t2, t4 - t3
            df = t2 - t1
            for v in expected:
                v.s_update += du
                if fetch:
                    v.s_fetch += df
                v.s_compute += dc
                v.s_sync += ds
                v.state = WAIT_BARRIER
                v._stage_started = t4
                arrived.add(v.id)
            self.t = release
            return _NEXT_BARRIER
        bpr, comp = plan.batches_per_round, plan.compute_s_per_batch
        sync_s = plan.sync_s
        arrivals = []
        release = self.barrier_not_before
        for v in expected:
            slow = 1.0
            for s in strag.get(v.id, ()):
                if s.start_s <= t2 < s.end_s and s.slowdown > slow:
                    slow = s.slowdown
            t3 = t2 + bpr * v.work_mult * comp * slow
            t4 = t3 + sync_s * v.work_mult
            arrivals.append((t3, t4))
            if t4 > release:
                release = t4
        if heap and heap[0][0] <= release:
            return _CLASSIC
        # commit: identical increments to the per-event path
        for v, (t3, t4) in zip(expected, arrivals):
            v.s_update += t1 - T
            if fetch:
                v.s_fetch += t2 - t1
            v.s_compute += t3 - t2
            v.s_sync += t4 - t3
            v.state = WAIT_BARRIER
            v._stage_started = t4
            arrived.add(v.id)
        self.t = release
        return _NEXT_BARRIER

    def _begin_update(self, w: _Worker):
        w.state = UPDATE
        w._stage_started = self.t
        self._schedule(self.t + self.plan.update_s, w, _OP_UPDATED)

    def _h_updated(self, w: _Worker, arg):
        w.s_update += self.t - w._stage_started
        # barrier-free: only unclaimed pool work justifies another round
        # (peers' in-flight rounds will drain their reservations);
        # barrier mode keeps reservations at zero so this is unchanged
        if (self.pool - self._async_reserved > 1e-9
                and not self._retire_if_requested(w)):
            self._begin_round(w)
        elif w.alive and w.done_time is None:
            w.state = DONE
            w.done_time = self.t
            if self._tl:
                self._log(w.id, "done")

    def _retire_if_requested(self, w: _Worker) -> bool:
        if self._pending_scale_in > 0 and len(self._expected()) > 1:
            self._pending_scale_in -= 1
            w.alive = False
            w.state = DONE
            w.done_time = self.t
            if self._tl:
                self._log(w.id, "scaled in")
            return True
        return False

    # ------------------------------------------------------------ faults
    def _h_crash(self, w, widx):
        self._on_crash(self.workers[widx], self.t)

    def _on_crash(self, w: _Worker, t: float):
        if not w.alive or w.done_time is not None:
            return
        w.gen += 1                      # invalidate in-flight events
        w.alive = False
        w.state = DEAD
        # barrier-free pool claims survive a restore crash (the worker
        # respawns and commits the round); takeover settles the claim
        # from the in-DB partition below
        reserve = w.async_reserve
        self.arrived.discard(w.id)
        if self._tl:
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
                self._uniform = False
                if reserve:
                    # barrier-free takeover mirrors the barrier
                    # engine's economics: the dead worker's partial
                    # accumulation is already in the DB, so its claimed
                    # round drains without recompute (the sync engine
                    # commits it through the inflated work_mult at the
                    # crash round's barrier)
                    self.pool -= reserve
                    self._async_reserved -= reserve
                    w.async_reserve = 0.0
            self.barrier_not_before = max(self.barrier_not_before, rejoin)
            self.recoveries.append(RecoveryEvent(
                worker=w.id, crash_time_s=t, rejoined_time_s=rejoin,
                mode="takeover"))
            if self._tl:
                self._log(w.id, f"takeover by {len(survivors)} peers")
            self._schedule(rejoin, None, _OP_MAYBE_RELEASE)
        else:
            replay = self.recovery.replay_rounds(self.round_idx)
            rec = RecoveryEvent(worker=w.id, crash_time_s=t,
                                rejoined_time_s=math.nan, mode="restore")
            self.recoveries.append(rec)
            w.restoring = True
            w.pending_recovery = rec
            w.replay_rounds = replay
            self._schedule(t + self.recovery.detection_s, None,
                           _OP_RESPAWN, w.id)

    def _h_respawn(self, w, widx):
        v = self.workers[widx]
        self._spawn_worker(self.t, replay_rounds=v.replay_rounds,
                           existing=v)

    def _h_maybe_release(self, w, arg):
        self._maybe_release_barrier()

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
                if self._tl:
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
                self._schedule(c.time_s, None, _OP_CRASH, c.worker)

        heap = self._heap
        workers = self.workers
        ops = self._OPS
        guard = 0
        while heap:
            t, _, wid, gen, op, arg = heappop(heap)
            if wid >= 0:
                w = workers[wid]
                if w.gen != gen:
                    continue            # event from a crashed incarnation
            else:
                w = None
            if t > self.t:
                self.t = t
            ops[op](self, w, arg)
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

        # billing policy comes from the ArchSpec: Lambda archs bill each
        # worker's invocation wall-clock, stateful instances (the GPU
        # baseline) bill for the whole makespan
        total_cost = get_arch(plan.arch).fleet_cost(
            ((w.done_time or makespan) - w.spawn_time
             for w in self.workers),
            plan.ram_gb, makespan, len(self.workers))

        stage_totals = {"cold_start": 0.0, "fetch": 0.0, "compute": 0.0,
                        "sync": 0.0, "update": 0.0, "wait": 0.0,
                        "replay": 0.0}
        for w in self.workers:
            stage_totals["cold_start"] += w.s_cold
            stage_totals["fetch"] += w.s_fetch
            stage_totals["compute"] += w.s_compute
            stage_totals["sync"] += w.s_sync
            stage_totals["update"] += w.s_update
            stage_totals["wait"] += w.s_wait
            stage_totals["replay"] += w.s_replay
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


# opcode -> handler, indexed by the _OP_* constants; class-level so the
# table is built once, not per epoch
EventRuntime._OPS = (
    EventRuntime._h_cold_done, EventRuntime._h_loaded,
    EventRuntime._h_round_loaded, EventRuntime._h_computed,
    EventRuntime._h_synced, EventRuntime._h_updated,
    EventRuntime._h_release, EventRuntime._h_maybe_release,
    EventRuntime._h_crash, EventRuntime._h_respawn)


def run_event_epoch(arch: str, *, n_params: int, compute_s_per_batch: float,
                    setup: ServerlessSetup = ServerlessSetup(),
                    significant_fraction: float = 0.3,
                    accumulation: int = 24,
                    faults: Optional[FaultPlan] = None,
                    recovery=None,
                    autoscaler=None, robust_trim: int = 0,
                    max_timeline: int = 0) -> RuntimeReport:
    """One event-driven epoch; mirrors ``simulate_epoch``'s signature.

    ``recovery`` accepts a :class:`RecoveryPolicy`, one of the strings
    ``"auto"`` (resolve the architecture's default via
    :func:`default_recovery`) / ``"restore"`` / ``"takeover"`` (the
    sweep layer's vocabulary), or ``None`` (checkpoint-restore — the
    frozen reference engine's behaviour, kept so ``runtime_ref``
    equivalence scenarios stay policy-identical).
    """
    if isinstance(recovery, str):
        recovery = resolve_recovery(arch, recovery)
    plan = round_plan(arch, n_params=n_params,
                      compute_s_per_batch=compute_s_per_batch, setup=setup,
                      significant_fraction=significant_fraction,
                      accumulation=accumulation)
    return EventRuntime(plan, setup, faults=faults, recovery=recovery,
                        autoscaler=autoscaler, robust_trim=robust_trim,
                        max_timeline=max_timeline).run()
