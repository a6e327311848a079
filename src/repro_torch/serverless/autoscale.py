"""Reactive autoscaling policies for the serverless event runtime.

Serverless training's elasticity story — the reason the paper cares
about Lambda at all — is that the fleet can grow mid-epoch for the cost
of a cold start, and shrink to zero the moment work runs out.  The
policies here observe each barrier (round duration, fleet size,
remaining work) and return a worker delta; the runtime charges every
added worker its cold start + state load and bills all workers
per-second through ``repro_torch.costmodel.pricing``, so scale decisions
show up in both the makespan and the cost column of
``benchmarks/fault_tolerance.py``.

``ReactiveAutoscaler`` is deliberately boring: EMA of round durations,
scale out when the current round blows past the EMA (straggler or
storm), scale in when the remaining pool no longer needs the fleet.
Deterministic — no RNG — so runs are replayable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass
class ReactiveAutoscaler:
    """Scale out on slow rounds, scale in when work runs short.

    observe() contract (called by the runtime at every barrier):
      round_idx          1-based index of the round that just finished
      now_s              barrier release time
      active_workers     workers that contributed to this round
      remaining_batches  work left in the shared pool
      batches_per_round  per-worker round quantum
    returns an int delta: >0 spawn, <0 retire after their next round.
    """
    min_workers: int = 1
    max_workers: int = 16
    scale_out_ratio: float = 1.4    # round_s > ratio * EMA  -> +step
    scale_in_headroom: float = 2.0  # fleet could finish remaining work
                                    # with this many fewer rounds -> -step
    step: int = 1
    cooldown_rounds: int = 2
    ema_alpha: float = 0.5
    _ema_s: Optional[float] = dataclasses.field(default=None, repr=False)
    _last_scale_round: int = dataclasses.field(default=-10, repr=False)
    _last_t: float = dataclasses.field(default=0.0, repr=False)
    decisions: List[Tuple[int, int, str]] = dataclasses.field(
        default_factory=list, repr=False)

    def observe(self, *, round_idx: int, now_s: float, active_workers: int,
                remaining_batches: float, batches_per_round: float,
                ideal_round_s: Optional[float] = None) -> int:
        round_s = now_s - self._last_t
        self._last_t = now_s
        prev_ema = self._ema_s
        self._ema_s = (round_s if prev_ema is None else
                       self.ema_alpha * round_s
                       + (1 - self.ema_alpha) * prev_ema)
        if round_idx <= 1:              # round 1 embeds the cold start
            return 0
        if round_idx - self._last_scale_round < self.cooldown_rounds:
            return 0
        if remaining_batches <= 0:
            return 0

        rounds_left = math.ceil(
            remaining_batches / max(active_workers * batches_per_round,
                                    1e-9))
        # reference round time: the plan's fault-free ideal when the
        # runtime provides it (catches a from-the-start straggler the
        # EMA would normalize away), else the trailing EMA.  `is not
        # None`, not truthiness: a legitimate 0.0 ideal must not fall
        # back to the EMA and mute the scale-out signal
        ref = ideal_round_s if ideal_round_s is not None else prev_ema
        # scale OUT: this round was anomalously slow and there is enough
        # remaining work to amortize a cold start
        if (ref is not None and round_s > self.scale_out_ratio * ref
                and active_workers < self.max_workers
                and rounds_left >= 2):
            self._last_scale_round = round_idx
            # log the APPLIED delta, not the configured step: near the
            # fleet cap the clamp below bites, and a replayed decision
            # log must match the scale events that actually happened
            applied = min(self.step, self.max_workers - active_workers)
            self.decisions.append((round_idx, applied,
                                   f"slow round {round_s:.2f}s vs ref "
                                   f"{ref:.2f}s"))
            return applied
        # scale IN: fewer workers would still finish in the same number
        # of rounds (tail of the pool)
        smaller = active_workers - self.step
        if smaller >= self.min_workers:
            rounds_smaller = math.ceil(
                remaining_batches / max(smaller * batches_per_round, 1e-9))
            if rounds_smaller <= rounds_left + self.scale_in_headroom - 2:
                self._last_scale_round = round_idx
                self.decisions.append((round_idx, -self.step,
                                       f"{rounds_smaller} rounds suffice"))
                return -self.step
        return 0


@dataclasses.dataclass
class ScheduledScaler:
    """Fixed (round -> delta) schedule; useful for tests and sweeps."""
    schedule: Tuple[Tuple[int, int], ...] = ()

    def observe(self, *, round_idx: int, **_) -> int:
        return sum(d for r, d in self.schedule if r == round_idx)
