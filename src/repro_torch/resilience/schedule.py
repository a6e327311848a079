"""Deterministic step-indexed fault schedules for real training runs
(``repro.resilience.schedule``, copied).

The serverless stack expresses faults in *wall-clock seconds* over an
epoch horizon (``faults.FaultPlan``); a real training loop advances in
*steps*.  :class:`FaultSchedule` is the bridge: an immutable list of
(step, worker) kills, either written directly or derived from a
``FaultPlan`` so the exact scenario the event runtime simulates can be
replayed against real sharded training (``repro_torch.resilience.harness``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.serverless.faults import FaultPlan


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Kills to inject, as ``(step, worker)`` pairs sorted by step.

    ``worker`` indexes the fleet *at the moment of the kill* (after an
    earlier takeover shrank the fleet, the harness reduces it modulo
    the surviving width).  A kill at step ``s`` means steps ``0..s-1``
    completed and step ``s``'s in-flight work is lost — the recovery
    policy decides what happens next.
    """
    kills: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        norm = []
        for entry in self.kills:
            step, worker = entry
            if step < 1:
                raise ValueError(
                    f"kill step must be >= 1 (step {step}: there is "
                    "nothing to recover before the first completed step)")
            if worker < 0:
                raise ValueError(f"worker must be >= 0, got {worker}")
            norm.append((int(step), int(worker)))
        norm.sort()
        steps = [s for s, _ in norm]
        if len(set(steps)) != len(steps):
            raise ValueError(
                f"at most one kill per step, got steps {steps}")
        object.__setattr__(self, "kills", tuple(norm))

    @classmethod
    def single(cls, step: int, worker: int = 0) -> "FaultSchedule":
        return cls(kills=((step, worker),))

    def kill_at(self, step: int) -> Optional[int]:
        """Worker to kill before executing ``step``, or None."""
        for s, w in self.kills:
            if s == step:
                return w
        return None

    @property
    def n_kills(self) -> int:
        return len(self.kills)

    @classmethod
    def from_fault_plan(cls, plan: FaultPlan, *, total_steps: int,
                        horizon_s: float) -> "FaultSchedule":
        """Map a serverless :class:`FaultPlan`'s crash times onto step
        indices: a crash at time ``t`` of an epoch spanning
        ``horizon_s`` kills before step ``round(t / horizon_s *
        total_steps)``, clamped into ``[1, total_steps - 1]`` so the
        kill always lands mid-run.  Crashes mapping to an occupied step
        are dropped (first in time order wins — one kill per step, like
        the runtime's one-crash-per-worker thinning).  Pure function of
        (plan, total_steps, horizon_s)."""
        if total_steps < 2:
            raise ValueError(
                f"total_steps must be >= 2, got {total_steps}")
        if not horizon_s > 0:
            raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
        kills, used = [], set()
        for crash in sorted(plan.crashes, key=lambda c: c.time_s):
            step = int(round(crash.time_s / horizon_s * total_steps))
            step = min(max(step, 1), total_steps - 1)
            if step in used:
                continue
            used.add(step)
            kills.append((step, crash.worker))
        return cls(kills=tuple(kills))
