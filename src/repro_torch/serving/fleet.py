"""Request-level discrete-event simulation of a continuous-batching
serving fleet.

:class:`FleetSim` schedules a :class:`~repro_torch.serving.workload.RequestPlan`
onto replicas whose per-step semantics are the real
:class:`~repro_torch.serving.engine.ServingEngine`'s, timed instead of
executed (``tests/test_torch_serving_engine.py`` pins the semantics this
model cites):

  * admission prefills queued requests one at a time (batch 1) into
    free cache slots — the prefill produces the FIRST token, so TTFT is
    the request's own prefill end minus its arrival, and a
    one-token request completes at admission without occupying a slot;
  * every engine step then decodes ONE token for every active slot in
    ``decode_step_s`` wall-clock — a half-empty batch pays the same
    step time as a full one, which is exactly the utilisation/latency
    trade continuous batching exists to manage;
  * a finished slot frees immediately for the next queued request (no
    head-of-line blocking).

Around that per-replica core sit the serverless stack's pieces:
replicas cold-start through the measured :class:`Trace` tails
(arXiv 2105.07806) with the fault stack's fixed-draws-per-spawn seeding,
:class:`~repro_torch.serverless.autoscale.ReactiveAutoscaler` drives
scale-in/out at control ticks (observing queue depth and recent
latency through its existing barrier contract), and the fleet bills
through each :class:`~repro_torch.serverless.archs.ArchSpec`'s
``fleet_cost`` — Lambda replicas pay GB-seconds for their whole
up-time (idle included), the GPU baseline pays instance-hours on the
makespan.  Per-step compute follows the training sweeps'
``ram_scaled_compute`` rule: Lambda vCPU scales with the RAM tier,
accelerator-backed archs (``ram_scales_compute=False``) get a fixed
``gpu_speedup`` over the reference tier instead.

The event loop is the ``EventRuntime`` idiom: a single heap of
``(t, seq, op, arg)`` tuples with integer opcodes and ``__slots__``
replica records; no RNG anywhere except the seeded cold-start draws,
so a run is a pure function of ``(sim, plan)``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.guards import no_tracer_fields
from repro_torch.serverless.archs import get_arch
from repro_torch.serverless.autoscale import ReactiveAutoscaler
from repro_torch.serverless.traces import Trace
from repro_torch.serving.workload import RequestPlan, Workload, _stream_rng

# opcodes (heap events are (t, seq, op, arg) — seq breaks ties, so runs
# are deterministic however floats collide)
_ARRIVAL, _REPLICA, _CONTROL = range(3)

# cold-start sub-stream key; disjoint from the Workload's field streams
# by living under a different dataclass seed, but keep it distinct
# anyway so a shared seed never aliases draws
_STREAM_COLD = 7


class _Replica:
    """One continuous-batching replica; ``__slots__`` record like the
    training runtime's workers."""
    __slots__ = ("idx", "state", "slots", "up_since", "end_s",
                 "draining")
    COLD, IDLE, BUSY, DEAD = range(4)

    def __init__(self, idx: int, batch_size: int, up_since: float):
        self.idx = idx
        self.state = _Replica.COLD
        self.slots: List[Optional[Tuple[int, int]]] = [None] * batch_size
        self.up_since = up_since
        self.end_s: Optional[float] = None      # retire time, else billed
        self.draining = False                   # to the fleet makespan

    def active(self) -> int:
        return sum(s is not None for s in self.slots)


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Everything one fleet run measured."""
    arch: str
    n_requests: int
    makespan_s: float
    latency_p50_s: float
    latency_p95_s: float
    latency_p99_s: float
    ttft_p50_s: float
    ttft_p95_s: float
    mean_latency_s: float
    throughput_rps: float
    tokens_generated: int
    total_cost: float
    usd_per_1k_requests: float
    peak_replicas: int
    replica_seconds: float
    n_cold_starts: int
    scale_decisions: Tuple[Tuple[int, int, str], ...] = ()
    latencies_s: Tuple[float, ...] = dataclasses.field(
        default=(), repr=False)

    def __post_init__(self):
        # runtime backstop for the static trace-safety rule: a report
        # built inside a traced function would freeze abstract values
        # into BENCH payloads
        no_tracer_fields(self)


@dataclasses.dataclass(frozen=True)
class FleetSim:
    """A continuous-batching fleet: configuration is frozen and
    validated eagerly; :meth:`run` is a pure function of the plan.

    ``prefill_s_per_token`` / ``decode_step_s`` are anchored at
    ``ref_ram_gb`` — the effective step times follow the arch's
    ``ram_scales_compute`` policy (see :meth:`step_times`).
    """
    arch: str = "spirt"
    replicas: int = 2                    # initial fleet size
    batch_size: int = 8                  # cache slots per replica
    ram_gb: float = 2.0
    prefill_s_per_token: float = 2e-4    # @ ref_ram_gb
    decode_step_s: float = 0.05          # @ ref_ram_gb
    ref_ram_gb: float = 2.0
    gpu_speedup: float = 8.0             # fixed-accelerator step speedup
    cold_start_s: float = 2.5
    min_replicas: int = 1
    max_replicas: int = 8
    autoscale: bool = False
    control_interval_s: float = 10.0
    trace: Optional[Trace] = None        # measured cold-start tails
    seed: int = 0                        # cold-start draws only

    def __post_init__(self):
        get_arch(self.arch)              # unknown arch fails here
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got "
                             f"{self.batch_size}")
        if not (1 <= self.min_replicas <= self.replicas
                <= self.max_replicas):
            raise ValueError(
                "need 1 <= min_replicas <= replicas <= max_replicas, "
                f"got {self.min_replicas} / {self.replicas} / "
                f"{self.max_replicas}")
        for f in ("ram_gb", "ref_ram_gb", "prefill_s_per_token",
                  "decode_step_s", "gpu_speedup", "control_interval_s"):
            v = getattr(self, f)
            if not (math.isfinite(v) and v > 0):
                raise ValueError(f"{f} must be finite and > 0, got {v}")
        if not (math.isfinite(self.cold_start_s)
                and self.cold_start_s >= 0):
            raise ValueError(f"cold_start_s must be >= 0, got "
                             f"{self.cold_start_s}")

    # ------------------------------------------------------------ model
    def step_times(self) -> Tuple[float, float]:
        """Effective (prefill_s_per_token, decode_step_s) for this arch
        and RAM tier — the serving twin of ``ram_scaled_compute``."""
        spec = get_arch(self.arch)
        if spec.ram_scales_compute:
            scale = self.ref_ram_gb / self.ram_gb
        else:
            scale = 1.0 / self.gpu_speedup
        return (self.prefill_s_per_token * scale,
                self.decode_step_s * scale)

    def service_s(self, prompt_tokens, decode_tokens):
        """No-queueing service time of a request: own prefill (which
        yields token 1) plus ``d - 1`` decode steps.  Elementwise."""
        prefill_s, decode_s = self.step_times()
        d = np.asarray(decode_tokens, float)
        return (np.asarray(prompt_tokens, float) * prefill_s
                + np.maximum(d - 1.0, 0.0) * decode_s)

    def _cold_time(self, u: float) -> float:
        """Replica cold start: base, or the measured tail when a trace
        is bound (``max(base, sample)`` — the fault stack's extra-over-
        base rule)."""
        if self.trace is None:
            return self.cold_start_s
        return max(self.cold_start_s,
                   float(self.trace.sample("cold_start_s", u)))

    # -------------------------------------------------------------- run
    def run_workload(self, workload: Workload, seed: int = 0,
                     scaler=None) -> FleetReport:
        return self.run(workload.generate(seed), scaler=scaler)

    def run(self, plan: RequestPlan, scaler=None) -> FleetReport:
        n = len(plan)
        if n == 0:
            raise ValueError("empty RequestPlan")
        if scaler is None and self.autoscale:
            scaler = ReactiveAutoscaler(min_workers=self.min_replicas,
                                        max_workers=self.max_replicas)
        prefill_s, decode_s = self.step_times()
        ideal_s = float(np.mean(self.service_s(plan.prompt_tokens,
                                               plan.decode_tokens)))
        cold_rng = _stream_rng(self.seed, _STREAM_COLD)

        heap: list = []
        seq = itertools.count()

        def push(t: float, op: int, arg: int):
            heapq.heappush(heap, (t, next(seq), op, arg))

        reps: List[_Replica] = []
        live = 0
        n_cold = 0

        def spawn(t: float) -> Optional[_Replica]:
            nonlocal live, n_cold
            if live >= self.max_replicas:
                return None
            r = _Replica(len(reps), self.batch_size, up_since=t)
            reps.append(r)
            live += 1
            n_cold += 1
            push(t + self._cold_time(cold_rng.random()), _REPLICA, r.idx)
            return r

        for _ in range(self.replicas):
            spawn(0.0)
        peak = live

        queue: deque = deque()
        ttft = [0.0] * n
        finish = [math.inf] * n
        completed = 0

        arrival = plan.arrival_s
        for i, t_a in enumerate(arrival):
            push(t_a, _ARRIVAL, i)

        # autoscaler adapter state: a fake clock whose "round" length is
        # the window's mean completed latency, so the scaler's EMA/ratio
        # logic reads serving latency the way it reads round times
        fake_now = 0.0
        tick = 0
        window: List[float] = []
        if scaler is not None:
            push(self.control_interval_s, _CONTROL, 0)

        def replica_step(r: _Replica, t: float):
            nonlocal completed, live
            if r.state == _Replica.DEAD:
                return
            if r.draining and r.active() == 0:
                r.state = _Replica.DEAD
                r.end_s = t
                live -= 1
                return
            r.state = _Replica.BUSY
            t_cur = t
            if not r.draining:
                for slot in range(self.batch_size):
                    # ServingEngine._admit: serial batch-1 prefills; a
                    # request done AT prefill frees the slot for the
                    # next queued one immediately
                    while r.slots[slot] is None and queue:
                        i = queue.popleft()
                        t_cur += plan.prompt_tokens[i] * prefill_s
                        ttft[i] = t_cur - arrival[i]
                        rem = plan.decode_tokens[i] - 1
                        if rem <= 0:
                            finish[i] = t_cur
                            window.append(t_cur - arrival[i])
                            completed += 1
                        else:
                            r.slots[slot] = (i, rem)
            if r.active() == 0:
                r.state = _Replica.IDLE
                return
            # one decode step: every active slot gains one token
            t_end = t_cur + decode_s
            for slot in range(self.batch_size):
                held = r.slots[slot]
                if held is None:
                    continue
                i, rem = held
                rem -= 1
                if rem == 0:
                    finish[i] = t_end
                    window.append(t_end - arrival[i])
                    completed += 1
                    r.slots[slot] = None        # _retire: frees now
                else:
                    r.slots[slot] = (i, rem)
            push(t_end, _REPLICA, r.idx)

        def control(t: float):
            nonlocal fake_now, tick, window, peak, live
            tick += 1
            round_s = (sum(window) / len(window)) if window else ideal_s
            window = []
            in_flight = sum(r.active() for r in reps
                            if r.state != _Replica.DEAD)
            fake_now += round_s
            delta = scaler.observe(
                round_idx=tick, now_s=fake_now,
                active_workers=live,
                remaining_batches=len(queue) + in_flight,
                batches_per_round=float(self.batch_size),
                ideal_round_s=ideal_s)
            if delta > 0:
                for _ in range(delta):
                    if spawn(t) is None:
                        break
                peak = max(peak, live)
            elif delta < 0:
                # drain from the top: newest non-draining replica first
                standing = [r for r in reps
                            if r.state != _Replica.DEAD
                            and not r.draining]
                for r in standing[-(-delta):][::-1]:
                    # keep min_replicas replicas that will still ACCEPT
                    # work — draining ones are already on their way out
                    if len(standing) <= self.min_replicas:
                        break
                    standing.remove(r)
                    r.draining = True
                    if r.state == _Replica.IDLE:
                        r.state = _Replica.DEAD
                        r.end_s = t
                        live -= 1
            if completed < n:
                push(t + self.control_interval_s, _CONTROL, 0)

        while heap:
            t, _, op, arg = heapq.heappop(heap)
            if op == _ARRIVAL:
                queue.append(arg)
                for r in reps:
                    if r.state == _Replica.IDLE and not r.draining:
                        r.state = _Replica.BUSY  # claimed; no double wake
                        push(t, _REPLICA, r.idx)
                        break
            elif op == _REPLICA:
                replica_step(reps[arg], t)
            else:
                control(t)

        if completed < n:
            raise RuntimeError(
                f"fleet stalled: {completed}/{n} requests completed "
                "(all replicas drained with work queued?)")

        makespan = max(finish)
        wall_clocks = [(r.end_s if r.end_s is not None else makespan)
                       - r.up_since for r in reps]
        spec = get_arch(self.arch)
        cost = float(spec.fleet_cost(wall_clocks, self.ram_gb, makespan,
                                     n_instances=peak))
        lat = np.asarray([finish[i] - arrival[i] for i in range(n)])
        ttft_a = np.asarray(ttft)
        p50, p95, p99 = (float(np.percentile(lat, q))
                         for q in (50, 95, 99))
        return FleetReport(
            arch=self.arch, n_requests=n, makespan_s=float(makespan),
            latency_p50_s=p50, latency_p95_s=p95, latency_p99_s=p99,
            ttft_p50_s=float(np.percentile(ttft_a, 50)),
            ttft_p95_s=float(np.percentile(ttft_a, 95)),
            mean_latency_s=float(lat.mean()),
            throughput_rps=n / makespan if makespan > 0 else 0.0,
            tokens_generated=plan.total_tokens,
            total_cost=cost,
            usd_per_1k_requests=cost / n * 1000.0,
            peak_replicas=peak,
            replica_seconds=float(sum(wall_clocks)),
            n_cold_starts=n_cold,
            scale_decisions=tuple(getattr(scaler, "decisions", ()))
            if scaler is not None else (),
            latencies_s=tuple(float(x) for x in lat))
