"""High-throughput Monte-Carlo sweep engine over the serverless models.

The paper's contribution is a *surface* — cost and makespan across five
architectures and many configurations — and every chart of it
(elastic pricing sweeps, fault-rate stress grids, Pareto fronts) needs `simulate_epoch` / the event runtime evaluated thousands
of times.  This module provides the three performance layers:

  1. **Vectorized analytic path** — :func:`sweep_analytic` evaluates an
     entire :class:`SweepGrid` (arch x n_workers x RAM tier x channel x
     accumulation x significant_fraction) through the *same*
     elementwise formulas the scalar ``simulate_epoch`` uses
     (``simulator._round_terms`` / ``_epoch_terms`` / ``_epoch_cost``),
     just on numpy arrays: one block of array ops per
     (arch, channel) pair instead of one Python call per point, with
     bit-exact agreement against the scalar path
     (``tests/test_sweep.py``).

  2. **Seeded multi-replicate event sweep** — :func:`sweep_events` fans
     fault-injected :func:`~repro_torch.serverless.runtime.run_event_epoch`
     grid points across processes, drawing one reproducible
     :meth:`FaultPlan.random` per (point, replicate) seed — or, with
     ``trace=``, one :meth:`FaultPlan.from_trace` replaying measured
     cold-start/straggler tails — and aggregates mean / p50 / p95
     time-to-recover, makespan and cost overhead per point.

  3. **Pareto extraction** — :func:`pareto_front` returns the
     non-dominated (cost, makespan) subset, which
     ``benchmarks/pareto_sweep.py`` charts per architecture.

Everything is deterministic from (grid, seed): replicate seeds are a
pure function of the point index, so any cell of any chart can be
re-run in isolation.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import zlib
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serverless.adversarial import (
    SIM_AGGREGATORS, byzantine_fractions, get_attack, list_attacks,
    sim_aggregator_max_f)
from repro_torch.serverless.archs import get_arch
from repro_torch.serverless.autoscale import ReactiveAutoscaler
from repro_torch.serverless.faults import FaultPlan
from repro_torch.serverless.runtime import (RuntimeReport, resolve_recovery,
                                            run_event_epoch)
from repro_torch.serverless.traces import Trace
from repro_torch.serverless.simulator import (ARCHS, REDIS, Channel,
                                              ServerlessSetup, _epoch_cost,
                                              _epoch_terms, _round_terms,
                                              simulate_epoch)

ComputeModel = Union[float, Callable[[str, float], float]]


def ram_scaled_compute(anchor_s_per_batch: float, *,
                       ref_ram_gb: float = 2.0) -> Callable[[str, float],
                                                            float]:
    """Lambda allocates vCPU proportionally to RAM, so per-batch compute
    shrinks as the tier grows; architectures whose spec clears
    ``ram_scales_compute`` (the GPU baseline — compute fixed by the
    accelerator, not the tier) keep the anchor.  Returns a compute
    model for :class:`SweepGrid` anchored at ``ref_ram_gb``."""
    def model(arch: str, ram_gb: float) -> float:
        if not get_arch(arch).ram_scales_compute:
            return anchor_s_per_batch
        return anchor_s_per_batch * (ref_ram_gb / ram_gb)
    return model


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """Cross-product axes + fixed epoch parameters for an analytic sweep.

    ``compute_s_per_batch`` is either a constant or a callable
    ``(arch, ram_gb) -> seconds`` (see :func:`ram_scaled_compute`);
    either way it is resolved per (arch, RAM tier), never per point, so
    the vectorized path stays a handful of array ops.
    """
    n_params: int
    compute_s_per_batch: ComputeModel
    archs: Tuple[str, ...] = ARCHS
    n_workers: Tuple[int, ...] = (4,)
    ram_gb: Tuple[float, ...] = (2.0,)
    channels: Tuple[Channel, ...] = (REDIS,)
    accumulation: Tuple[int, ...] = (24,)
    significant_fraction: Tuple[float, ...] = (0.3,)
    batches_per_worker: int = 24
    cold_start_s: float = 2.5
    model_bytes: float = 17e6
    minibatch_bytes: float = 512 * 32 * 32 * 3 * 4

    @property
    def n_points(self) -> int:
        return (len(self.archs) * len(self.channels) * len(self.n_workers)
                * len(self.ram_gb) * len(self.accumulation)
                * len(self.significant_fraction))

    def compute_for(self, arch: str, ram_gb: float) -> float:
        c = self.compute_s_per_batch
        return float(c(arch, ram_gb)) if callable(c) else float(c)


def iter_grid(grid: SweepGrid) -> Iterator[dict]:
    """Scalar enumeration of the grid, in the exact order the
    vectorized sweep lays points out (arch, channel outer; then
    n_workers, ram, accumulation, significant_fraction with the last
    axis fastest)."""
    for arch in grid.archs:
        spec = get_arch(arch)
        for ch in grid.channels:
            for W in grid.n_workers:
                for ram in grid.ram_gb:
                    for acc in grid.accumulation:
                        for sig in grid.significant_fraction:
                            yield dict(
                                arch=arch, channel=ch, n_workers=W,
                                ram_gb=ram, accumulation=acc,
                                significant_fraction=sig,
                                channel_pinned=spec.pins_channel(ch),
                                compute_s_per_batch=grid.compute_for(
                                    arch, ram))


def point_setup(grid: SweepGrid, point: dict) -> ServerlessSetup:
    """The :class:`ServerlessSetup` equivalent of one grid point."""
    return ServerlessSetup(n_workers=point["n_workers"],
                           batches_per_worker=grid.batches_per_worker,
                           ram_gb=point["ram_gb"],
                           cold_start_s=grid.cold_start_s,
                           model_bytes=grid.model_bytes,
                           minibatch_bytes=grid.minibatch_bytes,
                           channel=point["channel"])


def scalar_sweep(grid: SweepGrid) -> list:
    """The equivalent loop of scalar ``simulate_epoch`` calls — the
    baseline the vectorized path is benchmarked (and exactness-tested)
    against."""
    out = []
    for p in iter_grid(grid):
        out.append(simulate_epoch(
            p["arch"], n_params=grid.n_params,
            compute_s_per_batch=p["compute_s_per_batch"],
            setup=point_setup(grid, p),
            significant_fraction=p["significant_fraction"],
            accumulation=p["accumulation"]))
    return out


@dataclasses.dataclass
class AnalyticSweep:
    """Columnar result of :func:`sweep_analytic` (one row per point)."""
    grid: SweepGrid
    arch: np.ndarray                  # str
    channel_idx: np.ndarray           # index into grid.channels
    n_workers: np.ndarray
    ram_gb: np.ndarray
    accumulation: np.ndarray
    significant_fraction: np.ndarray
    compute_s_per_batch: np.ndarray
    fetch_s: np.ndarray
    compute_s: np.ndarray
    sync_s: np.ndarray
    update_s: np.ndarray
    per_worker_s: np.ndarray
    per_batch_s: np.ndarray
    comm_bytes_per_worker: np.ndarray
    cost_per_worker: np.ndarray
    total_cost: np.ndarray
    # True where the arch's pinned sync channel overrides the grid's
    # channel label (e.g. gpu x redis: the sync numbers are S3's) —
    # such points must not masquerade as channel comparisons
    channel_pinned: np.ndarray

    def __len__(self) -> int:
        return len(self.per_worker_s)

    def point(self, i: int) -> dict:
        """One row as a dict (channel resolved back to its object)."""
        return dict(arch=str(self.arch[i]),
                    channel=self.grid.channels[int(self.channel_idx[i])],
                    n_workers=int(self.n_workers[i]),
                    ram_gb=float(self.ram_gb[i]),
                    accumulation=int(self.accumulation[i]),
                    significant_fraction=float(
                        self.significant_fraction[i]),
                    channel_pinned=bool(self.channel_pinned[i]),
                    compute_s_per_batch=float(self.compute_s_per_batch[i]),
                    per_worker_s=float(self.per_worker_s[i]),
                    total_cost=float(self.total_cost[i]))

    def mask(self, arch: Optional[str] = None, *,
             drop_pinned: bool = False) -> np.ndarray:
        """Row selector.  ``drop_pinned=True`` removes the bogus
        channel-comparison points (grid channel overridden by the
        arch's pinned sync channel)."""
        m = (np.ones(len(self), bool) if arch is None
             else self.arch == arch)
        if drop_pinned:
            m = m & ~self.channel_pinned
        return m


def sweep_analytic(grid: SweepGrid) -> AnalyticSweep:
    """Evaluate the whole grid in one block of array ops per
    architecture — exact agreement with :func:`scalar_sweep`.

    The (channel, n_workers, ram, accumulation, significant_fraction)
    mesh is built once and shared by every architecture block; results
    land in preallocated columns by slice assignment, so per-point
    Python cost is zero and per-op numpy overhead amortizes with grid
    size."""
    W_ax = np.asarray(grid.n_workers)
    ram_ax = np.asarray(grid.ram_gb, float)
    acc_ax = np.asarray(grid.accumulation)
    sig_ax = np.asarray(grid.significant_fraction, float)
    bw_ax = np.asarray([c.bandwidth_Bps for c in grid.channels])
    lat_ax = np.asarray([c.latency_s for c in grid.channels])
    ch_ix, W, ram_ix, acc, sig = (m.ravel() for m in np.meshgrid(
        np.arange(len(grid.channels)), W_ax, np.arange(len(ram_ax)),
        acc_ax, sig_ax, indexing="ij"))
    bw, lat, ram = bw_ax[ch_ix], lat_ax[ch_ix], ram_ax[ram_ix]
    n = len(W)                         # points per architecture block
    N = n * len(grid.archs)

    arch_col = np.empty(N, dtype=f"U{max(len(a) for a in grid.archs)}")
    out = {k: np.empty(N) for k in
           ("fetch_s", "compute_s", "sync_s", "update_s", "per_worker_s",
            "per_batch_s", "comm_bytes_per_worker", "cost_per_worker",
            "total_cost", "compute_s_per_batch")}
    pinned_col = np.empty(N, bool)
    for ai, arch in enumerate(grid.archs):
        spec = get_arch(arch)
        # compute model resolved once per (arch, RAM tier)
        comp = np.asarray([grid.compute_for(arch, r)
                           for r in ram_ax])[ram_ix]
        terms = _round_terms(
            arch, n_params=grid.n_params, n_workers=W,
            bandwidth_Bps=bw, latency_s=lat,
            batches_per_worker=grid.batches_per_worker,
            model_bytes=grid.model_bytes,
            minibatch_bytes=grid.minibatch_bytes,
            significant_fraction=sig, accumulation=acc)
        ep = _epoch_terms(
            n_rounds=terms["n_rounds"],
            batches_per_round=terms["batches_per_round"],
            fetch_s=terms["fetch_s"],
            fetch_first_round_only=terms["fetch_first_round_only"],
            sync_s=terms["sync_s"], update_s=terms["update_s"],
            sync_bytes=terms["sync_bytes"],
            update_bytes=terms["update_bytes"],
            compute_s_per_batch=comp,
            cold_start_s=grid.cold_start_s,
            batches_per_worker=grid.batches_per_worker)
        cost_w, cost_t = _epoch_cost(arch, ep["per_worker"], ram, W)
        lo, hi = ai * n, (ai + 1) * n
        arch_col[lo:hi] = arch
        pinned_col[lo:hi] = np.asarray(
            [spec.pins_channel(c) for c in grid.channels])[ch_ix]
        out["compute_s_per_batch"][lo:hi] = comp
        out["fetch_s"][lo:hi] = ep["fetch"]
        out["compute_s"][lo:hi] = ep["compute"]
        out["sync_s"][lo:hi] = ep["sync"]
        out["update_s"][lo:hi] = ep["update"]
        out["per_worker_s"][lo:hi] = ep["per_worker"]
        out["per_batch_s"][lo:hi] = ep["per_batch"]
        out["comm_bytes_per_worker"][lo:hi] = ep["comm_bytes"]
        out["cost_per_worker"][lo:hi] = cost_w
        out["total_cost"][lo:hi] = cost_t
    tile = len(grid.archs)
    return AnalyticSweep(grid=grid, arch=arch_col,
                         channel_idx=np.tile(ch_ix, tile),
                         n_workers=np.tile(W, tile),
                         ram_gb=np.tile(ram, tile),
                         accumulation=np.tile(acc, tile),
                         significant_fraction=np.tile(sig, tile),
                         channel_pinned=pinned_col, **out)


def pareto_front(costs: Sequence[float],
                 times: Sequence[float]) -> np.ndarray:
    """Indices of the non-dominated (minimize cost, minimize time)
    points, in increasing-cost order."""
    costs = np.asarray(costs, float)
    times = np.asarray(times, float)
    order = np.lexsort((times, costs))      # by cost, then time
    front: List[int] = []
    best_t = np.inf
    for i in order:
        if times[i] < best_t:
            front.append(int(i))
            best_t = times[i]
    return np.asarray(front, int)


def knee_point(x: Sequence[float], y: Sequence[float]) -> int:
    """Index (into the ORIGINAL arrays) of the maximum-curvature point
    of ``y(x)`` — the fault-rate knee: the rate beyond which
    an architecture's cost overhead stops degrading gracefully.

    Both axes are min-max normalized so the knee is scale-free, the
    points are sorted by ``x``, and discrete curvature
    ``|x'y'' - y'x''| / (x'^2 + y'^2)^{3/2}`` (central differences via
    ``np.gradient``) is evaluated at every sample; endpoints are
    excluded (their one-sided differences make them spurious argmaxes).
    Degenerate inputs — fewer than 3 points, or an axis with no spread
    — have no curvature anywhere and raise ``ValueError``.
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if x.shape != y.shape or x.ndim != 1 or len(x) < 3:
        raise ValueError("knee_point needs two equal-length 1-D arrays "
                         f"of >= 3 points, got {x.shape} / {y.shape}")
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    x_span, y_span = xs[-1] - xs[0], ys.max() - ys.min()
    if x_span <= 0 or y_span <= 0:
        raise ValueError("knee_point needs spread on both axes "
                         f"(x span {x_span}, y span {y_span})")
    xn = (xs - xs[0]) / x_span
    yn = (ys - ys.min()) / y_span
    dx, dy = np.gradient(xn), np.gradient(yn)
    d2x, d2y = np.gradient(dx), np.gradient(dy)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.abs(dx * d2y - dy * d2x) \
            / np.maximum(dx * dx + dy * dy, 1e-300) ** 1.5
    k[0] = k[-1] = -np.inf                  # interior points only
    return int(order[int(np.argmax(k))])


# ---------------------------------------------------------------------------
# Layer 3: seeded multi-replicate event-engine sweep
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultRates:
    """Per-epoch expected fault rates fed to :meth:`FaultPlan.random`."""
    crash_rate: float = 0.0
    straggler_rate: float = 0.0
    byzantine_fraction: float = 0.0
    storm_prob: float = 0.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v < 0:
                raise ValueError(f"{f.name} must be >= 0, got {v}")


@dataclasses.dataclass(frozen=True)
class EventSweepPoint:
    """One event-engine configuration to replicate under random faults.

    ``recovery="auto"`` resolves the architecture's own
    :class:`~repro_torch.serverless.archs.ArchSpec` default — peer takeover
    for the in-DB SPIRT family, checkpoint-restore for everything else
    (the pairing ``benchmarks/fault_tolerance.py`` measures);
    ``autoscale_max > 0`` attaches a :class:`ReactiveAutoscaler` with
    the given bounds.  A non-``None`` ``trace`` replays measured
    cold-start/straggler tails via :meth:`FaultPlan.from_trace` instead
    of the Poisson ``FaultRates`` draws (crash/byzantine rates still
    apply — they are not part of the measured trace); it overrides any
    sweep-level trace passed to :func:`sweep_events`.
    """
    arch: str
    n_params: int
    compute_s_per_batch: float
    setup: ServerlessSetup = ServerlessSetup()
    significant_fraction: float = 0.3
    accumulation: int = 24
    recovery: str = "auto"             # "auto" | "restore" | "takeover"
    checkpoint_every: int = 4
    autoscale_min: int = 1
    autoscale_max: int = 0             # 0 => fixed fleet
    robust_trim: int = 0
    trace: Optional[Trace] = None
    label: str = ""


@dataclasses.dataclass
class EventPointStats:
    """Replicate aggregates for one sweep point."""
    point: EventSweepPoint
    n_replicates: int
    analytic_makespan_s: float
    analytic_cost: float
    makespan_mean_s: float
    makespan_p50_s: float
    makespan_p95_s: float
    ttr_mean_s: float
    ttr_p50_s: float
    ttr_p95_s: float
    cost_mean: float
    cost_overhead_mean: float
    cost_overhead_p50: float
    cost_overhead_p95: float


def _replicate_seed(base_seed: int, point_idx: int, replicate: int) -> int:
    # disjoint, reproducible streams per (point, replicate)
    return base_seed + 100_003 * point_idx + replicate


def _resolve_recovery(point: EventSweepPoint):
    # one shared string -> policy mapping (runtime.resolve_recovery);
    # "auto" resolves the ArchSpec's own recovery design
    return resolve_recovery(point.arch, point.recovery,
                            checkpoint_every=point.checkpoint_every)


def run_point_replicate(point: EventSweepPoint, rates: FaultRates,
                        seed: int, horizon_s: float,
                        trace: Optional[Trace] = None) -> RuntimeReport:
    """One seeded fault-injected epoch of one sweep point.  With a
    trace (per-point beats sweep-level), cold-start/straggler behaviour
    is resampled from the measured distributions instead of the Poisson
    rates."""
    trace = point.trace if point.trace is not None else trace
    if trace is not None:
        faults = FaultPlan.from_trace(
            trace, seed=seed, n_workers=point.setup.n_workers,
            horizon_s=horizon_s,
            base_cold_start_s=point.setup.cold_start_s,
            crash_rate=rates.crash_rate,
            byzantine_fraction=rates.byzantine_fraction,
            # autoscaled joiners must pay measured cold starts too.
            # Worker ids are never reused, so budget draws for the worst
            # churn case: the ReactiveAutoscaler adds at most `step` (1)
            # per barrier and there are ~batches_per_worker barriers per
            # epoch, so cumulative joiners cannot reach the budget
            n_spare_workers=(point.autoscale_max
                             + point.setup.batches_per_worker
                             if point.autoscale_max > 0 else 0))
    else:
        faults = FaultPlan.random(
            seed=seed, n_workers=point.setup.n_workers,
            horizon_s=horizon_s, crash_rate=rates.crash_rate,
            straggler_rate=rates.straggler_rate,
            byzantine_fraction=rates.byzantine_fraction,
            storm_prob=rates.storm_prob)
    autoscaler = (ReactiveAutoscaler(min_workers=point.autoscale_min,
                                     max_workers=point.autoscale_max)
                  if point.autoscale_max > 0 else None)
    return run_event_epoch(
        point.arch, n_params=point.n_params,
        compute_s_per_batch=point.compute_s_per_batch, setup=point.setup,
        significant_fraction=point.significant_fraction,
        accumulation=point.accumulation, faults=faults,
        recovery=_resolve_recovery(point), autoscaler=autoscaler,
        robust_trim=point.robust_trim)


def _run_point_job(job) -> List[Tuple[float, float, float]]:
    """Worker-process entry: all replicates of one point.  Module-level
    so it pickles under ProcessPoolExecutor.  The point's ArchSpec
    rides along and is re-registered on arrival: spawned workers
    re-import the package with only the built-in registrations, so a
    caller-registered architecture (examples/custom_arch.py) would
    otherwise be unknown in the child."""
    point, spec, rates, seeds, horizon_s, base_makespan, trace = job
    from repro_torch.serverless.archs import register_arch
    # unconditional overwrite: the parent's registration (including an
    # overwrite=True replacement of a built-in) must win over whatever
    # the child's fresh import registered
    register_arch(spec, overwrite=True)
    out = []
    for s in seeds:
        rep = run_point_replicate(point, rates, s, horizon_s, trace=trace)
        ttr = (rep.time_to_recover_s if rep.recoveries
               else max(rep.makespan_s - base_makespan, 0.0))
        out.append((rep.makespan_s, rep.total_cost, ttr))
    return out


def sweep_events(points: Sequence[EventSweepPoint], *,
                 rates: FaultRates = FaultRates(),
                 n_replicates: int = 8, seed: int = 0,
                 processes: Optional[int] = None,
                 trace: Optional[Trace] = None) -> List[EventPointStats]:
    """Replicate every point ``n_replicates`` times under seeded random
    faults, fanning points across ``processes`` worker processes
    (default: cpu count, capped at 8; pass 0/1 to run inline), and
    aggregate mean/p50/p95 makespan, time-to-recover and cost overhead.
    A ``trace`` switches every point (unless the point carries its own)
    from Poisson rate draws to trace-driven replay of measured
    cold-start/straggler tails — same seeding discipline, so results
    stay bit-reproducible from (points, trace, seed).
    """
    jobs = []
    bases = []
    for i, p in enumerate(points):
        base = simulate_epoch(p.arch, n_params=p.n_params,
                              compute_s_per_batch=p.compute_s_per_batch,
                              setup=p.setup,
                              significant_fraction=p.significant_fraction,
                              accumulation=p.accumulation)
        seeds = tuple(_replicate_seed(seed, i, r)
                      for r in range(n_replicates))
        jobs.append((p, get_arch(p.arch), rates, seeds, base.per_worker_s,
                     base.per_worker_s, trace))
        bases.append(base)
    if processes is None:
        processes = min(os.cpu_count() or 1, 8)
    if processes > 1 and len(jobs) > 1:
        # spawn, not fork: a process that has imported torch holds
        # thread pools that make forking it deadlock-prone.  Spawned
        # workers pay one interpreter+import start-up each, amortized
        # across the whole sweep — prefer processes=1 for small grids.
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=processes,
                                 mp_context=ctx) as ex:
            raw = list(ex.map(_run_point_job, jobs))
    else:
        raw = [_run_point_job(j) for j in jobs]

    stats = []
    for p, base, trips in zip(points, bases, raw):
        mk = np.asarray([t[0] for t in trips])
        cost = np.asarray([t[1] for t in trips])
        ttr = np.asarray([t[2] for t in trips])
        over = cost / base.total_cost - 1.0
        stats.append(EventPointStats(
            point=p, n_replicates=n_replicates,
            analytic_makespan_s=base.per_worker_s,
            analytic_cost=base.total_cost,
            makespan_mean_s=float(mk.mean()),
            makespan_p50_s=float(np.percentile(mk, 50)),
            makespan_p95_s=float(np.percentile(mk, 95)),
            ttr_mean_s=float(ttr.mean()),
            ttr_p50_s=float(np.percentile(ttr, 50)),
            ttr_p95_s=float(np.percentile(ttr, 95)),
            cost_mean=float(cost.mean()),
            cost_overhead_mean=float(over.mean()),
            cost_overhead_p50=float(np.percentile(over, 50)),
            cost_overhead_p95=float(np.percentile(over, 95))))
    return stats


# ---------------------------------------------------------------------------
# Layer 4: adversarial byzantine-fraction sweep
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdversarialGrid:
    """Byzantine fraction x attack model x aggregator grid over the
    deterministic quadratic-loss training path.

    The simulated optimum is the origin: worker ``i``'s honest gradient
    at step ``t`` is ``theta + noise[t, i]`` (quadratic loss
    ``0.5 * ||theta||^2`` plus seeded per-worker minibatch noise), the
    byzantine subset (the first ``round(fraction * W)`` workers —
    exchangeable, since the noise is i.i.d.) corrupts its rows through
    the registered attack model, and the aggregator's batched numpy
    twin (``repro_torch.serverless.adversarial.SIM_AGGREGATORS``) reduces the
    stack — the same statistics real training applies on-device.  Empty
    ``fractions`` / ``attacks`` / ``aggregators`` default to everything
    registered: the full ladder 0 -> (W-1)/2W, every attack model, and
    every ``SIM_AGGREGATORS`` statistic.

    ``attack_scales`` overrides individual attacks' default magnitudes
    (e.g. ``(("little_is_enough", 50.0),)``); robust aggregators are
    configured with the oracle budget ``f = min(n_byz, feasible cap)``
    so a curve's collapse past its cap IS the breakdown point.
    """
    n_workers: int = 12
    dim: int = 24
    steps: int = 80
    lr: float = 0.25
    noise: float = 0.05
    init_dist: float = 4.0
    converge_tol: float = 0.25
    fractions: Tuple[float, ...] = ()
    attacks: Tuple[str, ...] = ()
    aggregators: Tuple[str, ...] = ()
    attack_scales: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.n_workers < 3:
            raise ValueError(f"n_workers must be >= 3, got "
                             f"{self.n_workers}")
        for field, lo in (("dim", 1), ("steps", 1)):
            if getattr(self, field) < lo:
                raise ValueError(f"{field} must be >= {lo}, got "
                                 f"{getattr(self, field)}")
        for field in ("lr", "init_dist", "converge_tol"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be > 0, got "
                                 f"{getattr(self, field)}")
        if not np.isfinite(self.noise) or self.noise < 0:
            raise ValueError(f"noise must be finite and >= 0, got "
                             f"{self.noise}")
        for a in self.aggregators:
            # unknown names fail HERE with the registered list, not as
            # a bare KeyError mid-sweep
            sim_aggregator_max_f(a, self.n_workers)

    # empty tuple = everything registered, mirroring fractions/attacks
    # (a third-party SIM_AGGREGATORS entry shows up in default sweeps
    # with no edits here)
    def resolved_aggregators(self) -> Tuple[str, ...]:
        return self.aggregators or tuple(SIM_AGGREGATORS)

    def resolved_attacks(self) -> Tuple[str, ...]:
        return self.attacks or list_attacks()

    def resolved_fractions(self) -> Tuple[float, ...]:
        return self.fractions or byzantine_fractions(self.n_workers)


@dataclasses.dataclass(frozen=True)
class AdversarialCell:
    """One (aggregator, attack, fraction) result row.  A trajectory
    that overflows clean through inf reports ``final_dist=inf`` (never
    NaN), so same-seed sweeps always compare ``==`` cell for cell."""
    aggregator: str
    attack: str
    fraction: float
    n_byz: int
    f_used: int                        # oracle byzantine budget applied
    final_dist: float                  # |theta - theta*| after `steps`
    min_dist: float
    converged_step: int                # first step <= converge_tol; -1
    diverged: bool                     # left the 10x init_dist ball


def _adv_rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=tuple(key)))


def adversarial_sweep(grid: AdversarialGrid, *,
                      seed: int = 0) -> List[AdversarialCell]:
    """Evaluate the whole grid, vectorized over the fraction axis (one
    ``[n_fractions, W, dim]`` array-op block per step per
    (aggregator, attack) pair) and bit-reproducible from
    ``(grid, seed)`` — the same seeding discipline as
    :func:`sweep_events`: honest minibatch noise and the stochastic
    attacks draw from disjoint ``SeedSequence`` sub-streams, and the
    honest stream is SHARED across every cell so curves differ only by
    the adversarial configuration."""
    W, D = grid.n_workers, grid.dim
    fractions = grid.resolved_fractions()
    attacks = grid.resolved_attacks()
    scales = dict(grid.attack_scales)
    for name in scales:
        get_attack(name)               # unknown override -> actionable
    n_byz = np.asarray([int(round(f * W)) for f in fractions])
    if np.any(n_byz < 0) or np.any(n_byz > (W - 1) // 2):
        raise ValueError(
            f"fractions {tuple(fractions)} leave the aggregatable range:"
            f" byzantine counts {n_byz.tolist()} must stay within "
            f"[0, (W-1)//2] = [0, {(W - 1) // 2}] at W={W}")
    byz_mask = np.arange(W) < n_byz[:, None]           # [n_frac, W]

    honest_noise = _adv_rng(seed, 0).standard_normal(
        (grid.steps, W, D)) * grid.noise
    direction = _adv_rng(seed, 1).standard_normal(D)
    theta0 = direction / max(np.linalg.norm(direction), 1e-12) \
        * grid.init_dist

    cells: List[AdversarialCell] = []
    for agg_name in grid.resolved_aggregators():
        agg = SIM_AGGREGATORS[agg_name]
        f_used = np.minimum(n_byz, sim_aggregator_max_f(agg_name, W))
        for attack_name in attacks:
            spec = get_attack(attack_name)
            scale = scales.get(attack_name, spec.default_scale)
            # sub-stream keyed by the attack NAME (crc32, not its grid
            # or registry position): stochastic attacks replay
            # identically when the grid shrinks elsewhere, and every
            # aggregator block re-creates the same generator so the
            # chart panels compare aggregators on IDENTICAL corrupted
            # inputs
            arng = _adv_rng(seed, 2,
                            zlib.crc32(attack_name.encode("utf-8")))
            theta = np.tile(theta0, (len(n_byz), 1))
            dist = np.empty((grid.steps + 1, len(n_byz)))
            dist[0] = grid.init_dist
            with np.errstate(over="ignore", invalid="ignore"):
                for t in range(grid.steps):
                    g = theta[:, None, :] + honest_noise[t][None]
                    g = spec.apply_rows(g, byz_mask, arng, scale)
                    theta = theta - grid.lr * agg(g, f_used)
                    dist[t + 1] = np.linalg.norm(theta, axis=-1)
            below = dist <= grid.converge_tol          # [steps+1, n_frac]
            first = np.where(below.any(axis=0),
                             below.argmax(axis=0), -1)
            final = dist[-1]
            for i, frac in enumerate(fractions):
                fin = float(final[i])
                diverged = bool(not np.isfinite(fin)
                                or fin > 10.0 * grid.init_dist)
                if not np.isfinite(fin):
                    # overflow poisons the float through inf to NaN;
                    # report inf so NaN != NaN can never break the
                    # same-seed equality contract (min_dist is always
                    # finite: dist[0] = init_dist)
                    fin = float("inf")
                cells.append(AdversarialCell(
                    aggregator=agg_name, attack=attack_name,
                    fraction=float(frac), n_byz=int(n_byz[i]),
                    f_used=int(f_used[i]), final_dist=fin,
                    min_dist=float(np.nanmin(dist[:, i])),
                    converged_step=int(first[i]), diverged=diverged))
    return cells


def adversarial_curve(cells: Sequence[AdversarialCell], aggregator: str,
                      attack: str, metric: str = "final_dist"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One degradation curve: ``(fractions, metric values)`` sorted by
    fraction for a given (aggregator, attack) pair."""
    rows = sorted(((c.fraction, getattr(c, metric)) for c in cells
                   if c.aggregator == aggregator and c.attack == attack))
    if not rows:
        raise ValueError(f"no cells for aggregator={aggregator!r}, "
                         f"attack={attack!r}")
    fr, val = zip(*rows)
    return np.asarray(fr), np.asarray(val, float)
