"""Vectorized steady-state fast path for the serving fleet.

The event engine (:mod:`repro_torch.serving.fleet`) is exact but walks every
request; a latency/cost Pareto sweep wants arch × replicas × RAM ×
arrival-rate grids with thousands of points.  This module answers each
grid point in closed form the way ``sweep_analytic`` vectorized
training epochs — whole-grid numpy columns, no Python loop over
requests — which is what lets ``benchmarks/serving_sweep.py`` simulate
millions of requests per second of wall clock.

Queueing model, per grid point:

  * the fleet is an M/G/c station with ``c = replicas × batch_size``
    servers (every cache slot serves one request at a time; the engine
    decodes all active slots each step, so slots are effectively
    independent servers at the per-request service rate);
  * service time ``S = prompt · prefill_s + (decode − 1) · decode_s``
    over the workload's empirical token distributions (prompt and
    decode counts independent → their outer product is the joint
    sample set), with the arch/RAM step times from
    :meth:`FleetSim.step_times`;
  * the wait is Erlang-C with the Allen–Cunneen squared-CV correction
    — ``Wq = C/(cμ − λ) · (1 + CV²)/2`` — and an exponential
    conditional tail calibrated to that mean:
    ``P(W > x) = C · exp(−C·x/Wq)``;
  * latency percentiles invert ``F_L(t) = E_S[F_W(t − S)]`` by
    vectorized bisection across all stable points at once.

``ρ ≥ 1`` points are kept in the columns but marked unstable with
``inf`` latencies (an open-loop queue there grows without bound —
exactly what the event engine shows if you insist).  Steady state has
no cold starts and no autoscaler by construction; the event path
covers those transients, and ``tests/test_serving_fleet.py`` (on the reference) pins the
two paths' agreement on the overlapping grid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.serverless.archs import get_arch, list_archs
from repro_torch.serving.fleet import FleetSim
from repro_torch.serving.workload import Workload


def _erlang_c(c: np.ndarray, a: np.ndarray) -> np.ndarray:
    """P(wait) for M/M/c at offered load ``a = λ·E[S]`` erlangs, via
    the Erlang-B recursion (vectorized over points; ``c`` is the
    per-point server count).  Valid where ``a < c``."""
    b = np.ones_like(a)
    kmax = int(c.max())
    for ki in range(1, kmax + 1):
        nb = a * b / (ki + a * b)
        b = np.where(ki <= c, nb, b)
    rho = a / c
    return b / (1.0 - rho * (1.0 - b))


@dataclasses.dataclass(frozen=True)
class ServingGrid:
    """Arch × replicas × RAM × arrival-rate grid for the analytic
    sweep; token distributions come from ``workload`` (its own rate is
    ignored — ``rate_rps`` is the swept axis)."""
    archs: Tuple[str, ...] = ()            # () => every registered arch
    replicas: Tuple[int, ...] = (1, 2, 4)
    ram_gb: Tuple[float, ...] = (2.0, 4.0)
    rate_rps: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
    batch_size: int = 8
    workload: Optional[Workload] = None    # None => bundled LLM trace
    prefill_s_per_token: float = 2e-4      # @ ref_ram_gb
    decode_step_s: float = 0.05
    ref_ram_gb: float = 2.0
    gpu_speedup: float = 8.0
    n_requests: int = 10_000               # per-point request mass

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got "
                             f"{self.batch_size}")
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got "
                             f"{self.n_requests}")
        for f, lo in (("replicas", 1), ("ram_gb", 0), ("rate_rps", 0)):
            vals = getattr(self, f)
            if not vals or any(v < lo or (lo == 0 and v <= 0)
                               for v in vals):
                raise ValueError(f"{f} must be non-empty with values "
                                 f">{'=' if lo else ''} {lo or 0}, "
                                 f"got {vals}")

    def resolved_archs(self) -> Tuple[str, ...]:
        return self.archs or list_archs()

    def resolved_workload(self) -> Workload:
        if self.workload is not None:
            return self.workload
        from repro_torch.serverless.traces import request_default
        return Workload(n_requests=self.n_requests,
                        trace=request_default())


@dataclasses.dataclass(frozen=True)
class ServingSweep:
    """Columnar result of :func:`serving_sweep_analytic` (one row per
    grid point)."""
    grid: ServingGrid
    arch: np.ndarray                   # str
    replicas: np.ndarray
    ram_gb: np.ndarray
    rate_rps: np.ndarray
    servers: np.ndarray                # c = replicas * batch_size
    rho: np.ndarray                    # utilisation; >= 1 => unstable
    stable: np.ndarray                 # bool
    service_mean_s: np.ndarray         # E[S]
    wait_mean_s: np.ndarray            # Wq (Allen–Cunneen)
    mean_latency_s: np.ndarray         # Wq + E[S]
    latency_p50_s: np.ndarray
    latency_p95_s: np.ndarray
    latency_p99_s: np.ndarray
    total_cost: np.ndarray             # serving grid.n_requests requests
    usd_per_1k_requests: np.ndarray

    def __len__(self) -> int:
        return len(self.arch)

    @property
    def requests_simulated(self) -> int:
        """Request mass the sweep covered — the throughput-record
        numerator (requests answered per wall-clock second)."""
        return len(self) * self.grid.n_requests


def _latency_percentile(q, s_samples, pw, theta, stable):
    """Invert F_L(t) = mean_i F_W(t - S_i) by bisection, vectorized
    over points.  ``s_samples`` is (N, M); ``pw``/``theta`` are (N,)."""
    n = s_samples.shape[0]
    out = np.full(n, np.inf)
    idx = np.flatnonzero(stable)
    if idx.size == 0:
        return out
    s = s_samples[idx]
    pwv = pw[idx][:, None]
    thv = theta[idx][:, None]

    def cdf(t):
        x = t[:, None] - s
        fw = np.where(x >= 0.0, 1.0 - pwv * np.exp(-thv * np.maximum(x, 0.0)),
                      0.0)
        return fw.mean(axis=1)

    lo = s.min(axis=1)
    hi = s.max(axis=1) + 1.0
    # expand hi until the CDF clears q everywhere (wait tails are
    # exponential, so doubling converges fast)
    for _ in range(60):
        short = cdf(hi) < q
        if not short.any():
            break
        hi = np.where(short, hi * 2.0 + 1.0, hi)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < q
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    out[idx] = 0.5 * (lo + hi)
    return out


def serving_sweep_analytic(grid: ServingGrid) -> ServingSweep:
    """Evaluate the whole grid in closed form (columnar, vectorized)."""
    archs = grid.resolved_archs()
    wl = grid.resolved_workload()

    # joint service-time sample set per (arch, ram): prompt and decode
    # counts are independent empirical draws -> outer product
    if wl.trace is not None and wl.trace.prompt_tokens:
        p_s = np.asarray(wl.trace.prompt_tokens, float)
    else:
        p_s = np.asarray([float(wl.prompt_tokens)])
    if wl.trace is not None and wl.trace.decode_tokens:
        d_s = np.asarray(wl.trace.decode_tokens, float)
    else:
        d_s = np.asarray([float(wl.decode_tokens)])
    pp, dd = np.meshgrid(p_s, d_s, indexing="ij")
    pp, dd = pp.ravel(), dd.ravel()            # (M,)

    rows_arch, rows_R, rows_ram, rows_rate = [], [], [], []
    step_pre, step_dec = [], []
    for a in archs:
        spec = get_arch(a)
        for ram in grid.ram_gb:
            if spec.ram_scales_compute:
                scale = grid.ref_ram_gb / ram
            else:
                scale = 1.0 / grid.gpu_speedup
            for R in grid.replicas:
                for rate in grid.rate_rps:
                    rows_arch.append(a)
                    rows_R.append(R)
                    rows_ram.append(ram)
                    rows_rate.append(rate)
                    step_pre.append(grid.prefill_s_per_token * scale)
                    step_dec.append(grid.decode_step_s * scale)

    arch_c = np.asarray(rows_arch, object)
    R_c = np.asarray(rows_R, float)
    ram_c = np.asarray(rows_ram, float)
    rate_c = np.asarray(rows_rate, float)
    pre_c = np.asarray(step_pre)[:, None]      # (N, 1)
    dec_c = np.asarray(step_dec)[:, None]

    s_samples = pp[None, :] * pre_c + np.maximum(dd - 1.0, 0.0)[None, :] \
        * dec_c                                # (N, M)
    es = s_samples.mean(axis=1)
    var = s_samples.var(axis=1)
    cv2 = np.divide(var, es ** 2, out=np.zeros_like(var),
                    where=es > 0)

    c = R_c * grid.batch_size
    a_load = rate_c * es
    rho = a_load / c
    stable = rho < 1.0

    pw = np.zeros_like(rho)
    wq = np.zeros_like(rho)
    if stable.any():
        i = np.flatnonzero(stable)
        pw_i = _erlang_c(c[i], a_load[i])
        mu = 1.0 / es[i]
        wq_i = pw_i / (c[i] * mu - rate_c[i]) * (1.0 + cv2[i]) / 2.0
        pw[i], wq[i] = pw_i, wq_i
    theta = np.divide(pw, wq, out=np.full_like(pw, np.inf),
                      where=wq > 0)            # tail rate: E[W] = Wq

    p50 = _latency_percentile(0.50, s_samples, pw, theta, stable)
    p95 = _latency_percentile(0.95, s_samples, pw, theta, stable)
    p99 = _latency_percentile(0.99, s_samples, pw, theta, stable)
    mean_lat = np.where(stable, wq + es, np.inf)

    # steady-state billing: serve grid.n_requests requests at rate λ ->
    # horizon T = n/λ, every replica up for all of it (the event path's
    # fleet_cost with R equal wall clocks)
    horizon = grid.n_requests / rate_c
    cost = np.empty_like(rate_c)
    for j in range(len(cost)):
        spec = get_arch(arch_c[j])
        cost[j] = spec.fleet_cost([horizon[j]] * int(R_c[j]), ram_c[j],
                                  horizon[j], n_instances=int(R_c[j]))
    usd_per_1k = cost / grid.n_requests * 1000.0

    return ServingSweep(
        grid=grid, arch=arch_c, replicas=R_c.astype(int),
        ram_gb=ram_c, rate_rps=rate_c, servers=c.astype(int), rho=rho,
        stable=stable, service_mean_s=es, wait_mean_s=wq,
        mean_latency_s=mean_lat, latency_p50_s=p50, latency_p95_s=p95,
        latency_p99_s=p99, total_cost=cost,
        usd_per_1k_requests=usd_per_1k)


def analytic_point(sim: FleetSim, workload: Workload,
                   rate_rps: Optional[float] = None) -> dict:
    """One FleetSim configuration through the analytic path — the
    agreement tests' bridge between the two engines."""
    grid = ServingGrid(
        archs=(sim.arch,), replicas=(sim.replicas,),
        ram_gb=(sim.ram_gb,),
        rate_rps=(rate_rps if rate_rps is not None
                  else workload.mean_rate_rps(),),
        batch_size=sim.batch_size, workload=workload,
        prefill_s_per_token=sim.prefill_s_per_token,
        decode_step_s=sim.decode_step_s, ref_ram_gb=sim.ref_ram_gb,
        gpu_speedup=sim.gpu_speedup)
    sw = serving_sweep_analytic(grid)
    return {f.name: getattr(sw, f.name)[0]
            for f in dataclasses.fields(sw) if f.name != "grid"}
