"""Serverless training-architecture simulator.

Models the paper's execution semantics (§2, Table 1): stateless Lambda
workers that must (re)load model+data every invocation, communicate
gradients through external channels (Redis / S3), and synchronize via
queues — per architecture:

  SPIRT          P2P; per-worker in-DB gradient averaging (24 minibatches
                 per invocation via gradient accumulation), in-DB update.
  MLLess         significance filtering; supervisor-coordinated sync.
  ScatterReduce  chunk ownership; 2 rounds of chunk exchange.
  AllReduce      master aggregates; everyone else pushes+polls.
  GPU baseline   stateful instances; S3 gradient exchange only.

Timing model per invocation:
  t = cold_start (amortized) + state_load + K·compute + sync_comm + update
where sync_comm = strategy bytes / channel bandwidth + ops · latency.

Costs follow ``repro_torch.costmodel.pricing`` (Lambda GB-second; EC2 hourly).
The simulator is deliberately *analytic + compositional* — every number
in the paper's Table 2 decomposes into these terms, and
``benchmarks/table2_cost.py`` validates the decomposition against the
paper's reported values.

The per-round decomposition lives in :class:`RoundPlan` /
:func:`round_plan`, which the discrete-event engine
(``repro_torch.serverless.runtime``) replays event by event: ``simulate_epoch``
is the engine's closed-form fault-free fast path, and faults, recovery,
and elasticity live in the engine on top of the same timing terms.

Architecture semantics live in the pluggable registry
(``repro_torch.serverless.archs``): each :class:`~repro_torch.serverless.archs.
ArchSpec` carries its per-round term function, billing, channel policy
and recovery default, and :data:`ARCHS` (the paper's five) is derived
from it.  Registering a new spec is all it takes for an architecture to
flow through this module, the sweeps and the event engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.costmodel import pricing
from repro_torch.serverless.archs import (  # noqa: F401  (re-exported API)
    REDIS, S3, Channel, _grad_bytes, _transfer, arch_epoch_cost,
    arch_round_terms, get_arch, list_archs, paper_archs,
)


@dataclasses.dataclass(frozen=True)
class ServerlessSetup:
    n_workers: int = 4
    batches_per_worker: int = 24
    ram_gb: float = 2.0
    cold_start_s: float = 2.5
    model_bytes: float = 17e6          # MobileNet fp32 ~17 MB
    minibatch_bytes: float = 512 * 32 * 32 * 3 * 4
    channel: Channel = REDIS

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got "
                             f"{self.n_workers}")
        if self.batches_per_worker < 1:
            raise ValueError(f"batches_per_worker must be >= 1, got "
                             f"{self.batches_per_worker}")
        if not self.ram_gb > 0:
            raise ValueError(f"ram_gb must be > 0, got {self.ram_gb}")
        if self.cold_start_s < 0:
            raise ValueError(f"cold_start_s must be >= 0, got "
                             f"{self.cold_start_s}")
        if self.model_bytes < 0 or self.minibatch_bytes < 0:
            raise ValueError("model_bytes / minibatch_bytes must be "
                             ">= 0")


@dataclasses.dataclass
class StageBreakdown:
    fetch: float = 0.0
    compute: float = 0.0
    sync: float = 0.0
    update: float = 0.0

    @property
    def total(self) -> float:
        return self.fetch + self.compute + self.sync + self.update


@dataclasses.dataclass
class EpochReport:
    arch: str
    per_batch_s: float
    per_worker_s: float
    total_time_s: float
    stages: StageBreakdown
    comm_bytes_per_worker: float
    cost_per_worker: float
    total_cost: float
    ram_gb: float


# the paper's comparison set, derived from the registry (beyond-paper
# registrations show up in list_archs(), not here)
ARCHS = paper_archs()


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Per-sync-round stage durations for one architecture.

    A *round* is the unit between two cross-worker synchronization
    barriers: fetch (state load) -> compute ``batches_per_round``
    minibatches -> sync -> update.  The analytic :func:`simulate_epoch`
    sums these terms in closed form; the discrete-event engine
    (``repro_torch.serverless.runtime``) replays them event by event, so the
    two agree exactly in the fault-free case by construction.
    """
    arch: str
    n_workers: int
    n_rounds: int
    batches_per_round: float      # per worker per round
    fetch_s: float                # state (re)load at the top of a round
    fetch_first_round_only: bool  # stateful archs load once (gpu)
    compute_s_per_batch: float
    sync_s: float                 # per-worker sync work per round
    update_s: float
    cold_start_s: float
    model_bytes: float
    ram_gb: float
    sync_bytes: float = 0.0       # exact per-worker wire bytes per round
    update_bytes: float = 0.0     # (sum of the transfer() nbytes terms)
    barrier: bool = True          # False: workers commit syncs without
                                  # waiting for peers (async archs)

    @property
    def total_batches(self) -> float:
        """Epoch work for ONE worker (the pool is W times this)."""
        return self.n_rounds * self.batches_per_round

    @property
    def comm_bytes_per_round(self) -> float:
        """Gradient-path wire bytes one worker moves per round."""
        return self.sync_bytes + self.update_bytes


# the registry's dispatcher IS the implementation; this alias keeps the
# historical name the sweeps and tests import
_round_terms = arch_round_terms


def round_plan(arch: str, *, n_params: int, compute_s_per_batch: float,
               setup: ServerlessSetup = ServerlessSetup(),
               significant_fraction: float = 0.3,
               accumulation: int = 24) -> RoundPlan:
    """Decompose an architecture's epoch into per-round stage times."""
    ch = setup.channel
    terms = _round_terms(arch, n_params=n_params,
                         n_workers=setup.n_workers,
                         bandwidth_Bps=ch.bandwidth_Bps,
                         latency_s=ch.latency_s,
                         batches_per_worker=setup.batches_per_worker,
                         model_bytes=setup.model_bytes,
                         minibatch_bytes=setup.minibatch_bytes,
                         significant_fraction=significant_fraction,
                         accumulation=accumulation)
    # float()/int() strip numpy scalar types (bit-exact) so the event
    # engine's hot loop runs on native floats
    return RoundPlan(arch=arch, n_workers=setup.n_workers,
                     cold_start_s=setup.cold_start_s,
                     compute_s_per_batch=compute_s_per_batch,
                     model_bytes=setup.model_bytes, ram_gb=setup.ram_gb,
                     n_rounds=int(terms["n_rounds"]),
                     batches_per_round=float(terms["batches_per_round"]),
                     fetch_s=float(terms["fetch_s"]),
                     fetch_first_round_only=terms["fetch_first_round_only"],
                     sync_s=float(terms["sync_s"]),
                     update_s=float(terms["update_s"]),
                     sync_bytes=float(terms["sync_bytes"]),
                     update_bytes=float(terms["update_bytes"]),
                     barrier=bool(terms.get("barrier", True)))


def _epoch_terms(*, n_rounds, batches_per_round, fetch_s,
                 fetch_first_round_only, sync_s, update_s, sync_bytes,
                 update_bytes, compute_s_per_batch, cold_start_s,
                 batches_per_worker):
    """Epoch-level sums over the round terms.  Elementwise (scalars or
    arrays), shared by :func:`simulate_epoch` and the vectorized sweep
    so the closed forms agree bit-for-bit."""
    fetch = fetch_s * (1 if fetch_first_round_only else n_rounds)
    compute = (n_rounds * batches_per_round) * compute_s_per_batch
    sync = n_rounds * sync_s
    update = n_rounds * update_s
    # same association order as StageBreakdown.total
    per_worker = (fetch + compute + sync + update) + cold_start_s
    return dict(fetch=fetch, compute=compute, sync=sync, update=update,
                per_worker=per_worker,
                per_batch=per_worker / batches_per_worker,
                # exact wire bytes: latency ops contribute seconds, not
                # phantom bytes
                comm_bytes=n_rounds * (sync_bytes + update_bytes))


# billing dispatch now lives on the ArchSpec (Lambda GB-seconds vs
# instance-hours); alias kept for the sweeps and tests
_epoch_cost = arch_epoch_cost


def simulate_epoch(arch: str, *, n_params: int,
                   compute_s_per_batch: float,
                   setup: ServerlessSetup = ServerlessSetup(),
                   significant_fraction: float = 0.3,
                   accumulation: int = 24) -> EpochReport:
    """Simulate one training epoch under the given architecture.

    Closed-form fast path of the event engine: sums the
    :class:`RoundPlan` stage terms, assuming homogeneous fault-free
    workers (every barrier is free).  ``runtime.run_event_epoch``
    replays the identical plan event by event and reduces to these
    numbers when no faults are injected.
    """
    plan = round_plan(arch, n_params=n_params,
                      compute_s_per_batch=compute_s_per_batch, setup=setup,
                      significant_fraction=significant_fraction,
                      accumulation=accumulation)
    ep = _epoch_terms(n_rounds=plan.n_rounds,
                      batches_per_round=plan.batches_per_round,
                      fetch_s=plan.fetch_s,
                      fetch_first_round_only=plan.fetch_first_round_only,
                      sync_s=plan.sync_s, update_s=plan.update_s,
                      sync_bytes=plan.sync_bytes,
                      update_bytes=plan.update_bytes,
                      compute_s_per_batch=compute_s_per_batch,
                      cold_start_s=setup.cold_start_s,
                      batches_per_worker=setup.batches_per_worker)
    stages = StageBreakdown(fetch=ep["fetch"], compute=ep["compute"],
                            sync=ep["sync"], update=ep["update"])
    cost_worker, total_cost = _epoch_cost(arch, ep["per_worker"],
                                          setup.ram_gb, setup.n_workers)
    return EpochReport(arch=arch, per_batch_s=ep["per_batch"],
                       per_worker_s=ep["per_worker"],
                       total_time_s=ep["per_worker"],  # workers in parallel
                       stages=stages,
                       comm_bytes_per_worker=ep["comm_bytes"],
                       cost_per_worker=cost_worker,
                       total_cost=total_cost, ram_gb=setup.ram_gb)


# ---------------------------------------------------------------------------
# Paper-reported measurements (Table 2) — used to VALIDATE the cost
# arithmetic and as calibration anchors for the simulator.
# ---------------------------------------------------------------------------
PAPER_TABLE2 = {
    # arch: (per_batch_s, ram_mb, cost_per_worker, total_cost)
    "mobilenet": {
        "spirt": (15.44, 2685, 0.0165, 0.0660),
        "scatterreduce": (14.343, 2048, 0.0106, 0.0422),
        "allreduce": (14.382, 2048, 0.0107, 0.0427),
        "mlless": (69.425, 3024, 0.0839, 0.3356),
        "gpu": (92.00 / 24, None, 0.01344, 0.0538),
    },
    "resnet18": {
        "spirt": (28.55, 3200, 0.0365, 0.1460),
        "scatterreduce": (27.17, 2880, 0.0312, 0.1249),
        "allreduce": (26.79, 2986, 0.0332, 0.1328),
        "mlless": (78.39, 3630, 0.1137, 0.4548),
        "gpu": (139.00 / 24, None, 0.0203, 0.0812),
    },
}


def paper_compute_anchor(arch: str, model: str = "mobilenet") -> float:
    """Compute share of the paper's measured per-batch time: the
    non-compute stages account for ~15% of a serverless batch (~10% for
    the GPU baseline), so simulators anchored on Table 2 feed this as
    ``compute_s_per_batch``.  Shared by ``benchmarks/fault_tolerance``,
    ``benchmarks/pareto_sweep`` and the examples — one calibration,
    one place.  Beyond-paper architectures calibrate through their
    spec's ``anchor`` row (e.g. the SPIRT hybrids anchor on spirt) and
    ``compute_share``."""
    spec = get_arch(arch)
    row = PAPER_TABLE2[model].get(spec.anchor or spec.name)
    if row is None:
        raise ValueError(
            f"arch {arch!r} has no paper Table 2 calibration row; set "
            f"ArchSpec.anchor to one of {tuple(PAPER_TABLE2[model])} to "
            "use the anchored benchmarks")
    return row[0] * spec.compute_share


def paper_cost_check(model: str, arch: str) -> Dict[str, float]:
    """Recompute the paper's Table 2 cost from its reported time+RAM."""
    per_batch, ram_mb, cost_w, total = PAPER_TABLE2[model][arch]
    if arch == "gpu":
        t = per_batch * 24
        ours = pricing.gpu_cost(t)
        return {"paper_cost_per_worker": cost_w, "our_cost": ours,
                "paper_total": total, "our_total": ours * 4}
    per_fn = pricing.lambda_cost(per_batch, ram_mb / 1024.0)
    ours_worker = per_fn * 24
    return {"paper_cost_per_worker": cost_w, "our_cost": ours_worker,
            "paper_total": total, "our_total": ours_worker * 4}
