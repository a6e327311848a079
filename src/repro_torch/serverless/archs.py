"""Pluggable architecture registry (``repro.serverless.archs``): one
:class:`ArchSpec` per training architecture, unifying every layer of the
serverless stack.  Carried over from the reference with its names and
arithmetic; the golden snapshot ``tests/golden/serverless_golden.json``
pins the numbers bit for bit.  An architecture is ONE frozen
:class:`ArchSpec` carrying

  * ``round_terms``   — the per-round stage arithmetic (elementwise:
    scalars or numpy arrays, so the same function backs the scalar
    ``simulate_epoch`` and the vectorized ``sweep_analytic``);
  * ``stateful``      — whether state loads once per epoch (the GPU
    baseline) or once per round (stateless Lambda);
  * ``sync_channel``  — an optional *pinned* gradient channel (the GPU
    baseline always exchanges via S3 regardless of the configured
    channel; sweeps use this to mark label-vs-numbers mismatches);
  * ``cost`` / ``fleet_cost`` — analytic and event-engine billing
    (Lambda GB-seconds vs instance-hours);
  * ``default_recovery`` — what crash recovery the architecture gets
    when the caller asks for ``"auto"`` (SPIRT-style in-DB state means
    peer takeover; everything else re-invokes and replays);
  * ``jax_strategy``  — the :mod:`repro_torch.core.strategies` name
    realizing the architecture in real training, so the simulated arch
    and the real-training arch are one object
    (``repro_torch.core.get_strategy(spec.name)`` resolves through here;
    the field keeps the reference's name so the two registries compare
    field by field);
  * ``anchor`` / ``compute_share`` — which paper Table 2 row calibrates
    ``simulator.paper_compute_anchor`` for the architecture.

``register_arch`` / ``get_arch`` / ``list_archs`` manage the registry.
The five paper architectures (``paper=True``) register first, in the
paper's order; ``simulator.ARCHS`` is derived from them.  Two
beyond-paper hybrids register below and flow automatically through
``sweep_analytic``, ``sweep_events`` (including trace replay) and the
event engine:

  hier_spirt  two-level hierarchy: SPIRT's in-DB averaging inside
              sqrt(W)-sized groups, ScatterReduce-style chunk exchange
              across group leaders (the hybrid direction SPIRT's P2P
              fault-tolerance lineage — arXiv 2309.14148 / 2302.13995
              — points at).
  spirt_s3    SPIRT semantics with the gradient path pinned to S3,
              isolating the Redis premium from the algorithm.

A further family of asynchronous / semi-sync / compressed variants
(``local_sgd``, ``async_spirt``, ``async_spirt_q8``,
``scatterreduce_q8``, ``spirt_sf``) registers at the bottom of this
module: ``barrier_sync=False`` switches the event runtime to
barrier-free per-worker commits under a bounded-staleness convergence
tax, and ``compression`` scales the wire bytes through
:data:`COMPRESSION_SCHEMES` (int8 quantization per
``QuantizedScatterReduce``, MLLess significance filtering).

This module stays import-light (numpy + pricing only, no torch), so
analytic sweeps never pay accelerator import costs;
``ArchSpec.make_strategy`` lazy-imports the training side.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.costmodel import pricing


# ---------------------------------------------------------------------------
# Channels (moved here from simulator.py, which re-exports them)
# ---------------------------------------------------------------------------
def _transfer(nbytes, bandwidth_Bps, latency_s, ops=1):
    """Channel transfer time.  Elementwise — every argument may be a
    Python scalar or a broadcastable numpy array, which is what lets the
    vectorized sweep (``repro_torch.serverless.sweep``) evaluate whole grids
    through the *same* expressions the scalar path uses (exact
    agreement by construction)."""
    return nbytes / bandwidth_Bps + ops * latency_s


@dataclasses.dataclass(frozen=True)
class Channel:
    """External state channel (Redis on EC2 / S3)."""
    name: str = "redis"
    bandwidth_Bps: float = 1.25e9 / 8 * 10      # ~10 Gb EC2 NIC -> 1.25 GB/s
    latency_s: float = 0.002                    # per operation RTT

    def transfer(self, nbytes: float, ops: int = 1) -> float:
        return _transfer(nbytes, self.bandwidth_Bps, self.latency_s, ops)


S3 = Channel("s3", bandwidth_Bps=0.6e9, latency_s=0.030)
REDIS = Channel("redis")


def _grad_bytes(n_params: int, dtype_bytes: int = 4) -> float:
    return n_params * dtype_bytes


# ---------------------------------------------------------------------------
# Wire compression schemes
# ---------------------------------------------------------------------------
# Mirrors core.compression.QuantizedScatterReduce.chunk — the wire factor
# below must stay in lock-step with that strategy's comm_bytes.
_Q8_CHUNK = 512


def _int8_wire_scale(significant_fraction):
    # int8 payload plus one fp32 scale per chunk: the exact per-byte
    # factor QuantizedScatterReduce.comm_bytes charges.  The *update*
    # path shrinks by the same factor because the aggregate is
    # requantized before the all-gather — the update IS int8 + scales.
    return 0.25 * (1.0 + 4.0 / _Q8_CHUNK)


def _significance_wire_scale(significant_fraction):
    # MLLess semantics: only the significant fraction of the gradient
    # crosses the wire (error feedback keeps the rest local).  Only
    # meaningful for archs whose update path is in-DB (update_bytes=0);
    # a dense model pull would not be filtered.
    return significant_fraction


COMPRESSION_SCHEMES: Dict[str, Callable[[Any], Any]] = {
    "int8": _int8_wire_scale,
    "significance": _significance_wire_scale,
}


# ---------------------------------------------------------------------------
# Billing policies
# ---------------------------------------------------------------------------
def lambda_epoch_cost(per_worker_s, ram_gb, n_workers):
    """Analytic epoch billing for stateless Lambda workers; elementwise
    ``(cost_per_worker, total_cost)``."""
    cost_worker = pricing.lambda_cost(per_worker_s, ram_gb)
    return cost_worker, cost_worker * n_workers


def instance_epoch_cost(per_worker_s, ram_gb, n_workers):
    """Analytic epoch billing for stateful instances (GPU baseline):
    hourly rate, RAM tier is part of the instance price."""
    cost_worker = pricing.gpu_cost(per_worker_s)
    return cost_worker, cost_worker * n_workers


def lambda_fleet_cost(wall_clocks, ram_gb, makespan_s, n_instances):
    """Event-engine billing: each Lambda bills GB-seconds for its whole
    invocation wall-clock (barrier stalls included)."""
    return sum(pricing.lambda_cost(t, ram_gb) for t in wall_clocks)


def instance_fleet_cost(wall_clocks, ram_gb, makespan_s, n_instances):
    """Event-engine billing: instances bill hourly for the makespan."""
    return pricing.gpu_cost(makespan_s, n_instances=n_instances)


# ---------------------------------------------------------------------------
# ArchSpec + registry
# ---------------------------------------------------------------------------
TermFn = Callable[..., Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Everything the stack needs to know about one architecture.

    ``round_terms(G=, W=, bw=, lat=, sync_bw=, sync_lat=, nb=,
    significant_fraction=, accumulation=)`` returns the per-round dict
    (``n_rounds``, ``batches_per_round``, ``sync_s``, ``update_s``,
    ``sync_bytes``, ``update_bytes``); the shared dispatcher
    :func:`arch_round_terms` adds the common state-load term and the
    ``stateful`` fetch policy.  ``sync_bw``/``sync_lat`` are the
    gradient path's channel — the configured one unless
    ``sync_channel`` pins it.
    """
    name: str
    round_terms: TermFn
    description: str = ""
    paper: bool = False                    # one of the paper's five
    stateful: bool = False                 # load state once per epoch
    sync_channel: Optional[Channel] = None  # pinned gradient channel
    cost: Callable = lambda_epoch_cost
    fleet_cost: Callable = lambda_fleet_cost
    default_recovery: str = "restore"      # "restore" | "takeover"
    jax_strategy: Optional[str] = None     # core.get_strategy name
    jax_strategy_kwargs: Tuple[Tuple[str, Any], ...] = ()
    ram_scales_compute: bool = True        # Lambda vCPU scales with RAM
    anchor: Optional[str] = None           # PAPER_TABLE2 calibration row
    compute_share: float = 0.85            # compute share of paper time
    # how the architecture combines the fleet's gradients when workers
    # may be adversarial — the paper's per-arch vulnerability story:
    # SPIRT's in-database aggregation is byzantine-robust (trimmed
    # mean), everything else plain-averages.  Must name a simulated
    # aggregator in repro_torch.serverless.adversarial.SIM_AGGREGATORS;
    # benchmarks/adversarial_curves.py draws each architecture's
    # byzantine-fraction degradation curve under this statistic.
    default_aggregator: str = "mean"
    # --- asynchrony ---------------------------------------------------
    # barrier_sync=False makes the event runtime commit each worker's
    # sync immediately instead of waiting at the round barrier:
    # stragglers no longer stall the fleet, but convergence pays a
    # staleness tax.  Async specs MUST declare a bounded staleness model
    # (the `staleness-spec` lint rule pins this statically, the
    # validation below pins it at runtime): the effective staleness —
    # (W - 1) concurrent unsynced peers for barrier-free specs,
    # (accumulation - 1) deferred local steps for semi-sync ones — is
    # capped at `staleness_bound`, and the work to converge inflates by
    # (1 + staleness_penalty * min(staleness, staleness_bound)),
    # modeled like the accumulation-fraction axis: folded into the
    # per-round terms so round counts stay integral.
    barrier_sync: bool = True
    staleness_bound: float = 0.0
    staleness_penalty: float = 0.0
    # optional wire-compression scheme applied to the gradient bytes G
    # before the round terms are computed — a COMPRESSION_SCHEMES key
    compression: Optional[str] = None

    def __post_init__(self):
        if self.default_recovery not in ("restore", "takeover"):
            raise ValueError(
                f"arch {self.name!r}: default_recovery must be "
                f"'restore' or 'takeover', got "
                f"{self.default_recovery!r}")
        from repro_torch.serverless.adversarial import SIM_AGGREGATORS
        if self.default_aggregator not in SIM_AGGREGATORS:
            raise ValueError(
                f"arch {self.name!r}: default_aggregator must be one "
                f"of {', '.join(SIM_AGGREGATORS)}, got "
                f"{self.default_aggregator!r}")
        if self.staleness_bound < 0 or self.staleness_penalty < 0:
            raise ValueError(
                f"arch {self.name!r}: staleness_bound/staleness_penalty "
                "must be non-negative")
        if not self.barrier_sync:
            if not (self.staleness_bound > 0
                    and math.isfinite(self.staleness_bound)):
                raise ValueError(
                    f"arch {self.name!r}: barrier-free (async) specs "
                    "must declare a finite positive staleness_bound, "
                    f"got {self.staleness_bound!r}")
            if not self.staleness_penalty > 0:
                raise ValueError(
                    f"arch {self.name!r}: barrier-free (async) specs "
                    "must declare a positive staleness_penalty, got "
                    f"{self.staleness_penalty!r}")
        if (self.compression is not None
                and self.compression not in COMPRESSION_SCHEMES):
            raise ValueError(
                f"arch {self.name!r}: unknown compression "
                f"{self.compression!r}; registered: "
                f"{', '.join(COMPRESSION_SCHEMES)}")

    def pins_channel(self, channel: Channel) -> bool:
        """True when the configured ``channel`` is overridden by this
        architecture's pinned gradient channel — the grid point's label
        then disagrees with its sync numbers and sweeps mark it."""
        return (self.sync_channel is not None
                and channel.name != self.sync_channel.name)

    def make_strategy(self, **overrides):
        """The real-training :class:`repro_torch.core.strategies.Strategy`
        realizing this architecture (lazy import — keeps this module
        torch-free for analytic-only users)."""
        if self.jax_strategy is None:
            raise ValueError(f"arch {self.name!r} has no strategy")
        from repro_torch.core.strategies import STRATEGIES, get_strategy
        if self.jax_strategy == self.name \
                and self.jax_strategy not in STRATEGIES:
            # get_strategy falls through to the registry for arch names
            # it doesn't know, so a spec naming itself (with no
            # concrete strategy behind the name — unlike e.g. spirt,
            # which IS a STRATEGIES entry) would recurse forever
            raise ValueError(
                f"arch {self.name!r} names itself as its jax_strategy; "
                "name a concrete repro_torch.core.strategies entry instead")
        kw = dict(self.jax_strategy_kwargs)
        kw.update(overrides)
        return get_strategy(self.jax_strategy, **kw)


_REGISTRY: Dict[str, ArchSpec] = {}


def register_arch(spec: ArchSpec, *, overwrite: bool = False) -> ArchSpec:
    """Add ``spec`` to the registry (returns it, so modules can keep a
    handle).  Re-registering a name is an error unless ``overwrite``
    — silent replacement is how five-files-in-lock-step bugs start."""
    if not overwrite and spec.name in _REGISTRY:
        raise ValueError(f"architecture {spec.name!r} is already "
                         "registered (pass overwrite=True to replace)")
    _REGISTRY[spec.name] = spec
    return spec


def unregister_arch(name: str) -> None:
    """Remove an architecture (tests / examples cleaning up after
    themselves)."""
    _REGISTRY.pop(name, None)


def get_arch(name: str) -> ArchSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown architecture {name!r}; registered: "
            f"{', '.join(_REGISTRY)}") from None


def list_archs() -> Tuple[str, ...]:
    """All registered architecture names, in registration order (the
    paper's five first)."""
    return tuple(_REGISTRY)


def paper_archs() -> Tuple[str, ...]:
    """The paper's comparison set (``simulator.ARCHS`` derives from
    this)."""
    return tuple(n for n, s in _REGISTRY.items() if s.paper)


# ---------------------------------------------------------------------------
# Shared dispatcher (backs simulator._round_terms and the sweeps)
# ---------------------------------------------------------------------------
def arch_round_terms(arch, *, n_params, n_workers, bandwidth_Bps,
                     latency_s, batches_per_worker, model_bytes,
                     minibatch_bytes, significant_fraction, accumulation):
    """Per-round stage arithmetic for one architecture, resolved through
    the registry.  Elementwise: every numeric argument may be a scalar
    or a broadcastable numpy array — one implementation backs BOTH the
    scalar :func:`repro_torch.serverless.simulator.round_plan` and the
    vectorized analytic sweep, so the two agree bit-for-bit.

    Alongside each stage *time* the spec returns the exact wire *bytes*
    the stage moves (the sum of the ``nbytes`` arguments fed to the
    channel) — per-op latencies contribute seconds but never bytes.
    """
    spec = arch if isinstance(arch, ArchSpec) else get_arch(arch)
    if spec.sync_channel is not None:
        sync_bw = spec.sync_channel.bandwidth_Bps
        sync_lat = spec.sync_channel.latency_s
    else:
        sync_bw, sync_lat = bandwidth_Bps, latency_s
    G = _grad_bytes(n_params)
    if spec.compression is not None:
        # wire compression shrinks the gradient bytes every stage moves
        # (the schemes are only paired with term fns whose update path
        # is either in-DB or itself compressed — see the scheme notes)
        G = G * COMPRESSION_SCHEMES[spec.compression](significant_fraction)
    terms = spec.round_terms(
        G=G, W=n_workers,
        bw=bandwidth_Bps, lat=latency_s,
        sync_bw=sync_bw, sync_lat=sync_lat,
        nb=batches_per_worker,
        significant_fraction=significant_fraction,
        accumulation=accumulation)
    if spec.staleness_penalty:
        # converging under staleness needs `factor`x the gradient work;
        # fold it into the per-round terms (keeping n_rounds integral so
        # the scalar and vectorized paths stay bit-exact) — the state
        # reload amortizes, so the tax lands on compute and comm
        staleness = (n_workers - 1.0) if not spec.barrier_sync \
            else (accumulation - 1.0)
        factor = 1.0 + spec.staleness_penalty \
            * np.minimum(staleness, spec.staleness_bound)
        for key in ("batches_per_round", "sync_s", "update_s",
                    "sync_bytes", "update_bytes"):
            terms[key] = terms[key] * factor
    terms["barrier"] = spec.barrier_sync
    # every invocation of a stateless worker reloads model + minibatch;
    # stateful archs pay it once (fetch_first_round_only)
    terms["fetch_s"] = _transfer(model_bytes + minibatch_bytes,
                                 bandwidth_Bps, latency_s, ops=2)
    terms["fetch_first_round_only"] = spec.stateful
    return terms


def arch_epoch_cost(arch, per_worker_s, ram_gb, n_workers):
    """(cost_per_worker, total_cost); elementwise in the numeric args."""
    spec = arch if isinstance(arch, ArchSpec) else get_arch(arch)
    return spec.cost(per_worker_s, ram_gb, n_workers)


# ---------------------------------------------------------------------------
# The paper's five architectures
# ---------------------------------------------------------------------------
def _spirt_terms(*, G, W, bw, lat, sync_bw, sync_lat, nb,
                 significant_fraction, accumulation):
    # one long-lived invocation per epoch computes `accumulation`
    # minibatches; gradients averaged IN the local Redis (in-database
    # ops): per-minibatch store + one in-db average; a single
    # cross-worker sync per accumulation round.
    invocations = np.maximum(1, nb // accumulation)
    bpr = nb / invocations
    cross = (W - 1) * _transfer(G, sync_bw, sync_lat, ops=2) \
        + 2 * sync_lat * W                  # sync queue polls
    return dict(n_rounds=invocations, batches_per_round=bpr,
                sync_s=bpr * _transfer(G, sync_bw, sync_lat, ops=1)
                + cross,
                update_s=_transfer(0, sync_bw, sync_lat, ops=1),  # in-db
                sync_bytes=bpr * G + (W - 1) * G,
                update_bytes=0 * G)


def _mlless_terms(*, G, W, bw, lat, sync_bw, sync_lat, nb,
                  significant_fraction, accumulation):
    # per-minibatch invocations; only significant updates pushed;
    # supervisor round-trip gates every sync step
    pushed = significant_fraction * G
    per_sync = (_transfer(pushed, sync_bw, sync_lat, ops=1)
                + (W - 1) * _transfer(pushed, sync_bw, sync_lat, ops=1)
                + 4 * sync_lat              # queue notify + supervisor
                + 2 * sync_lat * W)         # supervisor fan-out
    return dict(n_rounds=nb, batches_per_round=1.0,
                sync_s=per_sync,
                update_s=_transfer(G, sync_bw, sync_lat, ops=1),
                sync_bytes=pushed + (W - 1) * pushed,
                update_bytes=1.0 * G)


def _scatterreduce_terms(*, G, W, bw, lat, sync_bw, sync_lat, nb,
                         significant_fraction, accumulation):
    # push W-1 chunks, fetch W-1 assigned chunks, push aggregate,
    # fetch W-1 aggregated chunks
    chunk = G / W
    per_sync = (_transfer((W - 1) * chunk, sync_bw, sync_lat,
                          ops=W - 1) * 2
                + _transfer(chunk, sync_bw, sync_lat, ops=1)
                + _transfer((W - 1) * chunk, sync_bw, sync_lat,
                            ops=W - 1))
    return dict(n_rounds=nb, batches_per_round=1.0,
                sync_s=per_sync,
                update_s=_transfer(G, sync_bw, sync_lat, ops=1),
                sync_bytes=(W - 1) * chunk * 2 + chunk + (W - 1) * chunk,
                update_bytes=1.0 * G)


def _allreduce_terms(*, G, W, bw, lat, sync_bw, sync_lat, nb,
                     significant_fraction, accumulation):
    # everyone pushes G; the designated master then pulls all W
    # gradients SERIALLY, aggregates and pushes the result; every
    # worker blocks on the master (the paper's §4.2 scalability
    # bottleneck), then fetches
    master_path = W * _transfer(G, sync_bw, sync_lat, ops=1) \
        + _transfer(G, sync_bw, sync_lat, ops=1)
    per_sync = (_transfer(G, sync_bw, sync_lat, ops=1) + master_path
                + _transfer(G, sync_bw, sync_lat, ops=1))
    return dict(n_rounds=nb, batches_per_round=1.0,
                sync_s=per_sync,
                update_s=_transfer(G, sync_bw, sync_lat, ops=1),
                sync_bytes=1.0 * G + (W * G + G) + G,
                update_bytes=1.0 * G)


def _gpu_terms(*, G, W, bw, lat, sync_bw, sync_lat, nb,
               significant_fraction, accumulation):
    # stateful: load once; gradient exchange on the pinned S3 channel
    per_sync = _transfer(G, sync_bw, sync_lat, ops=1) \
        + (W - 1) * _transfer(G, sync_bw, sync_lat, ops=1)
    return dict(n_rounds=nb, batches_per_round=1.0,
                sync_s=per_sync, update_s=0.0,
                sync_bytes=1.0 * G + (W - 1) * G,
                update_bytes=0 * G)


register_arch(ArchSpec(
    name="spirt", round_terms=_spirt_terms, paper=True,
    description="P2P; per-worker in-DB gradient averaging + in-DB "
                "update, one cross-worker sync per accumulation round",
    default_recovery="takeover", default_aggregator="trimmed_mean",
    jax_strategy="spirt", jax_strategy_kwargs=(("microbatches", 4),)))

register_arch(ArchSpec(
    name="mlless", round_terms=_mlless_terms, paper=True,
    description="significance filtering; supervisor-coordinated sync",
    jax_strategy="mlless", jax_strategy_kwargs=(("threshold", 0.7),)))

register_arch(ArchSpec(
    name="scatterreduce", round_terms=_scatterreduce_terms, paper=True,
    description="chunk ownership; 2 rounds of chunk exchange",
    jax_strategy="scatterreduce"))

register_arch(ArchSpec(
    name="allreduce", round_terms=_allreduce_terms, paper=True,
    description="master aggregates; everyone else pushes+polls",
    jax_strategy="parameter_server"))

register_arch(ArchSpec(
    name="gpu", round_terms=_gpu_terms, paper=True,
    description="stateful instances; S3 gradient exchange only",
    stateful=True, sync_channel=S3,
    cost=instance_epoch_cost, fleet_cost=instance_fleet_cost,
    jax_strategy="allreduce",              # ring all-reduce on-device
    ram_scales_compute=False,              # fixed by the accelerator
    compute_share=0.90))


# ---------------------------------------------------------------------------
# Beyond-paper hybrids — registered here and NOWHERE else; everything
# downstream (sweeps, event engine, trace replay, Pareto/knee
# benchmarks) picks them up through the registry.
# ---------------------------------------------------------------------------
def _hier_spirt_terms(*, G, W, bw, lat, sync_bw, sync_lat, nb,
                      significant_fraction, accumulation):
    # two-level hierarchy: SPIRT's in-DB averaging inside groups of
    # ~sqrt(W) workers, then a ScatterReduce-style chunk exchange among
    # the group leaders.  Group-local traffic is identical to SPIRT
    # with W -> group size; the cross-group path moves n_groups chunks
    # of G / n_groups bytes instead of (W-1) full gradients, which is
    # what flattens the sync wall at large W.
    group = np.maximum(1, np.floor(np.sqrt(W)))
    n_groups = np.ceil(W / group)
    invocations = np.maximum(1, nb // accumulation)
    bpr = nb / invocations
    local = bpr * _transfer(G, sync_bw, sync_lat, ops=1) \
        + (group - 1) * _transfer(G, sync_bw, sync_lat, ops=2) \
        + 2 * sync_lat * group              # group-local queue polls
    chunk = G / n_groups
    cross = (_transfer((n_groups - 1) * chunk, sync_bw, sync_lat,
                       ops=n_groups - 1) * 2
             + _transfer(chunk, sync_bw, sync_lat, ops=1))
    return dict(n_rounds=invocations, batches_per_round=bpr,
                sync_s=local + cross,
                update_s=_transfer(0, sync_bw, sync_lat, ops=1),  # in-db
                sync_bytes=bpr * G + (group - 1) * G
                + (n_groups - 1) * chunk * 2 + chunk,
                update_bytes=0 * G)


register_arch(ArchSpec(
    name="hier_spirt", round_terms=_hier_spirt_terms,
    description="two-level SPIRT: group-local in-DB averaging, "
                "cross-group chunk exchange among leaders",
    default_recovery="takeover",           # state lives in the DB
    default_aggregator="trimmed_mean",     # in-DB robust statistic
    jax_strategy="spirt", jax_strategy_kwargs=(("microbatches", 4),),
    anchor="spirt"))

register_arch(ArchSpec(
    name="spirt_s3", round_terms=_spirt_terms,
    description="SPIRT semantics over the S3 channel (isolates the "
                "Redis premium from the algorithm)",
    sync_channel=S3,
    default_recovery="takeover",           # state lives in S3 instead
    default_aggregator="trimmed_mean",     # in-DB robust statistic
    jax_strategy="spirt", jax_strategy_kwargs=(("microbatches", 4),),
    anchor="spirt"))


# ---------------------------------------------------------------------------
# Asynchronous / semi-sync / compressed-communication architectures.
# Registered here and NOWHERE else (additive extension): the paper
# specs above are pinned bit-exactly by tests/golden/, so the missing
# axis of the cost-performance analysis — staleness-tolerant peer
# updates (SPIRT's in-DB lineage, arXiv 2309.14148) and compressed
# wire bytes (arXiv 2105.07806's communication-dominates result) —
# enters purely additively.
# ---------------------------------------------------------------------------
def _async_spirt_terms(*, G, W, bw, lat, sync_bw, sync_lat, nb,
                       significant_fraction, accumulation):
    # barrier-free SPIRT: accumulate like SPIRT, but instead of the
    # (W-1)-wide cross-worker exchange + queue polls, each worker
    # pushes its accumulated gradient to the shared store and pulls the
    # merged state whenever it arrives — O(1) in W.  Dropping the
    # (W-1) term is the whole speedup; the dispatcher's staleness
    # factor is the price.
    invocations = np.maximum(1, nb // accumulation)
    bpr = nb / invocations
    return dict(n_rounds=invocations, batches_per_round=bpr,
                sync_s=bpr * _transfer(G, sync_bw, sync_lat, ops=1)
                + _transfer(G, sync_bw, sync_lat, ops=2),
                update_s=_transfer(0, sync_bw, sync_lat, ops=1),  # in-db
                sync_bytes=bpr * G + G,
                update_bytes=0 * G)


def _local_sgd_terms(*, G, W, bw, lat, sync_bw, sync_lat, nb,
                     significant_fraction, accumulation):
    # semi-sync local SGD: `accumulation` local steps between barriers,
    # each barrier a ScatterReduce-style chunk exchange of the
    # accumulated model delta (same wire pattern as scatterreduce, but
    # amortized over the sync period)
    invocations = np.maximum(1, nb // accumulation)
    bpr = nb / invocations
    chunk = G / W
    per_sync = (_transfer((W - 1) * chunk, sync_bw, sync_lat,
                          ops=W - 1) * 2
                + _transfer(chunk, sync_bw, sync_lat, ops=1)
                + _transfer((W - 1) * chunk, sync_bw, sync_lat,
                            ops=W - 1))
    return dict(n_rounds=invocations, batches_per_round=bpr,
                sync_s=per_sync,
                update_s=_transfer(G, sync_bw, sync_lat, ops=1),
                sync_bytes=(W - 1) * chunk * 2 + chunk + (W - 1) * chunk,
                update_bytes=1.0 * G)


register_arch(ArchSpec(
    name="local_sgd", round_terms=_local_sgd_terms,
    description="semi-sync local SGD: accumulation local steps per "
                "barrier, chunked delta exchange at each barrier; the "
                "deferred steps pay the staleness tax",
    staleness_penalty=0.004, staleness_bound=16.0,
    jax_strategy="spirt", jax_strategy_kwargs=(("microbatches", 4),),
    anchor="scatterreduce"))

register_arch(ArchSpec(
    name="async_spirt", round_terms=_async_spirt_terms,
    barrier_sync=False, staleness_bound=8.0, staleness_penalty=0.02,
    description="barrier-free SPIRT: workers push/pull the shared "
                "in-DB state without waiting for peers; bounded "
                "staleness, stragglers never stall the fleet",
    default_recovery="takeover",           # state lives in the DB
    default_aggregator="trimmed_mean",     # in-DB robust statistic
    jax_strategy="spirt", jax_strategy_kwargs=(("microbatches", 4),),
    anchor="spirt"))

register_arch(ArchSpec(
    name="async_spirt_q8", round_terms=_async_spirt_terms,
    barrier_sync=False, staleness_bound=8.0, staleness_penalty=0.02,
    compression="int8",
    description="async SPIRT with int8-quantized pushes (wire bytes "
                "follow QuantizedScatterReduce's payload factor)",
    default_recovery="takeover",
    default_aggregator="trimmed_mean",
    jax_strategy="quantized_scatterreduce",
    anchor="spirt"))

register_arch(ArchSpec(
    name="scatterreduce_q8", round_terms=_scatterreduce_terms,
    compression="int8",
    description="ScatterReduce with int8-quantized chunk exchange + "
                "error feedback (realized by QuantizedScatterReduce "
                "on real hardware)",
    jax_strategy="quantized_scatterreduce",
    anchor="scatterreduce"))

register_arch(ArchSpec(
    name="spirt_sf", round_terms=_spirt_terms,
    compression="significance",
    description="SPIRT with MLLess-style significance filtering on "
                "the gradient path (error feedback preserves "
                "convergence; update stays in-DB)",
    default_recovery="takeover",
    default_aggregator="trimmed_mean",
    jax_strategy="mlless", jax_strategy_kwargs=(("threshold", 0.7),),
    anchor="spirt"))
