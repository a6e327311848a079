"""Empirical fault traces: measured cold-start / straggler tails.

The synthetic :meth:`FaultPlan.random` draws Poisson-thinned events with
uniform magnitudes, but the serverless-training literature the paper
builds on measures *heavy* tails: Towards Demystifying Serverless
Machine Learning Training (arXiv 2105.07806) reports cold-start
latencies whose p95 is an order of magnitude above the median once the
deployment package carries an ML runtime, and straggler slowdowns with
a long right tail from noisy-neighbour vCPU throttling.  This module is
the trace-driven replay subsystem: a :class:`Trace`
holds empirical samples of those distributions, and
:meth:`repro_torch.serverless.faults.FaultPlan.from_trace` resamples them
into replayable per-worker fault plans via inverse CDF over seeded
sub-streams, so every (trace, seed) pair is bit-reproducible.

The same machinery backs the *serving* side: :class:`RequestTrace`
holds measured request-level traffic (inter-arrival gaps, prompt and
decode token counts — the bundled default digitizes the Splitwise /
Azure LLM-inference distributions, arXiv 2311.18677) and
the reference's ``repro.serving.workload.Workload`` resamples it into
seeded open-loop request streams for its continuous-batching fleet
simulator.

Trace schema
------------
JSON — one object with the three sample arrays plus the per-epoch
straggler occurrence probability::

    {
      "name": "lambda-2105.07806",
      "straggler_prob": 0.12,
      "cold_start_s": [1.7, 1.9, ...],        # absolute seconds
      "straggler_slowdown": [1.3, 1.5, ...],  # multiplicative, >= 1
      "straggler_duration_s": [4.0, 6.0, ...] # window length, seconds
    }

CSV — long format with header ``field,value``; one row per sample, the
``field`` column naming one of the three arrays above, plus a single
``straggler_prob`` row::

    field,value
    cold_start_s,1.7
    cold_start_s,1.9
    straggler_slowdown,1.3
    straggler_duration_s,4.0
    straggler_prob,0.12

Semantics: ``cold_start_s`` samples are *absolute* measured cold-start
latencies (a worker's extra over the simulator's plan-level base is
``max(0, sample - base)``, resolved by ``FaultPlan.from_trace`` so the
base is never double counted); ``straggler_slowdown`` multiplies
compute time inside a window whose length is drawn from
``straggler_duration_s``; ``straggler_prob`` is the probability that a
given worker straggles at all during one epoch.

Bundled default
---------------
:func:`lambda_default` ships a Lambda-like trace digitized from the
measurements reported in arXiv 2105.07806 (cold-start §5.2 /
communication-straggler discussion): ~2 s warm-package median cold
start with a heavy right tail to ~30 s (large ML deployment packages +
concurrent-invocation bursts), straggler slowdowns 1.3-7.5x with
minutes-long windows, ~12% of workers straggling per epoch.  The
digitization is a quantile-grid approximation of the published curves,
not a copy of raw data — it exists so the Pareto benchmarks can compare
measured-tail behaviour against the synthetic Poisson defaults without
network access.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
from typing import Optional, Sequence, Tuple

import numpy as np

_FIELDS = ("cold_start_s", "straggler_slowdown", "straggler_duration_s")


# ---------------------------------------------------------------------------
# Shared empirical-distribution machinery (fault + request traces)
# ---------------------------------------------------------------------------
def _sorted_samples(owner: str, field: str, values) -> Tuple[float, ...]:
    """Validate and sort one sample array (finite, >= 0)."""
    vals = tuple(sorted(float(v) for v in values))
    if any(not math.isfinite(v) or v < 0 for v in vals):
        raise ValueError(f"{owner}.{field}: samples must be finite and "
                         f">= 0, got {vals}")
    return vals


def _inverse_cdf(samples: Tuple[float, ...], u, *, trace_name: str,
                 field: str):
    """Inverse empirical CDF: map uniforms ``u`` in [0, 1) to observed
    samples (pure bootstrap — no interpolation, so every resampled value
    is a member of the trace's support).  u is clipped at BOTH ends: a
    negative u must not wrap to the top of the distribution through
    negative indexing."""
    s = np.asarray(samples, float)             # sorted tuple
    if s.size == 0:
        raise ValueError(f"trace {trace_name!r}: no {field} samples")
    idx = np.clip((np.asarray(u) * s.size).astype(int), 0, s.size - 1)
    return s[idx]


def _long_csv_fields(path: str, field_names: Tuple[str, ...],
                     scalars: Tuple[str, ...] = ()) -> Tuple[dict, dict]:
    """Parse a long-format ``field,value`` CSV into sample lists (one
    per entry of ``field_names``) plus scalar rows (``scalars``)."""
    fields = {f: [] for f in field_names}
    scalar_vals: dict = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            key, val = row["field"], float(row["value"])
            if key in scalars:
                scalar_vals[key] = val
            elif key in fields:
                fields[key].append(val)
            else:
                raise ValueError(f"unknown trace field {key!r}")
    return fields, scalar_vals


@dataclasses.dataclass(frozen=True)
class Trace:
    """Empirical distributions for trace-driven fault replay.

    Samples are stored sorted (the inverse CDF is then a single index),
    as plain float tuples so a ``Trace`` hashes, compares, and pickles
    across the sweep engine's spawned worker processes.
    """
    cold_start_s: Tuple[float, ...]
    straggler_slowdown: Tuple[float, ...] = ()
    straggler_duration_s: Tuple[float, ...] = ()
    straggler_prob: float = 0.0
    name: str = "custom"

    def __post_init__(self):
        for field in _FIELDS:
            object.__setattr__(self, field, _sorted_samples(
                "Trace", field, getattr(self, field)))
        if not self.cold_start_s:
            raise ValueError("cold_start_s needs at least one sample")
        if not 0.0 <= self.straggler_prob <= 1.0:
            raise ValueError(f"straggler_prob must be a probability, "
                             f"got {self.straggler_prob}")
        if self.straggler_prob > 0:
            if not (self.straggler_slowdown and self.straggler_duration_s):
                raise ValueError("straggler_prob > 0 needs slowdown and "
                                 "duration samples")
            if self.straggler_slowdown[0] < 1.0:
                raise ValueError("straggler slowdowns are multiplicative "
                                 "and must be >= 1")

    # ---------------------------------------------------------- sampling
    def sample(self, field: str, u):
        """Inverse empirical CDF over ``field`` (see
        :func:`_inverse_cdf`: bootstrap resampling, both ends of u
        clipped)."""
        if field not in _FIELDS:
            raise KeyError(field)
        return _inverse_cdf(getattr(self, field), u,
                            trace_name=self.name, field=field)

    def support(self, field: str) -> Tuple[float, float]:
        vals = getattr(self, field)
        return (vals[0], vals[-1])

    def quantile(self, field: str, q: float) -> float:
        return float(self.sample(field, q))

    # ---------------------------------------------------------- file I/O
    def to_json(self, path: str) -> None:
        payload = dict(name=self.name, straggler_prob=self.straggler_prob,
                       **{f: list(getattr(self, f)) for f in _FIELDS})
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "Trace":
        with open(path) as f:
            payload = json.load(f)
        unknown = set(payload) - set(_FIELDS) - {"name", "straggler_prob"}
        if unknown:
            raise ValueError(f"unknown trace fields: {sorted(unknown)}")
        return cls(**payload)

    @classmethod
    def from_csv(cls, path: str, *, name: Optional[str] = None) -> "Trace":
        """Long-format ``field,value`` CSV (see module docstring)."""
        fields, scalars = _long_csv_fields(path, _FIELDS,
                                           scalars=("straggler_prob",))
        return cls(name=name or path,
                   straggler_prob=scalars.get("straggler_prob", 0.0),
                   **{k: tuple(v) for k, v in fields.items()})


# ---------------------------------------------------------------------------
# Bundled Lambda-like default (see module docstring for provenance)
# ---------------------------------------------------------------------------
_LAMBDA_COLD_START_S = (
    1.7, 1.9, 2.0, 2.1, 2.2, 2.3, 2.4, 2.5, 2.6, 2.8,
    3.0, 3.3, 3.7, 4.2, 5.0, 6.3, 8.5, 12.0, 19.0, 31.0)
_LAMBDA_STRAGGLER_SLOWDOWN = (
    1.3, 1.5, 1.7, 1.9, 2.2, 2.6, 3.2, 4.1, 5.5, 7.5)
_LAMBDA_STRAGGLER_DURATION_S = (
    4.0, 6.0, 8.0, 11.0, 15.0, 21.0, 30.0, 45.0, 70.0, 110.0)

LAMBDA_2105_07806 = Trace(
    name="lambda-2105.07806",
    cold_start_s=_LAMBDA_COLD_START_S,
    straggler_slowdown=_LAMBDA_STRAGGLER_SLOWDOWN,
    straggler_duration_s=_LAMBDA_STRAGGLER_DURATION_S,
    straggler_prob=0.12)


def lambda_default() -> Trace:
    """The bundled Lambda-like trace digitized from arXiv 2105.07806."""
    return LAMBDA_2105_07806


# ---------------------------------------------------------------------------
# Request traces: the serving twin of the fault trace
# ---------------------------------------------------------------------------
_REQUEST_FIELDS = ("inter_arrival_s", "prompt_tokens", "decode_tokens")


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """Empirical request-level distributions for serving workloads.

    The inference-side twin of :class:`Trace`: where the fault trace
    holds measured cold-start/straggler tails, a request trace holds
    measured *traffic* — request inter-arrival gaps plus prompt and
    decode token counts — and ``repro.serving.workload.Workload``
    resamples it into seeded, replayable open-loop request streams by
    the same inverse-CDF-over-sub-streams discipline.

    Schema mirrors :class:`Trace`: JSON is one object with the three
    sample arrays plus ``name``; CSV is long-format ``field,value``
    rows.  ``inter_arrival_s`` samples are absolute gaps in seconds
    (their mean is the trace's native arrival rate — ``Workload`` can
    rescale them to sweep rates without touching the burstiness shape);
    token counts are positive integers.
    """
    inter_arrival_s: Tuple[float, ...]
    prompt_tokens: Tuple[float, ...] = ()
    decode_tokens: Tuple[float, ...] = ()
    name: str = "custom"

    def __post_init__(self):
        for field in _REQUEST_FIELDS:
            object.__setattr__(self, field, _sorted_samples(
                "RequestTrace", field, getattr(self, field)))
        if not self.inter_arrival_s:
            raise ValueError("inter_arrival_s needs at least one sample")
        for field in ("prompt_tokens", "decode_tokens"):
            vals = getattr(self, field)
            if any(v < 1 or v != int(v) for v in vals):
                raise ValueError(f"{field}: token counts must be "
                                 f"positive integers, got {vals}")

    # ---------------------------------------------------------- sampling
    def sample(self, field: str, u):
        """Inverse empirical CDF over ``field`` (bootstrap resampling;
        see :func:`_inverse_cdf`)."""
        if field not in _REQUEST_FIELDS:
            raise KeyError(field)
        return _inverse_cdf(getattr(self, field), u,
                            trace_name=self.name, field=field)

    def support(self, field: str) -> Tuple[float, float]:
        vals = getattr(self, field)
        return (vals[0], vals[-1])

    def quantile(self, field: str, q: float) -> float:
        return float(self.sample(field, q))

    def mean_rate_rps(self) -> float:
        """The trace's native arrival rate (1 / mean inter-arrival)."""
        return 1.0 / float(np.mean(self.inter_arrival_s))

    # ---------------------------------------------------------- file I/O
    def to_json(self, path: str) -> None:
        payload = dict(name=self.name,
                       **{f: list(getattr(self, f))
                          for f in _REQUEST_FIELDS})
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "RequestTrace":
        with open(path) as f:
            payload = json.load(f)
        unknown = set(payload) - set(_REQUEST_FIELDS) - {"name"}
        if unknown:
            raise ValueError(f"unknown trace fields: {sorted(unknown)}")
        return cls(**payload)

    @classmethod
    def from_csv(cls, path: str, *,
                 name: Optional[str] = None) -> "RequestTrace":
        """Long-format ``field,value`` CSV (same shape as
        :meth:`Trace.from_csv`)."""
        fields, _ = _long_csv_fields(path, _REQUEST_FIELDS)
        return cls(name=name or path,
                   **{k: tuple(v) for k, v in fields.items()})


# ---------------------------------------------------------------------------
# Bundled default request trace.  Quantile-grid approximation of the
# production LLM-inference traffic shape reported by Splitwise (arXiv
# 2311.18677, Azure conversation workload): prompts with a ~1k-token
# median and a long right tail, decode lengths with a ~100-token median
# and a heavy tail to ~1k, and bursty arrivals (inter-arrival p95 an
# order of magnitude above the median — NOT exponential).  Digitized
# from the published distribution curves, not copied from raw data; it
# exists so the serving benchmarks can compare measured-burstiness
# behaviour against Poisson arrivals without network access.  The
# native rate is ~1 req/s; ``Workload.with_rate`` rescales gaps to any
# target rate while preserving the burstiness shape.
# ---------------------------------------------------------------------------
_LLM_INTER_ARRIVAL_S = (
    0.02, 0.05, 0.09, 0.14, 0.20, 0.27, 0.35, 0.44, 0.55, 0.68,
    0.83, 1.00, 1.20, 1.45, 1.80, 2.30, 3.10, 4.50, 7.00, 12.0)
_LLM_PROMPT_TOKENS = (
    64, 128, 256, 384, 512, 640, 768, 896, 1024, 1152,
    1280, 1472, 1664, 1920, 2304, 2816, 3584, 4608, 6144, 8192)
_LLM_DECODE_TOKENS = (
    8, 16, 24, 36, 48, 64, 80, 96, 112, 128,
    148, 172, 200, 240, 296, 376, 496, 672, 896, 1024)

AZURE_LLM_2311_18677 = RequestTrace(
    name="azure-llm-2311.18677",
    inter_arrival_s=_LLM_INTER_ARRIVAL_S,
    prompt_tokens=_LLM_PROMPT_TOKENS,
    decode_tokens=_LLM_DECODE_TOKENS)


def request_default() -> RequestTrace:
    """The bundled LLM-serving request trace digitized from the
    Splitwise (arXiv 2311.18677) conversation-workload distributions."""
    return AZURE_LLM_2311_18677
