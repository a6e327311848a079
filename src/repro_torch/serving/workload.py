"""Seeded open-loop request workloads for the serving fleet simulator.

A :class:`Workload` describes *traffic*: an open-loop arrival process
(requests arrive on their own clock — a slow fleet does not slow the
arrivals, it grows the queue) plus per-request prompt/decode token
counts.  Two sources, mirroring the fault side's Poisson-vs-trace
split (``repro_torch.serverless.faults.FaultPlan.random`` vs
``FaultPlan.from_trace``):

  * **Poisson** — exponential inter-arrival gaps at ``rate_rps`` with
    fixed token counts; the memoryless baseline every queueing formula
    assumes.
  * **Trace-driven** — gaps and token counts resampled from a
    :class:`repro_torch.serverless.traces.RequestTrace` by inverse CDF (the
    bundled default digitizes the Splitwise / Azure LLM-inference
    distributions, arXiv 2311.18677), optionally rescaled to a target
    rate with the burstiness shape preserved.

Seeding discipline is the fault stack's: every random field draws from
its own disjoint ``SeedSequence`` sub-stream with a FIXED number of
uniforms per request, so a :class:`RequestPlan` is a pure function of
``(workload, seed)``, request ``i``'s draws never shift request
``j``'s, and growing ``n_requests`` extends a plan without disturbing
its prefix (tested on the reference in ``tests/test_workload.py``;
``tests/test_torch_serving_sim.py`` holds the port equal to it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.serverless.traces import RequestTrace

# per-field sub-stream keys; appending is fine, reordering breaks replay
(_STREAM_ARRIVAL, _STREAM_PROMPT, _STREAM_DECODE) = range(3)


def _stream_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(stream,)))


@dataclasses.dataclass(frozen=True)
class RequestPlan:
    """A fully-resolved request stream: one row per request, sorted by
    arrival.  Immutable plain tuples so plans hash/compare/pickle like
    :class:`~repro_torch.serverless.faults.FaultPlan`."""
    arrival_s: Tuple[float, ...]
    prompt_tokens: Tuple[int, ...]
    decode_tokens: Tuple[int, ...]
    seed: int = 0

    def __post_init__(self):
        n = len(self.arrival_s)
        if not (len(self.prompt_tokens) == len(self.decode_tokens) == n):
            raise ValueError(
                f"ragged plan: {n} arrivals vs "
                f"{len(self.prompt_tokens)} prompts / "
                f"{len(self.decode_tokens)} decode counts")
        if any(b < a for a, b in zip(self.arrival_s,
                                     self.arrival_s[1:])):
            raise ValueError("arrival_s must be sorted")

    def __len__(self) -> int:
        return len(self.arrival_s)

    @property
    def total_tokens(self) -> int:
        """Tokens the stream asks the fleet to produce."""
        return int(sum(self.decode_tokens))

    @property
    def span_s(self) -> float:
        return self.arrival_s[-1] if self.arrival_s else 0.0


@dataclasses.dataclass(frozen=True)
class Workload:
    """Open-loop arrival process + token-count model.

    With a ``trace``, gaps (and token counts, where the trace has
    samples) come from its empirical distributions; without one, gaps
    are exponential at ``rate_rps`` and token counts are the fixed
    ``prompt_tokens`` / ``decode_tokens``.  ``rate_rps`` on a traced
    workload *rescales* the measured gaps to the target mean rate —
    burstiness (the gap distribution's shape) is preserved, only the
    clock speed changes.
    """
    n_requests: int = 256
    rate_rps: Optional[float] = None     # None + trace => native rate
    trace: Optional[RequestTrace] = None
    prompt_tokens: int = 512             # fixed counts (trace-less case)
    decode_tokens: int = 128

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got "
                             f"{self.n_requests}")
        if self.rate_rps is None and self.trace is None:
            raise ValueError("a Workload needs an arrival process: set "
                             "rate_rps (Poisson) and/or trace "
                             "(empirical)")
        if self.rate_rps is not None and not (
                math.isfinite(self.rate_rps) and self.rate_rps > 0):
            raise ValueError(f"rate_rps must be finite and > 0, got "
                             f"{self.rate_rps}")
        for f in ("prompt_tokens", "decode_tokens"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got "
                                 f"{getattr(self, f)}")

    # ------------------------------------------------------------ helpers
    def with_rate(self, rate_rps: float) -> "Workload":
        """This workload rescaled to a target mean arrival rate (the
        sweep grids' arrival-rate axis)."""
        return dataclasses.replace(self, rate_rps=rate_rps)

    def mean_rate_rps(self) -> float:
        if self.rate_rps is not None:
            return self.rate_rps
        return self.trace.mean_rate_rps()

    def mean_service_tokens(self) -> Tuple[float, float]:
        """(mean prompt, mean decode) token counts — the analytic
        steady-state path's workload moments."""
        if self.trace is not None and self.trace.prompt_tokens:
            p = float(np.mean(self.trace.prompt_tokens))
        else:
            p = float(self.prompt_tokens)
        if self.trace is not None and self.trace.decode_tokens:
            d = float(np.mean(self.trace.decode_tokens))
        else:
            d = float(self.decode_tokens)
        return p, d

    # ---------------------------------------------------------- generate
    def generate(self, seed: int = 0) -> RequestPlan:
        """Resolve the workload into a :class:`RequestPlan` — a pure
        function of ``(self, seed)``."""
        n = self.n_requests
        u_gap = _stream_rng(seed, _STREAM_ARRIVAL).random(n)
        if self.trace is not None:
            gaps = self.trace.sample("inter_arrival_s", u_gap)
            if self.rate_rps is not None:
                # rescale measured gaps to the target mean rate; the
                # scale uses the trace's POPULATION mean, not this
                # draw's, so two same-rate plans differ only by seed
                native = float(np.mean(self.trace.inter_arrival_s))
                gaps = gaps * (1.0 / (self.rate_rps * native))
        else:
            # inverse-CDF exponential: -ln(1-u)/rate (u in [0,1))
            gaps = -np.log1p(-u_gap) / self.rate_rps
        arrivals = np.cumsum(gaps)

        u_prompt = _stream_rng(seed, _STREAM_PROMPT).random(n)
        u_decode = _stream_rng(seed, _STREAM_DECODE).random(n)
        if self.trace is not None and self.trace.prompt_tokens:
            prompts = self.trace.sample("prompt_tokens", u_prompt)
        else:
            prompts = np.full(n, self.prompt_tokens, float)
        if self.trace is not None and self.trace.decode_tokens:
            decodes = self.trace.sample("decode_tokens", u_decode)
        else:
            decodes = np.full(n, self.decode_tokens, float)
        return RequestPlan(
            arrival_s=tuple(float(a) for a in arrivals),
            prompt_tokens=tuple(int(p) for p in prompts),
            decode_tokens=tuple(int(d) for d in decodes),
            seed=seed)
