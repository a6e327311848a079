"""Byzantine injection for real training (``repro.serverless.faults``,
``ByzantineGradients``): a strategy wrapper under which designated ranks
ship gradients corrupted by any attack of the
``repro_torch.serverless.adversarial`` registry.  The crash, straggler
and cold-start fault plans of the event runtime are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.core.strategies import Strategy
from repro_torch.serverless.adversarial import get_attack


@dataclasses.dataclass(frozen=True)
class ByzantineGradients(Strategy):
    """Wrap any Strategy; the ranks in ``workers`` ship corrupted
    gradients.

    The corruption runs before the inner strategy's collective, so a
    robust aggregator downstream sees exactly what a poisoned worker
    would have pushed.  ``attack`` names a registered
    :class:`~repro_torch.serverless.adversarial.AttackSpec`; ``scale`` is
    its magnitude (``None``: the attack's default) and ``seed`` feeds the
    stochastic attacks' per-rank noise streams.

    Every argument is validated here, at construction: a bad worker set,
    an unknown attack, a non-finite magnitude, or a byzantine majority
    (``len(workers) > (n_workers-1)/2`` when the fleet size is declared).
    The strategy state is ``(sync-step counter, inner state)``.
    """
    name: str = "byzantine"
    inner: Optional[Strategy] = None
    workers: Tuple[int, ...] = (0,)
    attack: str = "scale"
    scale: Optional[float] = None      # None => the attack's default
    seed: int = 0                      # stochastic attacks' noise stream
    n_workers: Optional[int] = None    # declared fleet size (validation)

    def __post_init__(self):
        if self.inner is None:
            raise ValueError("ByzantineGradients needs an inner strategy")
        # the wrapper rides the inner strategy's accumulation schedule
        # (SPIRT etc.); a conflicting explicit value would silently
        # change training semantics, so reject it
        if self.microbatches not in (1, self.inner.microbatches):
            raise ValueError(
                f"microbatches={self.microbatches} conflicts with "
                f"inner.microbatches={self.inner.microbatches}; set it on "
                "the inner strategy instead")
        object.__setattr__(self, "microbatches", self.inner.microbatches)
        workers = tuple(self.workers)
        if not workers:
            raise ValueError(
                "ByzantineGradients needs a non-empty workers tuple "
                "(an attack with no attackers is a plain wrapper bug)")
        if len(set(workers)) != len(workers) \
                or any(not isinstance(w, (int, np.integer)) or w < 0
                       for w in workers):
            raise ValueError(
                f"workers must be distinct non-negative ints, got "
                f"{workers!r}")
        object.__setattr__(self, "workers", workers)
        if self.n_workers is not None:
            if self.n_workers < 1:
                raise ValueError(
                    f"n_workers must be >= 1, got {self.n_workers}")
            if any(w >= self.n_workers for w in workers):
                raise ValueError(
                    f"workers {workers!r} out of range for a fleet of "
                    f"{self.n_workers}")
            # a corrupted majority out-votes every robust statistic
            max_byz = (self.n_workers - 1) // 2
            if len(workers) > max_byz:
                raise ValueError(
                    f"{len(workers)} byzantine workers of {self.n_workers}"
                    f" is a corrupted majority; at most {max_byz} "
                    f"(fraction <= (W-1)/2W) are aggregatable")
        spec = get_attack(self.attack)   # unknown names raise here
        scale = spec.default_scale if self.scale is None else self.scale
        if not math.isfinite(scale):
            raise ValueError(f"attack scale must be finite, got {scale}")
        object.__setattr__(self, "scale", float(scale))

    def init_state(self, grads_like):
        return (0, self.inner.init_state(grads_like))

    def sync(self, grads, state, group=None):
        step, inner_state = state
        bad = dist.get_rank(group) in self.workers
        corrupted = get_attack(self.attack).torch_apply(
            grads, bad, group, self.scale, self.seed, step)
        out, inner_state, info = self.inner.sync(corrupted, inner_state,
                                                 group)
        return out, (step + 1, inner_state), info

    def comm_bytes(self, grads_like, n_workers):
        return self.inner.comm_bytes(grads_like, n_workers)
