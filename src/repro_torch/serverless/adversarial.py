"""The attack-model registry (``repro.serverless.adversarial``, the attack
half): one frozen :class:`AttackSpec` per way a byzantine worker corrupts
its gradient (``register_attack`` / ``get_attack`` / ``list_attacks``;
unknown names raise with the registered list).  Each spec carries both
realizations of the attack:

  ``apply_rows``   batched numpy, copied from the reference: corrupts a
                   ``[..., W, D]`` stack of per-worker gradients under a
                   boolean byzantine mask ``[..., W]``.
  ``torch_apply``  the same corruption for this rank, called by
                   ``faults.ByzantineGradients`` before the inner
                   strategy's collective.

Registered attacks (SPIRT §5 / Baruch et al. "A Little Is Enough"):

  sign_flip          g -> -g
  scale              g -> scale * g           (default -10)
  gaussian_noise     g -> g + scale * N(0, I) (seeded per rank and step)
  little_is_enough   every byzantine worker ships the same vector,
                     mean - scale * std of the fleet's gradients
  zero               g -> 0

The simulated aggregators are copied from the reference too: batched
numpy statistics over ``[..., W, D]`` stacks with a (possibly
per-batch-row) byzantine budget ``f`` — ``mean``, ``trimmed_mean``,
``coordinate_median``, ``krum`` (multi-Krum), ``geometric_median``
(Weiszfeld) — registered in :data:`SIM_AGGREGATORS`, which
``archs.ArchSpec.default_aggregator`` names and ``sweep.adversarial_sweep``
reduces with.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.strategies import _flat32, _unflat


# ---------------------------------------------------------------------------
# Attack-model registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """One byzantine gradient-corruption model.

    ``apply_rows(stacked, byz_mask, rng, scale)``: batched numpy;
    ``stacked`` is ``[..., W, D]``, ``byz_mask`` a boolean ``[..., W]``,
    ``rng`` a seeded generator (only the stochastic attacks draw from
    it), ``scale`` the magnitude.  Returns a corrupted copy; honest rows
    are bit-unchanged.

    ``torch_apply(grads, bad, group, scale, seed, step)``: this rank's
    corruption.  ``grads`` is the list of gradient tensors, ``bad`` a
    host bool (is THIS rank byzantine), ``group`` the process group whose
    collectives the colluding attack reads fleet statistics through (every
    rank calls it), and ``step`` the sync-step counter that
    ``ByzantineGradients`` keeps, so the stochastic attacks draw fresh
    noise every step.  Returns the list to sync; honest ranks get theirs
    back unchanged.
    """
    name: str
    apply_rows: Callable
    torch_apply: Callable
    description: str = ""
    colluding: bool = False            # needs fleet statistics (LIE)
    default_scale: float = 1.0

    def rows(self, stacked, byz_mask, rng, scale=None):
        """``apply_rows`` with the spec's own default magnitude."""
        return self.apply_rows(
            np.asarray(stacked, float), np.asarray(byz_mask, bool), rng,
            self.default_scale if scale is None else float(scale))


_ATTACKS: Dict[str, AttackSpec] = {}


def register_attack(spec: AttackSpec, *,
                    overwrite: bool = False) -> AttackSpec:
    """Add an attack model (returns it).  Re-registering a name is an
    error unless ``overwrite``."""
    if not overwrite and spec.name in _ATTACKS:
        raise ValueError(f"attack model {spec.name!r} is already "
                         "registered (pass overwrite=True to replace)")
    _ATTACKS[spec.name] = spec
    return spec


def unregister_attack(name: str) -> None:
    _ATTACKS.pop(name, None)


def get_attack(name: str) -> AttackSpec:
    try:
        return _ATTACKS[name]
    except KeyError:
        raise ValueError(
            f"unknown attack model {name!r}; registered: "
            f"{', '.join(_ATTACKS)}") from None


def list_attacks() -> Tuple[str, ...]:
    """All registered attack names, in registration order."""
    return tuple(_ATTACKS)


# ---- numpy realizations (batched), as in the reference ---------------------
def _rows_sign_flip(stacked, byz, rng, scale):
    return np.where(byz[..., None], -stacked, stacked)


def _rows_scale(stacked, byz, rng, scale):
    return np.where(byz[..., None], scale * stacked, stacked)


def _rows_gaussian(stacked, byz, rng, scale):
    # ONE noise field over the trailing (W, D) axes, broadcast across
    # any batch dims: cells that share a draw stay comparable
    noise = rng.standard_normal(stacked.shape[-2:])
    return np.where(byz[..., None], stacked + scale * noise, stacked)


def _rows_lie(stacked, byz, rng, scale):
    # colluding: every byzantine worker ships the SAME vector, `scale`
    # standard deviations below the per-coordinate mean of the whole
    # pre-corruption stack
    mu = stacked.mean(axis=-2, keepdims=True)
    sd = stacked.std(axis=-2, keepdims=True)
    return np.where(byz[..., None], mu - scale * sd, stacked)


def _rows_zero(stacked, byz, rng, scale):
    return np.where(byz[..., None], 0.0, stacked)


# ---- torch realizations (one rank) -----------------------------------------
_MASK64 = (1 << 64) - 1


def noise_seed(seed: int, rank: int, step: int, leaf: int) -> int:
    """Seed of the gaussian attack's generator for one leaf of one rank
    at one sync step: SplitMix64's finalizer chained over (seed, rank,
    step, leaf), so that no two ranks, steps or leaves share a stream."""
    h = 0
    for word in (seed, rank, step, leaf):
        h = (h + 0x9E3779B97F4A7C15 + (word & _MASK64)) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h


def _torch_sign_flip(grads, bad, group, scale, seed, step):
    return [-g for g in grads] if bad else grads


def _torch_scale(grads, bad, group, scale, seed, step):
    return [g * scale for g in grads] if bad else grads


def _torch_gaussian(grads, bad, group, scale, seed, step):
    if not bad:
        return grads
    rank = dist.get_rank(group)
    gen = torch.Generator(device=grads[0].device)
    out = []
    for i, g in enumerate(grads):
        gen.manual_seed(noise_seed(seed, rank, step, i))
        noise = torch.randn(g.shape, generator=gen, device=g.device,
                            dtype=torch.float32).to(g.dtype)
        out.append(g + scale * noise)
    return out


def _torch_lie(grads, bad, group, scale, seed, step):
    # fleet statistics from the PRE-corruption gradients, all leaves in
    # one buffer: sum and sum of squares, one all-reduce each
    flat = _flat32(grads)
    sq = flat * flat
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=group)
    W = dist.get_world_size(group)
    mu = flat / W
    var = sq / W - mu * mu
    evil = mu - scale * torch.sqrt(torch.clamp_min(var, 0.0))
    return _unflat(evil, grads) if bad else grads


def _torch_zero(grads, bad, group, scale, seed, step):
    return [torch.zeros_like(g) for g in grads] if bad else grads


register_attack(AttackSpec(
    name="sign_flip", apply_rows=_rows_sign_flip,
    torch_apply=_torch_sign_flip,
    description="g -> -g (gradient ascent on the honest objective)"))

register_attack(AttackSpec(
    name="scale", apply_rows=_rows_scale, torch_apply=_torch_scale,
    default_scale=-10.0,
    description="g -> scale * g (a -kx poisoned gradient)"))

register_attack(AttackSpec(
    name="gaussian_noise", apply_rows=_rows_gaussian,
    torch_apply=_torch_gaussian, default_scale=10.0,
    description="g -> g + scale * N(0, I), seeded per worker"))

register_attack(AttackSpec(
    name="little_is_enough", apply_rows=_rows_lie, torch_apply=_torch_lie,
    colluding=True, default_scale=1.5,
    description="colluding: honest_mean - scale * honest_std "
                "(Baruch et al.; hides inside the honest spread)"))

register_attack(AttackSpec(
    name="zero", apply_rows=_rows_zero, torch_apply=_torch_zero,
    description="g -> 0 (silently dropped contribution)"))


# ---------------------------------------------------------------------------
# Batched numpy robust aggregators (simulated-path twins of recovery.py)
# ---------------------------------------------------------------------------
def np_mean(stacked, f=0):
    """Plain averaging — breakdown point 0; the degradation baseline."""
    return np.asarray(stacked, float).mean(axis=-2)


def np_trimmed_mean(stacked, f=1):
    """Per-coordinate mean after dropping the ``f`` smallest and ``f``
    largest values.  ``f`` may be an int or an int array broadcasting
    over the batch dims (one budget per sweep row); needs ``W > 2f``."""
    stacked = np.asarray(stacked, float)
    W = stacked.shape[-2]
    f = np.asarray(f, int)
    if np.any(2 * f >= W):
        raise ValueError(f"trimmed_mean needs W > 2*f, got W={W}, "
                         f"f={f.max()}")
    s = np.sort(stacked, axis=-2)
    pos = np.arange(W)
    keep = (pos >= f[..., None]) & (pos < W - f[..., None])
    return np.sum(s * keep[..., None], axis=-2) \
        / (W - 2 * f)[..., None]


def np_coordinate_median(stacked, f=0):
    """Per-coordinate median — breakdown point (W-1)/2W."""
    return np.median(np.asarray(stacked, float), axis=-2)


def np_krum(stacked, f=1, m=1):
    """(Multi-)Krum (Blanchard et al.): score every row by the summed
    squared distance to its ``W - f - 2`` nearest neighbours, average
    the ``m`` lowest-scoring rows.  Needs ``W >= 2f + 3``; ``f`` may be
    batched like :func:`np_trimmed_mean`'s."""
    stacked = np.asarray(stacked, float)
    W = stacked.shape[-2]
    f = np.asarray(f, int)
    if np.any(f < 0):
        raise ValueError(f"krum needs f >= 0, got {f.min()}")
    if np.any(W < 2 * f + 3):
        raise ValueError(
            f"krum needs W >= 2f + 3 to out-vote f byzantine rows, got "
            f"W={W}, f={f.max()} (max feasible f is {(W - 3) // 2})")
    if not 1 <= int(m) <= W:
        raise ValueError(f"krum needs 1 <= m <= W, got m={m}")
    d = ((stacked[..., :, None, :] - stacked[..., None, :, :]) ** 2) \
        .sum(axis=-1)                          # [..., W, W]
    ds = np.sort(d, axis=-1)                   # col 0 is self (0.0)
    pos = np.arange(W)
    # neighbours 1 .. W-f-2 inclusive == W-f-2 nearest non-self rows;
    # [..., 1, W] so one row-axis mask broadcasts over every scored row
    nb = (pos >= 1) & (pos <= (W - 2 - f)[..., None, None])
    scores = (ds * nb).sum(axis=-1)            # [..., W]
    sel = np.argsort(scores, axis=-1, kind="stable")[..., :int(m)]
    return np.take_along_axis(stacked, sel[..., None],
                              axis=-2).mean(axis=-2)


def np_geometric_median(stacked, f=0, *, tol=1e-8, max_iter=200):
    """Geometric median over the worker axis by Weiszfeld iteration,
    batched; breakdown point (W-1)/2W.  Initialized at the coordinate
    median; stops when the relative step falls below ``tol``."""
    stacked = np.asarray(stacked, float)
    if tol <= 0 or max_iter < 1:
        raise ValueError(f"geometric_median needs tol > 0 and "
                         f"max_iter >= 1, got tol={tol}, "
                         f"max_iter={max_iter}")
    z = np.median(stacked, axis=-2)            # [..., D]
    scale = np.maximum(np.linalg.norm(stacked, axis=-1).max(axis=-1),
                       1e-12)                  # [...]
    # rows freeze individually once their own step converges, so a
    # batched call returns bit-identical results per row regardless of
    # what else shares the batch (sweep cells stay independent)
    frozen = np.zeros(z.shape[:-1], bool)
    for _ in range(max_iter):
        dist = np.linalg.norm(stacked - z[..., None, :], axis=-1)
        w = 1.0 / np.maximum(dist, 1e-12 * scale[..., None])
        z_new = np.sum(w[..., None] * stacked, axis=-2) \
            / np.sum(w, axis=-1)[..., None]
        step = np.linalg.norm(z_new - z, axis=-1)
        z = np.where(frozen[..., None], z, z_new)
        frozen |= step <= tol * scale
        if frozen.all():
            break
    return z


SIM_AGGREGATORS: Dict[str, Callable] = {
    "mean": np_mean,
    "trimmed_mean": np_trimmed_mean,
    "coordinate_median": np_coordinate_median,
    "krum": np_krum,
    "geometric_median": np_geometric_median,
}


def sim_aggregator_max_f(name: str, n_workers: int) -> int:
    """The largest byzantine budget ``f`` the aggregator can be
    configured with at fleet size ``n_workers`` — its theoretical
    breakdown point on the fraction axis.  Plain averaging breaks at
    the first adversary."""
    if name not in SIM_AGGREGATORS:
        raise ValueError(f"unknown simulated aggregator {name!r}; "
                         f"registered: {', '.join(SIM_AGGREGATORS)}")
    if name == "mean":
        return 0
    if name == "krum":
        return max((n_workers - 3) // 2, 0)
    return (n_workers - 1) // 2                # median family / trimmed


def byzantine_fractions(n_workers: int) -> Tuple[float, ...]:
    """The fraction ladder 0 -> (W-1)/2W in integer-worker steps: every
    k/W with 0 <= k <= (W-1)//2 — the whole sub-majority range."""
    if n_workers < 3:
        raise ValueError(f"need n_workers >= 3, got {n_workers}")
    return tuple(k / n_workers for k in range((n_workers - 1) // 2 + 1))
