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

The batched numpy aggregators of the simulated sweep are not ported yet.
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
