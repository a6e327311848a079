"""Recovery semantics for the serverless event runtime and
byzantine-robust aggregation for real training
(``repro.serverless.recovery``).

Two recovery policies for a crashed worker, copied from the reference,
matching the designs the paper compares:

  CheckpointRestore  the λML / MLLess model: the supervisor detects the
                     dead invocation after ``detection_s``, re-invokes
                     it (cold start + state load) and the worker
                     *replays* every round since its last checkpoint
                     (checkpoints every ``checkpoint_every`` rounds).
                     All surviving workers stall at the barrier until
                     the replay catches up — the stall is the measured
                     time-to-recover.

  PeerTakeover       SPIRT (arXiv 2309.14148): per-worker state lives in
                     the database, so nothing replays.  After
                     ``detection_s`` the survivors fetch the dead
                     worker's in-DB partition (one model-sized
                     transfer) and absorb its remaining minibatches;
                     the fleet continues with W-1 workers.

Each policy's ``real_apply`` hook drives the real resilience harness
(``repro_torch.resilience.ResilientTrainer``) through the same recovery,
so the simulated and the measured claims share one definition.

Robust aggregators, SPIRT's defense against poisoned gradients, are
ordinary strategies: every worker all-gathers the fleet's gradients and
reduces them with a byzantine-robust statistic instead of the mean.  They
compose with ``faults.ByzantineGradients`` (corrupt, then aggregate) and
with SPIRT's microbatch accumulation (``microbatches=K``), and are reached
through ``repro_torch.core.get_strategy("trimmed_mean" |
"coordinate_median" | "krum" | "geometric_median")``.

Each statistic takes ``use_kernel``: True (the default) goes through
``kernels.ops``, where dispatch follows the tensor (the Hopper kernels on
CUDA, their plain versions on the CPU); False takes the plain versions in
``kernels.ref``, which perform the kernels' arithmetic.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.strategies import (Strategy, _flat32, _leaf_bytes,
                                         _unflat)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

#: Weiszfeld iterations run by ``geometric_median`` in this process
ITERATIONS = {"geometric_median": 0}


def _kernels(use_kernel: bool):
    return kops if use_kernel else kref


# ---------------------------------------------------------------------------
# Recovery policies (consumed by runtime.EventRuntime)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    detection_s: float = 1.0

    def real_apply(self, trainer, worker: int):
        """Recover a *real* training run.

        ``trainer`` is a :class:`repro_torch.resilience.ResilientTrainer`
        whose worker ``worker`` (its index in the current fleet) was just
        lost mid-step.  The same policy object the event runtime scores
        drives the real harness, so the simulated and measured recovery
        claims share one definition.  Returns the trainer's
        :class:`~repro_torch.resilience.harness.RecoveryOutcome`
        (replayed steps, wall time, bytes moved).
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no real-training recovery hook")


@dataclasses.dataclass(frozen=True)
class CheckpointRestore(RecoveryPolicy):
    """Re-invoke the crashed worker; replay since the last checkpoint."""
    checkpoint_every: int = 4          # rounds between checkpoints

    def replay_rounds(self, crashed_round: int) -> int:
        return crashed_round % self.checkpoint_every

    def real_apply(self, trainer, worker: int):
        return trainer.recover_restore(worker)


@dataclasses.dataclass(frozen=True)
class PeerTakeover(RecoveryPolicy):
    """SPIRT-style: survivors absorb the dead worker's partition."""
    detection_s: float = 0.5

    def real_apply(self, trainer, worker: int):
        return trainer.recover_takeover(worker)


@dataclasses.dataclass
class RecoveryEvent:
    worker: int
    crash_time_s: float
    rejoined_time_s: float
    mode: str                          # "restore" | "takeover"

    @property
    def time_to_recover_s(self) -> float:
        return self.rejoined_time_s - self.crash_time_s


# ---------------------------------------------------------------------------
# Robust reduction statistics
# ---------------------------------------------------------------------------
def trimmed_mean_sort(stacked, trim: int):
    """Reference implementation: full sort over the worker axis, then the
    mean of the interior slice."""
    W = stacked.shape[0]
    if W <= 2 * trim:
        raise ValueError(f"trimmed_mean needs W > 2*trim, got W={W}, "
                         f"trim={trim}")
    s = torch.sort(stacked, dim=0).values
    return torch.mean(s[trim:W - trim], dim=0)


def trimmed_mean(stacked, trim: int, use_kernel: bool = True):
    """Mean over axis 0 after dropping the ``trim`` smallest and largest
    values per coordinate; ``stacked``: [W, ...], W > 2*trim; fp32.

    ``trim=1``, the common SPIRT setting, masks one min and one max entry
    per coordinate and sums the middle values.  It is NOT
    ``(sum - min - max)/(W-2)``: a byzantine worker shipping a hugely
    scaled gradient would absorb the honest mass into the total and the
    subtraction would cancel it, the very attack this defends against."""
    W = stacked.shape[0]
    if W <= 2 * trim:
        raise ValueError(f"trimmed_mean needs W > 2*trim, got W={W}, "
                         f"trim={trim}")
    return _kernels(use_kernel).trimmed_mean(stacked, trim)


def coordinate_median(stacked, use_kernel: bool = True):
    """Per-coordinate median over axis 0 of a [W, ...] stack (even W: the
    mean of the two middle values)."""
    return _kernels(use_kernel).coordinate_median(stacked)


def krum(stacked, f: int = 1, m: int = 1, use_kernel: bool = True):
    """(Multi-)Krum (Blanchard et al., NeurIPS 2017) over axis 0 of a
    ``[W, ...]`` stack: score every row by the summed squared distance to
    its ``W - f - 2`` nearest neighbours, then average the ``m``
    lowest-scoring rows.  Needs ``W >= 2f + 3``."""
    W = stacked.shape[0]
    if f < 0:
        raise ValueError(f"krum needs f >= 0, got f={f}")
    if W < 2 * f + 3:
        raise ValueError(
            f"krum needs W >= 2f + 3 to out-vote f byzantine rows, got "
            f"W={W}, f={f} (max feasible f is {(W - 3) // 2})")
    if not 1 <= m <= W:
        raise ValueError(f"krum needs 1 <= m <= W, got m={m}")
    d = _kernels(use_kernel).krum_pairwise(stacked)
    ds = torch.sort(d, dim=-1).values              # col 0 is self (0.0)
    scores = torch.sum(ds[:, 1:W - f - 1], dim=-1)
    sel = torch.argsort(scores, stable=True)[:m]
    return torch.mean(stacked[sel].float(), dim=0)


def geometric_median(stacked, tol: float = 1e-6, max_iter: int = 100,
                     use_kernel: bool = True):
    """Geometric median over axis 0 of a ``[W, ...]`` stack by Weiszfeld
    iteration, started at the coordinate median.  A host loop: it reads
    the step's norm once an iteration and stops when the step falls to
    ``tol`` times the largest row norm, or after ``max_iter`` passes.
    Adds its iterations to ``ITERATIONS``."""
    if tol <= 0 or max_iter < 1:
        raise ValueError(f"geometric_median needs tol > 0 and "
                         f"max_iter >= 1, got tol={tol}, "
                         f"max_iter={max_iter}")
    k = _kernels(use_kernel)
    W = stacked.shape[0]
    flat = stacked.reshape(W, -1).float()
    scale = max(float(torch.linalg.vector_norm(flat, dim=-1).max()), 1e-12)
    floor = 1e-12 * scale
    z = k.coordinate_median(flat)
    step, it = math.inf, 0
    while it < max_iter and step > tol * scale:
        z_new = k.weiszfeld_step(flat, z, floor)
        step = float(torch.linalg.vector_norm(z_new - z))
        z, it = z_new, it + 1
    ITERATIONS["geometric_median"] += it
    return z.reshape(stacked.shape[1:])


# ---------------------------------------------------------------------------
# Robust aggregation strategies
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _RobustAggregate(Strategy):
    """all-gather + robust reduce.  Wire volume matches ParameterServer:
    every worker sees every gradient.

    ``sync`` packs the gradients into ONE fp32 buffer, all-gathers it
    into a (W, D) stack with one collective and reduces that with one
    statistic; ``sync_per_leaf`` does both once per leaf (the semantic
    reference for the coordinate-wise rules; Krum and the geometric median
    are joint rules, for which the flat ``sync`` is the semantics)."""
    name: str = "robust"
    use_kernel: bool = True

    def _reduce(self, stacked):
        raise NotImplementedError

    def _gather(self, flat, group):
        W = dist.get_world_size(group)
        stacked = flat.new_empty((W * flat.numel(),))
        dist.all_gather_into_tensor(stacked, flat, group=group)
        return stacked.view(W, -1)

    def sync(self, grads, state, group=None):
        if not grads:
            return grads, state, {}
        red = self._reduce(self._gather(_flat32(grads), group))
        return _unflat(red, grads), state, {}

    def sync_per_leaf(self, grads, state, group=None):
        out = []
        for g in grads:
            stacked = self._gather(g.reshape(-1).float().contiguous(), group)
            out.append(self._reduce(stacked).view(g.shape).to(g.dtype))
        return out, state, {}

    def comm_bytes(self, grads_like, n_workers):
        return int(_leaf_bytes(grads_like) * n_workers)


@dataclasses.dataclass(frozen=True)
class TrimmedMean(_RobustAggregate):
    """Tolerates up to ``trim`` byzantine workers per coordinate side."""
    name: str = "trimmed_mean"
    trim: int = 1

    def _reduce(self, stacked):
        return trimmed_mean(stacked, self.trim, use_kernel=self.use_kernel)


@dataclasses.dataclass(frozen=True)
class CoordinateMedian(_RobustAggregate):
    """Tolerates a byzantine minority (< W/2) per coordinate."""
    name: str = "coordinate_median"

    def _reduce(self, stacked):
        return coordinate_median(stacked, use_kernel=self.use_kernel)


@dataclasses.dataclass(frozen=True)
class Krum(_RobustAggregate):
    """(Multi-)Krum selection: tolerates ``f`` byzantine workers given
    ``W >= 2f + 3``; ``m`` is multi-Krum's averaging breadth.  ``f`` and
    ``m`` are validated here, the fleet size at the first sync."""
    name: str = "krum"
    f: int = 1
    m: int = 1

    def __post_init__(self):
        if self.f < 0:
            raise ValueError(f"krum needs f >= 0, got f={self.f}")
        if self.m < 1:
            raise ValueError(f"krum needs m >= 1, got m={self.m}")

    def _reduce(self, stacked):
        return krum(stacked, self.f, self.m, use_kernel=self.use_kernel)


@dataclasses.dataclass(frozen=True)
class GeometricMedian(_RobustAggregate):
    """Weiszfeld geometric median: tolerates any byzantine minority
    (< W/2) whatever the attack's geometry, at the price of an iterative
    reduce (``max_iter`` capped, ``tol``-bounded)."""
    name: str = "geometric_median"
    tol: float = 1e-6
    max_iter: int = 100

    def __post_init__(self):
        if self.tol <= 0 or self.max_iter < 1:
            raise ValueError(
                f"geometric_median needs tol > 0 and max_iter >= 1, "
                f"got tol={self.tol}, max_iter={self.max_iter}")

    def _reduce(self, stacked):
        return geometric_median(stacked, self.tol, self.max_iter,
                                use_kernel=self.use_kernel)
