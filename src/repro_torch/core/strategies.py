"""Gradient-synchronization strategies over ``torch.distributed``
(``repro.core.strategies``): the paper's five architectures.

  allreduce        ring all-reduce (fp32 sum, then / W)   [GPU baseline]
  parameter_server all-gather to all + local fp32 mean     [λML AllReduce]
  scatterreduce    reduce-scatter + all-gather, then / W   [λML ScatterReduce]
  spirt            K-step on-device accumulation + all-reduce
  mlless           block-significance filter with error feedback
                   + all-reduce (the MLLess kernels)

``sync(grads, state, group)`` takes this rank's gradients as a list of
tensors (the reference tree's leaf order) and returns the synced list,
the new per-rank state and an info dict.  ``group`` is a process group
(``None``: the default one).  The dense collectives run once on all
leaves packed into one fp32 buffer: elementwise the same sums as one
collective per leaf, in fewer launches.

``comm_bytes`` is carried over verbatim: the serverless simulator and
the cost model bill with it.

Several ranks on one card run over gloo (NCCL refuses two ranks on the
same GPU).  Gloo takes CUDA tensors for every collective used here
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``;
checked on an H100 with torch 2.11), so none is staged through host
memory by hand.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def _leaf_bytes(tree) -> int:
    """Bytes of a list of tensors or numpy arrays."""
    return sum(int(np.prod(tuple(l.shape))) * (
        l.element_size() if isinstance(l, torch.Tensor)
        else np.dtype(l.dtype).itemsize) for l in tree)


def _flat32(grads):
    return torch.cat([g.reshape(-1).float() for g in grads])


def _unflat(flat, like):
    out, i = [], 0
    for g in like:
        n = g.numel()
        out.append(flat[i:i + n].view(g.shape).to(g.dtype))
        i += n
    return out


def _pmean32(grads, group):
    flat = _flat32(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return _unflat(flat / dist.get_world_size(group), grads)


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Base: subclasses override ``sync`` (and optionally state hooks)."""
    name: str = "base"
    microbatches: int = 1          # >1 => train_step accumulates (SPIRT)

    def init_state(self, grads_like) -> Any:
        return ()

    def sync(self, grads, state, group=None) -> Tuple[Any, Any, Dict]:
        raise NotImplementedError

    def comm_bytes(self, grads_like, n_workers: int) -> int:
        """Logical bytes moved per sync per worker (serverless channel)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AllReduce(Strategy):
    name: str = "allreduce"

    def sync(self, grads, state, group=None):
        return _pmean32(grads, group), state, {}

    def comm_bytes(self, grads_like, n_workers):
        # ring: 2 * G * (W-1)/W  per worker
        G = _leaf_bytes(grads_like)
        return int(2 * G * (n_workers - 1) / n_workers)


@dataclasses.dataclass(frozen=True)
class ParameterServer(Strategy):
    """Master-worker aggregation: every worker receives every other
    worker's full gradient (all-gather) and reduces locally; the W-fold
    bytes are the master bottleneck the paper measures."""
    name: str = "parameter_server"

    def sync(self, grads, state, group=None):
        flat = torch.cat([g.reshape(-1) for g in grads])
        W = dist.get_world_size(group)
        stacked = flat.new_empty((W * flat.numel(),))
        dist.all_gather_into_tensor(stacked, flat, group=group)
        mean = torch.mean(stacked.view(W, -1).float(), dim=0)
        return _unflat(mean, grads), state, {}

    def comm_bytes(self, grads_like, n_workers):
        # every worker uploads G and downloads (W-1) gradients
        G = _leaf_bytes(grads_like)
        return int(G * n_workers)


@dataclasses.dataclass(frozen=True)
class ScatterReduce(Strategy):
    name: str = "scatterreduce"

    def sync(self, grads, state, group=None):
        W = dist.get_world_size(group)
        flat = _flat32(grads)
        n = flat.numel()
        flat = F.pad(flat, (0, (-n) % W))
        chunk = flat.new_empty((flat.numel() // W,))
        dist.reduce_scatter_tensor(chunk, flat, op=dist.ReduceOp.SUM,
                                   group=group)
        full = torch.empty_like(flat)
        dist.all_gather_into_tensor(full, chunk, group=group)
        return _unflat(full[:n] / W, grads), state, {}

    def comm_bytes(self, grads_like, n_workers):
        # each worker sends (W-1)/W chunks twice (reduce phase + gather)
        G = _leaf_bytes(grads_like)
        return int(2 * G * (n_workers - 1) / n_workers)


@dataclasses.dataclass(frozen=True)
class Spirt(Strategy):
    """K-microbatch accumulation handled by the train step (the
    accumulator stays in device memory next to compute, the in-database
    analogue); the cross-worker sync is one all-reduce per K
    microbatches."""
    name: str = "spirt"
    microbatches: int = 4

    def sync(self, grads, state, group=None):
        return _pmean32(grads, group), state, {}

    def comm_bytes(self, grads_like, n_workers):
        # same ring volume, amortized over K local minibatches
        G = _leaf_bytes(grads_like)
        return int(2 * G * (n_workers - 1) / n_workers / self.microbatches)


@dataclasses.dataclass(frozen=True)
class MLLess(Strategy):
    """Block-wise significance filter: only gradient blocks whose L2 norm
    (including the error-feedback residual) exceeds ``threshold`` times
    the leaf's RMS block norm are synchronized; the rest accumulate in
    the residual (error feedback keeps convergence).

    A dense all-reduce moves the same wire bytes whatever the mask, so
    ``info["significant_fraction"]`` reports the effective volume, the
    quantity MLLess bills for.  Each leaf's filter runs through
    ``kernels.ops.significance_filter`` (the two Hopper kernels on CUDA);
    ``use_kernel=False`` takes the plain twins in ``kernels.ref``, which
    give the same numbers.
    """
    name: str = "mlless"
    threshold: float = 0.5
    block: int = 256
    use_kernel: bool = True

    def init_state(self, grads_like):
        return [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for g in grads_like]

    def sync(self, grads, state, group=None):
        sig_filter = (kops.significance_filter if self.use_kernel
                      else kref.significance_filter)
        filtered, new_resid, sig_counts = [], [], []
        tot_count = 0
        for g, r in zip(grads, state):
            acc = g.float() + r
            n, pad = acc.numel(), (-acc.numel()) % self.block
            flat = F.pad(acc.reshape(-1), (0, pad)) if pad \
                else acc.reshape(-1)
            blocks = flat.view(-1, self.block)
            kept, resid, mask = sig_filter(blocks, self.threshold)
            filtered.append(kept.view(-1)[:n].view(g.shape))
            new_resid.append(resid.view(-1)[:n].view(g.shape))
            sig_counts.append(mask.sum())
            tot_count += mask.shape[0]
        out = _pmean32(filtered, group)
        frac = torch.stack(sig_counts).sum().float() / max(tot_count, 1)
        return out, new_resid, {"significant_fraction": frac}

    def comm_bytes(self, grads_like, n_workers, significant_fraction=0.3):
        G = _leaf_bytes(grads_like)
        return int(2 * G * (n_workers - 1) / n_workers
                   * significant_fraction)


STRATEGIES = {
    "allreduce": AllReduce,
    "parameter_server": ParameterServer,
    "scatterreduce": ScatterReduce,
    "spirt": Spirt,
    "mlless": MLLess,
}


ROBUST = ("trimmed_mean", "coordinate_median", "krum", "geometric_median")


def get_strategy(name: str, **kw) -> Strategy:
    if name in ROBUST:
        # byzantine-robust aggregation (lazy: serverless imports core)
        from repro_torch.serverless import recovery
        return {"trimmed_mean": recovery.TrimmedMean,
                "coordinate_median": recovery.CoordinateMedian,
                "krum": recovery.Krum,
                "geometric_median": recovery.GeometricMedian}[name](**kw)
    if name == "byzantine":
        # fault-injection wrapper: get_strategy("byzantine",
        #   inner=get_strategy("trimmed_mean"), workers=(0,))
        from repro_torch.serverless.faults import ByzantineGradients
        return ByzantineGradients(**kw)
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; the port has "
                       f"{sorted(STRATEGIES) + list(ROBUST) + ['byzantine']}")
    return STRATEGIES[name](**kw)
