"""Gradient-synchronization strategies over ``torch.distributed``
(``repro.core.strategies``): the paper's five architectures.  Beyond
them ``get_strategy`` reaches ``quantized_scatterreduce``
(``core.compression``), the robust aggregators, the byzantine wrapper and
every name of the ArchSpec registry (``serverless.archs``).

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
from repro_torch.kernels.block_significance import SegmentLayout


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


class _Residual(tuple):
    """MLLess's per-rank state: each leaf's fp32 residual, a view of one
    flat buffer in which every leaf fills whole blocks (``flat``, the
    segmented kernels' layout), with that ``layout`` cached beside it."""

    def __new__(cls, layout, flat):
        self = super().__new__(cls, layout.residual_views(flat))
        self.layout, self.flat = layout, flat
        return self

    @classmethod
    def of(cls, state, grads, block):
        """``state`` itself where it fits ``grads``; else its leaves
        packed into a new layout's buffer."""
        if isinstance(state, cls) and state.layout.block == block \
                and state.layout.matches(grads):
            return state
        layout = SegmentLayout(grads, block)
        return cls(layout, layout.pack(state, grads[0].device))


@dataclasses.dataclass(frozen=True)
class MLLess(Strategy):
    """Block-wise significance filter: only gradient blocks whose L2 norm
    (including the error-feedback residual) exceeds ``threshold`` times
    the leaf's RMS block norm are synchronized; the rest accumulate in
    the residual (error feedback keeps convergence).

    A dense all-reduce moves the same wire bytes whatever the mask, so
    ``info["significant_fraction"]`` reports the effective volume, the
    quantity MLLess bills for.  The filter runs over every leaf at once
    (``kernels.ops.segment_norms`` and ``segment_filter``, three kernel
    launches on CUDA) and writes the kept blocks straight into the flat
    buffer that is all-reduced; ``use_kernel=False`` takes the plain twins
    in ``kernels.ref``, which give the same numbers.  The state is the
    residual of each leaf (``init_state``), views of one flat buffer.
    """
    name: str = "mlless"
    threshold: float = 0.5
    block: int = 256
    use_kernel: bool = True

    def init_state(self, grads_like):
        layout = SegmentLayout(grads_like, self.block)
        return _Residual(layout, torch.zeros(
            layout.n_rows * self.block, dtype=torch.float32,
            device=grads_like[0].device))

    def sync(self, grads, state, group=None):
        k = kops if self.use_kernel else kref
        resid = _Residual.of(state, grads, self.block)
        layout = resid.layout
        _, mask, counts = k.segment_norms(grads, resid.flat, layout,
                                          self.threshold)
        kept, new_resid = k.segment_filter(grads, resid.flat, layout, mask)
        dist.all_reduce(kept, op=dist.ReduceOp.SUM, group=group)
        out = layout.leaf_views(kept / dist.get_world_size(group))
        frac = counts.sum().float() / max(layout.n_rows, 1)
        return out, _Residual(layout, new_resid), \
            {"significant_fraction": frac}

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
    if name == "quantized_scatterreduce":    # beyond-paper (lazy import)
        from repro_torch.core.compression import QuantizedScatterReduce
        return QuantizedScatterReduce(**kw)
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
    if name in STRATEGIES:
        return STRATEGIES[name](**kw)
    # simulated architecture names resolve through the ArchSpec registry
    # (sim-arch and real-training arch are one object): e.g. "gpu" is a
    # ring allreduce, "hier_spirt"/"spirt_s3" ride SPIRT accumulation.
    # Lazy: the registry's module imports this one.
    from repro_torch.serverless.archs import _REGISTRY
    spec = _REGISTRY.get(name)
    if spec is not None and spec.jax_strategy is not None:
        return spec.make_strategy(**kw)
    raise KeyError(f"unknown strategy {name!r}; the port has "
                   f"{sorted(STRATEGIES) + list(ROBUST)}, "
                   "'quantized_scatterreduce', 'byzantine' and the "
                   f"registered archs {list(_REGISTRY)}")
