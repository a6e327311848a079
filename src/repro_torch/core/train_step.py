"""Data-parallel train step (``repro.core.train_step``), pure DP and FSDP.

One process per rank.  Each rank computes autograd gradients on its own
shard of the global batch, the strategy syncs them over the process
group, and every rank applies the same optimizer update.  The strategy's
state (MLLess's residual) is per rank.

SPIRT's accumulation runs over ``Ke = gcd(K, B_local)`` microbatches and
averages their gradients; the reported loss is the last microbatch's, as
in the reference.  Loss and info metrics are averaged across ranks.

FSDP (ZeRO-3; ``mesh`` and ``fsdp=True``): each block/tail leaf whose
spec (``core.sharding.param_pspecs``) carries the data axes lives on each
rank as its 1/W shard, and so do its AdamW moments.  The model's
``param_hook`` all-gathers a layer's shards inside the layer (inside the
recomputed block, so the backward gathers again, as the reference's
remat does) and the gather's backward reduce-scatters the gradient in
``fsdp_rs_dtype``.  Those leaves arrive summed over ranks: they bypass
the strategy and are divided by W, and the strategy syncs, and keeps its
state for, the other leaves only (the reference's ``fsdp_mask``).  Under
SPIRT every microbatch gathers and reduce-scatters.  A mesh axis of
tensor parallelism larger than 1 raises ``NotImplementedError``.

The model is any module whose parameter names are the reference tree's
paths (``models.cnn``, ``models.transformer``); the batch is a dict of
tensors sharing their leading (batch) dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import losses, sharding
from repro_torch.core.strategies import Strategy
from repro_torch.models.params import (global_tree, reference_leaves,
                                       shard_model)
from repro_torch.optim.optimizers import Optimizer, apply_updates


@dataclasses.dataclass
class TrainStep:
    step_fn: Callable            # (state, batch) -> (state, metrics)
    init_state: Callable         # () -> state
    layout: Any = None           # sharding.FsdpLayout under FSDP


def _pmean(x, group):
    x = x.detach().float().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / dist.get_world_size(group)


def default_loss(model, batch):
    """The reference's default, ``softmax_cross_entropy(logits, labels) +
    aux`` of an LM (``forward`` returns (logits, aux)); for a CNN batch
    (``images``) the classification loss, which the reference's callers
    pass as ``loss_fn``."""
    if "images" in batch:
        return losses.classification_loss(model(batch["images"]),
                                          batch["labels"])
    logits, aux = model(batch)
    return losses.softmax_cross_entropy(logits, batch["labels"]) + aux


def _fsdp_plan(model, mesh, data_axes, model_axis, group, rs_dtype):
    """(layout, param_hook) of ``model`` on ``mesh``."""
    tree = global_tree(model)
    pspecs = sharding.param_pspecs(tree, mesh, fsdp=True,
                                   data_axes=data_axes,
                                   model_axis=model_axis)
    specs = sharding.tree_leaves(pspecs)
    layout = sharding.fsdp_layout(
        [t.shape for t in sharding.tree_leaves(
            tree, lambda x: isinstance(x, torch.Tensor))],
        specs, mesh, data_axes, dist.get_rank(), group)
    if layout.index != dist.get_rank(group):
        raise ValueError(f"rank {dist.get_rank()} holds shard "
                         f"{layout.index} but is rank "
                         f"{dist.get_rank(group)} of its group")
    enc = pspecs.get("encoder")
    if enc is not None and any(sharding.data_dim(s, data_axes) is not None
                               for s in sharding.tree_leaves(enc)):
        # the reference shards the encoder's leaves but never gathers
        # them (its ``_encode`` calls no hook): its step fails there with
        # a ValueError (ROADMAP §3), and the port refuses the case
        raise ValueError(
            f"{model.cfg.name}: FSDP shards the encoder's leaves, which "
            "the reference's encoder never gathers (ROADMAP §3)")
    blocks = [sharding._map_with_path(
        lambda _, sp: sharding.drop_leading(sp), t,
        is_leaf=sharding._is_spec) for t in pspecs.get("blocks", [])]
    tails = list(pspecs.get("tail", []))
    gather = sharding.make_gather_hook(data_axes, group, rs_dtype)

    def param_hook(tree, kind, idx):
        return gather(tree, blocks[idx] if kind == "block" else tails[idx])
    return layout, param_hook


def build_train_step(model, optimizer: Optimizer, strategy: Strategy,
                     mesh=None, *, group=None, data_axes=("data",),
                     model_axis=None, fsdp: bool = False, loss_fn=None,
                     fsdp_rs_dtype=torch.float32) -> TrainStep:
    """Train step for ``model`` with ``loss_fn(model, batch) -> loss``
    (``None``: ``default_loss``).  ``group`` is the data-parallel process
    group (``None``: the default one, which must be initialised).

    ``mesh`` (``launch.mesh.Mesh``) names the data axes: their product
    must be the group's size, and the rank's place on the mesh its rank in
    the group.  ``model_axis`` of size above 1 raises
    ``NotImplementedError``; of size 1 it only steers the specs, as in the
    reference.  ``fsdp=True`` shards the model's block/tail leaves (see
    the module docstring) when ``init_state`` is called.

    ``state["params"]`` are the module's own parameters, in the reference
    tree's leaf order, updated in place."""
    K = strategy.microbatches
    loss_fn = default_loss if loss_fn is None else loss_fn
    layout = hook = None
    if mesh is not None:
        sharding.require_no_tp(mesh, model_axis)
        W = sharding._axis_size(mesh, data_axes)
        if W != dist.get_world_size(group):
            raise ValueError(f"data axes {data_axes} span {W} ranks, the "
                             f"group {dist.get_world_size(group)}")
        if fsdp:
            layout, hook = _fsdp_plan(model, mesh, data_axes, model_axis,
                                      group, fsdp_rs_dtype)
    elif fsdp:
        raise ValueError("fsdp=True needs a mesh")
    mask = layout.mask if layout is not None else None

    def value_and_grad(params, batch):
        loss = loss_fn(model, batch)
        return loss.detach(), torch.autograd.grad(loss, params)

    def step_fn(state, batch):
        model.param_hook = hook
        params = state["params"]
        B_local = next(iter(batch.values())).shape[0]
        Ke = math.gcd(K, B_local) if K > 1 else 1
        if Ke > 1:
            mb = B_local // Ke
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in params]
            for i in range(Ke):
                sl = slice(i * mb, (i + 1) * mb)
                loss, g = value_and_grad(
                    params, {k: x[sl] for k, x in batch.items()})
                for a, b in zip(gsum, g):
                    a.add_(b.float())
            grads = [a / Ke for a in gsum]
        else:
            loss, grads = value_and_grad(params, batch)

        if mask is None:
            synced, state["strat"], info = strategy.sync(
                list(grads), state["strat"], group)
        else:
            part, state["strat"], info = strategy.sync(
                [g for g, m in zip(grads, mask) if not m], state["strat"],
                group)
            part = iter(part)
            # reduce-scattered leaves: the sum over ranks -> the mean
            synced = [g / layout.W if m else next(part)
                      for g, m in zip(grads, mask)]
        updates, state["opt"] = optimizer.update(synced, state["opt"],
                                                 params)
        apply_updates(params, updates)
        state["step"] += 1
        metrics = {"loss": _pmean(loss, group), "step": state["step"]}
        metrics.update({k: _pmean(v, group) for k, v in info.items()})
        return state, metrics

    def init_state():
        if layout is not None:
            shard_model(model, layout)
        params = reference_leaves(model)
        sync_like = params if mask is None else \
            [p for p, m in zip(params, mask) if not m]
        return {"params": params, "opt": optimizer.init(params),
                "strat": strategy.init_state(sync_like), "step": 0}

    return TrainStep(step_fn=step_fn, init_state=init_state, layout=layout)
