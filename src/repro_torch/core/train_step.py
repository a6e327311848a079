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
SPIRT every microbatch gathers and reduce-scatters.

Tensor parallelism (a ``model_axis`` of M > 1 ranks; every LM family,
``models.tp``): each rank holds its slice of every leaf that
``param_pspecs`` puts on the model axis, and so do its AdamW moments (the
reference's ``opt_specs_like``); the step makes its data group (the ranks
of its model coordinate) and its model group from the mesh.  The loss is
vocab-parallel and the same on every rank of a model group; strategies
sync over the data group.  The elementwise means (``Strategy.
elementwise``) run on the slices as they are; any other strategy (MLLess
blocks each flattened leaf, the int8 sync scales chunks of it) sees whole
leaves, as the reference's does inside its ``shard_map`` whose model axis
stays auto: the slices are gathered over the model group (one call a
dtype), synced at the data width, and each rank keeps its slice, so
their state stays whole.  Under FSDP and TP together a leaf carries both
(the model axis on its widest dim, the data axes on the next): the FSDP
gather runs first, inside the layer, then the TP functions.

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
from repro_torch.launch.mesh import rank_groups
from repro_torch.models.params import (global_tree, reference_leaves,
                                       shard_model)
from repro_torch.models.tp import TensorParallel
from repro_torch.optim.optimizers import Optimizer, apply_updates


@dataclasses.dataclass
class TrainStep:
    step_fn: Callable            # (state, batch) -> (state, metrics)
    init_state: Callable         # () -> state
    layout: Any = None           # sharding.ShardLayout under FSDP or TP


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
    tp = model.tp if getattr(model, "logits_sharded", False) else None
    return losses.softmax_cross_entropy(logits, batch["labels"], tp=tp) \
        + aux


def _plan(model, mesh, data_axes, model_axis, fsdp, group, mgroup,
          rs_dtype):
    """(layout, param_hook) of ``model`` on ``mesh``: the FSDP gather hook
    under ``fsdp`` (else None)."""
    tree = global_tree(model)
    pspecs = sharding.param_pspecs(tree, mesh, fsdp=fsdp,
                                   data_axes=data_axes,
                                   model_axis=model_axis)
    specs = sharding.tree_leaves(pspecs)
    layout = sharding.shard_layout(
        [t.shape for t in sharding.tree_leaves(
            tree, lambda x: isinstance(x, torch.Tensor))],
        specs, mesh, data_axes, dist.get_rank(), group,
        model_axis=model_axis, mgroup=mgroup)
    if layout.index != dist.get_rank(group):
        raise ValueError(f"rank {dist.get_rank()} holds shard "
                         f"{layout.index} but is rank "
                         f"{dist.get_rank(group)} of its group")
    if not fsdp:
        return layout, None
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


def _whole_leaves(grads, layout, tp):
    """The model-sharded leaves of ``grads`` whole: gathered over the
    model group, one ``all_gather_into_tensor`` a dtype."""
    out = list(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        if layout.mdims[i] is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    M = tp.size
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        full = flat.new_empty((M, flat.numel()))
        dist.all_gather_into_tensor(full.view(-1), flat, group=tp.group)
        at = 0
        for i in idx:
            g, d = grads[i], layout.mdims[i]
            n = g.numel()
            out[i] = full[:, at:at + n].reshape(M, *g.shape).movedim(0, d) \
                .reshape(*g.shape[:d], M * g.shape[d], *g.shape[d + 1:])
            at += n
    return out


def _slices(leaves, layout, tp):
    """This rank's model slice of each whole leaf."""
    return [t if d is None else tp.slice(t, d)
            for t, d in zip(leaves, layout.mdims)]


def build_train_step(model, optimizer: Optimizer, strategy: Strategy,
                     mesh=None, *, group=None, data_axes=("data",),
                     model_axis=None, fsdp: bool = False, loss_fn=None,
                     fsdp_rs_dtype=torch.float32) -> TrainStep:
    """Train step for ``model`` with ``loss_fn(model, batch) -> loss``
    (``None``: ``default_loss``).  ``group`` is the data-parallel process
    group (``None``: the default one, which must be initialised).

    ``mesh`` (``launch.mesh.Mesh``) names the data axes: their product
    must be the group's size, and the rank's place on the mesh its rank in
    the group.  A ``model_axis`` of size above 1 is tensor parallelism
    (every LM family; the module docstring): then ``group`` is None and the
    step makes its data and model groups from the mesh (every rank builds
    at once).  Of size 1 it only steers the specs, as in the reference.
    ``fsdp=True`` shards the model's block/tail leaves (see the module
    docstring); the model takes its layout when ``init_state`` is
    called.

    ``state["params"]`` are the module's own parameters, in the reference
    tree's leaf order, updated in place."""
    K = strategy.microbatches
    loss_fn = default_loss if loss_fn is None else loss_fn
    layout = hook = tp = None
    if mesh is not None:
        sharding.require_tp_family(model.cfg, mesh, model_axis)
        M = sharding.model_size(mesh, model_axis)
        mgroup = None
        if M > 1:
            if group is not None:
                raise ValueError("with a model axis the train step makes "
                                 "its data and model groups from the mesh")
            group, mgroup = rank_groups(mesh, data_axes, model_axis)
        W = sharding._axis_size(mesh, data_axes)
        if W != dist.get_world_size(group):
            raise ValueError(f"data axes {data_axes} span {W} ranks, the "
                             f"group {dist.get_world_size(group)}")
        if fsdp or M > 1:
            layout, hook = _plan(model, mesh, data_axes, model_axis, fsdp,
                                 group, mgroup, fsdp_rs_dtype)
        if M > 1:
            tp = TensorParallel(mgroup, M, layout.mindex)
    elif fsdp:
        raise ValueError("fsdp=True needs a mesh")
    mask = layout.mask if layout is not None else None
    # a strategy that is not elementwise syncs whole leaves
    whole = tp is not None and not strategy.elementwise
    sub = None
    if layout is not None:
        # the layout of the leaves the strategy syncs (FSDP's bypass it)
        keep = [i for i, m in enumerate(layout.mask) if not m]
        sub = dataclasses.replace(
            layout, shapes=tuple(layout.shapes[i] for i in keep),
            dims=tuple(None for _ in keep),
            mdims=tuple(layout.mdims[i] for i in keep))

    def value_and_grad(params, batch):
        loss = loss_fn(model, batch)
        return loss.detach(), torch.autograd.grad(loss, params)

    def sync(grads, strat):
        """The strategy's sync of the list ``grads``, which a sync of whole
        leaves empties once it has gathered them: the slices go before
        the strategy makes its buffers, the whole leaves before the
        synced ones are sliced."""
        if not whole:
            return strategy.sync(grads, strat, group)
        leaves = _whole_leaves(grads, sub, tp)
        grads.clear()
        synced, strat, info = strategy.sync(leaves, strat, group)
        del leaves
        return _slices(synced, sub, tp), strat, info

    def step_fn(state, batch):
        model.param_hook = hook
        model.tp = tp
        model.batch_group = None
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
            synced, state["strat"], info = sync(list(grads), state["strat"])
        else:
            # reduce-scattered leaves: the sum over ranks -> the mean
            fsdp = [g / layout.W if m else None for g, m in zip(grads, mask)]
            part = [g for g, m in zip(grads, mask) if not m]
            del grads
            part, state["strat"], info = sync(part, state["strat"])
            part = iter(part)
            synced = [g if g is not None else next(part) for g in fsdp]
        updates, state["opt"] = optimizer.update(synced, state["opt"],
                                                 params)
        apply_updates(params, updates)
        state["step"] += 1
        metrics = {"loss": _pmean(loss, group), "step": state["step"]}
        metrics.update({k: _pmean(v, group) for k, v in info.items()})
        return state, metrics

    def init_state():
        shard_model(model, layout)
        model.tp = tp
        params = reference_leaves(model)
        sync_like = params if mask is None else \
            [p for p, m in zip(params, mask) if not m]
        if whole:
            # the strategy's state is whole, as the reference's
            sync_like = [p.new_empty(s) for p, s in zip(sync_like,
                                                       sub.shapes)]
        return {"params": params, "opt": optimizer.init(params),
                "strat": strategy.init_state(sync_like), "step": 0}

    return TrainStep(step_fn=step_fn, init_state=init_state, layout=layout)
