"""Data-parallel train step (``repro.core.train_step``, pure-DP form).

One process per rank.  Each rank computes autograd gradients on its own
shard of the global batch, the strategy syncs them over the process
group, and every rank applies the same optimizer update to its replica
of the parameters.  The strategy's state (MLLess's residual) is per rank.

SPIRT's accumulation runs over ``Ke = gcd(K, B_local)`` microbatches and
averages their gradients; the reported loss is the last microbatch's, as
in the reference.  Loss and info metrics are averaged across ranks.
FSDP and tensor parallelism are not ported yet.

The model is any module whose parameter names are the reference tree's
paths (``models.cnn``, ``models.transformer``); the batch is a dict of
tensors sharing their leading (batch) dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import losses
from repro_torch.core.strategies import Strategy
from repro_torch.models.params import reference_leaves
from repro_torch.optim.optimizers import Optimizer, apply_updates


@dataclasses.dataclass
class TrainStep:
    step_fn: Callable            # (state, batch) -> (state, metrics)
    init_state: Callable         # () -> state


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


def build_train_step(model, optimizer: Optimizer, strategy: Strategy, *,
                     group=None, loss_fn=None) -> TrainStep:
    """Train step for ``model`` with ``loss_fn(model, batch) -> loss``
    (``None``: ``default_loss``).  ``group`` is the data-parallel process
    group (``None``: the default one, which must be initialised).

    ``state["params"]`` are the module's own parameters, in the reference
    tree's leaf order, updated in place."""
    K = strategy.microbatches
    loss_fn = default_loss if loss_fn is None else loss_fn

    def value_and_grad(params, batch):
        loss = loss_fn(model, batch)
        return loss.detach(), torch.autograd.grad(loss, params)

    def step_fn(state, batch):
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

        synced, state["strat"], info = strategy.sync(
            list(grads), state["strat"], group)
        updates, state["opt"] = optimizer.update(synced, state["opt"],
                                                 params)
        apply_updates(params, updates)
        state["step"] += 1
        metrics = {"loss": _pmean(loss, group), "step": state["step"]}
        metrics.update({k: _pmean(v, group) for k, v in info.items()})
        return state, metrics

    def init_state():
        params = reference_leaves(model)
        return {"params": params, "opt": optimizer.init(params),
                "strat": strategy.init_state(params), "step": 0}

    return TrainStep(step_fn=step_fn, init_state=init_state)
