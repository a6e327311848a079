"""Optimizers over lists of tensors (``repro.optim.optimizers``).

Same interface as the reference: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, then
``apply_updates(params, updates)``, with the reference's formulas (fp32
moments, updates cast to the parameter dtype).  Unlike the reference, the
moments in ``state`` are updated in place and ``apply_updates`` adds the
updates to the parameters in place, so no second copy of either is kept.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params) -> (updates, state)


def _zeros32(params):
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": 0}
        return {"step": 0, "mu": _zeros32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        del params
        step = state["step"] + 1
        if momentum == 0.0:
            return [(-lr * g).to(g.dtype) for g in grads], {"step": step}
        mu = state["mu"]
        for m, g in zip(mu, grads):
            m.mul_(momentum).add_(g.float())
        ups = [(-lr * m).to(g.dtype) for m, g in zip(mu, grads)]
        return ups, {"step": step, "mu": mu}

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, use_fused: bool = False) -> Optimizer:
    """AdamW with the reference's formula: weight decay acts on the old
    parameter inside the lr term."""
    if use_fused:
        raise NotImplementedError(
            "adamw(use_fused=True) needs the fused AdamW kernel "
            "(ROADMAP.md, TPU kernels to port: fused_adamw_flat), which is "
            "not ported yet")

    def init(params):
        return {"step": 0, "m": _zeros32(params), "v": _zeros32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step
        c2 = 1.0 - b2 ** step
        ups = []
        for g, m, v, p in zip(grads, state["m"], state["v"], params):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            u = -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                       + weight_decay * p.float())
            ups.append(u.to(p.dtype))
        return ups, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` in place for each parameter; returns ``params``."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
    return params
