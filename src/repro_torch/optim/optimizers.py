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

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


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


def bias_corrections(b1: float, b2: float, step: int, device):
    """(c1, c2) = (1 - b1**step, 1 - b2**step) as fp32 tensors on
    ``device``, computed in fp32 as the reference computes them."""
    b = torch.tensor([b1, b2], dtype=torch.float32)
    c = 1.0 - b ** torch.tensor(float(step), dtype=torch.float32)
    c = c.to(device)
    return c[0], c[1]


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, use_fused: bool = False) -> Optimizer:
    """AdamW with the reference's formula: weight decay acts on the old
    parameter inside the lr term.  ``use_fused`` runs the fused AdamW
    kernel (``kernels.ops.fused_adamw``) once per leaf; otherwise the
    update is its plain version, ``kernels.ref.fused_adamw_flat``, with
    the same fp32 bias corrections (``bias_corrections``), so the two give
    the same bits."""

    def init(params):
        return {"step": 0, "m": _zeros32(params), "v": _zeros32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        c1, c2 = bias_corrections(b1, b2, step, params[0].device)
        ups = []
        for g, m, v, p in zip(grads, state["m"], state["v"], params):
            if use_fused:
                u, _, _ = kops.fused_adamw(g, m, v, p, lr=lr, b1=b1, b2=b2,
                                           eps=eps, wd=weight_decay, c1=c1,
                                           c2=c2)
                ups.append(u)
                continue
            u, m_new, v_new = kref.fused_adamw_flat(
                g, m, v, p, c1, c2, lr=lr, b1=b1, b2=b2, eps=eps,
                wd=weight_decay)
            m.copy_(m_new)
            v.copy_(v_new)
            ups.append(u.to(p.dtype))
        return ups, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` in place for each parameter; returns ``params``."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
    return params
