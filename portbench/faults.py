"""Faults planted underneath the timed path, each one the ``correct``
comparison has to catch: a step that leaves its state unchanged
(``frozen``), a step that leaves the float32 leaves (norms, router,
WKV decay and bonus) unchanged (``fp32_frozen``), half of the batch left out and the mean taken over the
rest (``half_batch``), and the exchange between ranks left out
(``no_exchange``).  Each is a context manager that patches the program's
module while the train step is built and run; the tests and
``calibrate.py`` use them, the benchmark's runs never do."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def frozen():
    """The optimizer's updates are never applied."""
    from repro_torch.core import train_step
    saved = train_step.apply_updates
    train_step.apply_updates = lambda params, updates: params
    try:
        yield
    finally:
        train_step.apply_updates = saved


@contextlib.contextmanager
def fp32_frozen():
    """The optimizer's updates applied to every leaf but those stored in
    float32, which go through the fused AdamW's float instance."""
    import torch
    from repro_torch.core import train_step
    saved = train_step.apply_updates

    def apply(params, updates):
        kept = [(p, u) for p, u in zip(params, updates)
                if p.dtype != torch.float32]
        saved([p for p, _ in kept], [u for _, u in kept])
        return params
    train_step.apply_updates = apply
    try:
        yield
    finally:
        train_step.apply_updates = saved


def _half(batch):
    """The first half of the rows, or of the sequence for one row."""
    B, S = batch["tokens"].shape
    if B > 1:
        return {k: v[:B // 2] for k, v in batch.items()}
    return {k: v[:, :S // 2] for k, v in batch.items()}


@contextlib.contextmanager
def half_batch():
    """The loss, and so the gradient, over half of each rank's batch."""
    from repro_torch.core import train_step
    saved = train_step.default_loss
    train_step.default_loss = lambda model, batch: saved(model, _half(batch))
    try:
        yield
    finally:
        train_step.default_loss = saved


@contextlib.contextmanager
def no_exchange():
    """The dense strategies' all-reduce left out: each rank keeps its
    own gradient (through the same flat copy)."""
    from repro_torch.core import strategies
    saved = strategies._pmean32
    strategies._pmean32 = lambda grads, group: strategies._unflat(
        strategies._flat32(grads), grads)
    try:
        yield
    finally:
        strategies._pmean32 = saved


FAULTS = {"frozen": frozen, "fp32_frozen": fp32_frozen,
          "half_batch": half_batch,
          "no_exchange": no_exchange}
