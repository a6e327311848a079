"""Cheap runtime backstop for the report boundary (``repro.guards``).

The report dataclasses (``serverless.RuntimeReport``) are where simulated
numbers become *claims*: golden snapshots, hashes, Pareto fronts.  A
``torch.Tensor`` leaking into one of those fields means a report was
built from device or autograd values instead of concrete host numbers,
which silently ties a pure host-side measurement to a tensor (a device
sync on every read, or a graph kept alive).  ``no_tracer_fields`` keeps
the reference's name and contract, with a tensor where the reference
has a jax tracer: O(fields) type checks, no torch import, so
analytic-only users never pay accelerator import costs.
"""
from __future__ import annotations

import dataclasses


def _is_tensor(value) -> bool:
    t = type(value)
    if t.__module__.partition(".")[0] != "torch":   # fast path: host types
        return False
    return any(c.__name__ == "Tensor" for c in t.__mro__)


def _scan(value, depth: int = 2):
    """Yield tensor-typed values in ``value`` (containers one level of
    tuple/list/dict deep per ``depth`` — report fields are flat or
    shallowly nested)."""
    if _is_tensor(value):
        yield value
    elif depth and isinstance(value, (tuple, list)):
        for v in value:
            yield from _scan(v, depth - 1)
    elif depth and isinstance(value, dict):
        for v in value.values():
            yield from _scan(v, depth - 1)


def no_tracer_fields(obj) -> None:
    """Raise ``TypeError`` if any dataclass field of ``obj`` holds a
    ``torch.Tensor`` (directly or inside a shallow tuple/list/dict)."""
    for f in dataclasses.fields(obj):
        for bad in _scan(getattr(obj, f.name)):
            raise TypeError(
                f"{type(obj).__name__}.{f.name} holds a torch tensor "
                f"({type(bad).__name__}); reports must be built from "
                "concrete host values")
