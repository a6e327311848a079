"""Collective bytes of the port's steps, as recorded when they run: the
counterpart of ``repro.costmodel.hlo_analysis``.

The reference parses the compiled (post-SPMD) HLO for its collective ops,
with while-loop trip counts as multipliers.  Eager PyTorch has no HLO: the
port's collectives are the ``torch.distributed`` calls its code issues, so
:func:`record_collectives` wraps those calls for the duration of a
``with`` block and records each one's kind, result bytes and group size.
A step run once under it (on a real process group, or on a fake one over
``meta`` tensors for the dry-run) gives the same :class:`CollectiveStats`
the reference's ``analyze_collectives`` returns; ``unresolved_loops`` is
always 0, since every issued op is seen.

Byte semantics per op, the reference's: result-shape bytes, and wire
bytes per rank for a ring over a group of size g:
  all-reduce      2 x result
  all-gather      1 x result
  reduce-scatter  (g - 1) x result
  all-to-all      1 x result
  broadcast       1 x result (the port's one kind the reference's HLO
                  does not list; its collective-permute is never issued)

``io_bytes(inputs, outputs)`` is ``entry_io_bytes``: the bytes a call must
read and write at least once, from the tensors themselves.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]
    total_bytes: float          # result-shape bytes
    wire_bytes: float           # schedule-weighted (2x for all-reduce)
    unresolved_loops: int


@dataclasses.dataclass(frozen=True)
class Record:
    kind: str
    bytes: int                  # result bytes
    group_size: int


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group(args, kwargs, pos):
    g = kwargs.get("group", args[pos] if len(args) > pos else None)
    return dist.get_world_size(g)


# (function name, kind, result bytes of (args, kwargs), group arg position)
_WRAPPED = (
    ("all_reduce", "all-reduce", lambda a, k: _nbytes(a[0]), 2),
    ("all_gather_into_tensor", "all-gather",
     lambda a, k: _nbytes(k.get("output_tensor", a[0])), 2),
    ("all_gather", "all-gather",
     lambda a, k: sum(_nbytes(t) for t in k.get("tensor_list", a[0])), 2),
    ("reduce_scatter_tensor", "reduce-scatter",
     lambda a, k: _nbytes(k.get("output", a[0])), 3),
    ("all_to_all_single", "all-to-all",
     lambda a, k: _nbytes(k.get("output", a[0])), 4),
    ("broadcast", "broadcast", lambda a, k: _nbytes(k.get("tensor", a[0])),
     2),
)


@contextlib.contextmanager
def record_collectives():
    """Records every collective the block issues; yields the list of
    :class:`Record` (filled as they run; :func:`stats` sums them)."""
    records: List[Record] = []
    saved = {}

    def wrap(name, kind, size, gpos):
        fn = getattr(dist, name)
        saved[name] = fn

        def recorded(*args, **kwargs):
            records.append(Record(kind, int(size(args, kwargs)),
                                  _group(args, kwargs, gpos)))
            return fn(*args, **kwargs)
        return recorded

    for name, kind, size, gpos in _WRAPPED:
        setattr(dist, name, wrap(name, kind, size, gpos))
    try:
        yield records
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def stats(records) -> CollectiveStats:
    """The reference's ``CollectiveStats`` of recorded collectives."""
    counts = {k: 0 for k in KINDS}
    by_kind = {k: 0.0 for k in KINDS}
    total = wire = 0.0
    for r in records:
        factor = _WIRE_FACTOR[r.kind]
        if r.kind == "reduce-scatter":
            factor = max(r.group_size - 1, 1)
        counts[r.kind] += 1
        by_kind[r.kind] += r.bytes
        total += r.bytes
        wire += r.bytes * factor
    return CollectiveStats(counts=counts, bytes_by_kind=by_kind,
                           total_bytes=total, wire_bytes=wire,
                           unresolved_loops=0)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples (each
    storage counted once per tensor, views as their own size)."""
    return sum(_nbytes(t) for t in _tensors(tree))


def io_bytes(inputs, outputs) -> Tuple[int, int]:
    """(input bytes, output bytes): the memory floor of one call, every
    input read once and every output written once (``entry_io_bytes``)."""
    return tree_bytes(inputs), tree_bytes(outputs)
