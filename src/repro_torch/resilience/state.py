"""The train step's state <-> the reference's checkpointed state tree.

``core.train_step`` keeps ``{"params": [...], "opt": {"step": int, "m":
[...], "v": [...]}, "strat": ..., "step": int}`` on each rank: lists in
the reference tree's leaf order, the strategy's state per rank.  The
reference checkpoints one global tree: ``params``, ``m`` and ``v`` each
in the parameter tree's shape (``models.param_tree``, with its empty
lists), ``strat`` as a list of leaves with a leading axis over
the W workers, and both steps as int32 0-d arrays.  ``to_reference``
builds that tree (gathering every rank's strategy rows), ``template``
describes it on the ``meta`` device, and ``from_reference`` writes a
restored tree back into a rank's state in place.

Under FSDP (a ``core.sharding.ShardLayout``) a rank holds shards of the
sharded leaves and of their moments: ``to_reference`` gathers them, so
the tree (and the checkpoint) is the whole one, ``template`` describes
the whole shapes, and ``from_reference`` keeps the rank's shards, in the
layout given, which may differ from the writer's (a smaller fleet).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.checkpoint import flatten, unflatten
from repro_torch.models import param_tree
from repro_torch.models.params import set_leaves


def _strat_leaves(strat):
    """A strategy state's leaves: none for ``()``, else a sequence of
    tensors (MLLess's residual, one per parameter leaf)."""
    if strat is None or (isinstance(strat, tuple) and not strat
                         and type(strat) is tuple):
        return None
    if isinstance(strat, (list, tuple)) and all(
            isinstance(t, torch.Tensor) for t in strat):
        return list(strat)
    raise NotImplementedError(
        f"no checkpoint layout for strategy state {type(strat).__name__}")


def _int32(n) -> torch.Tensor:
    return torch.tensor(int(n), dtype=torch.int32)


def _tree(state, model, strat):
    ptree = param_tree(model)
    opt = {k: unflatten(ptree, v) if isinstance(v, list) else _int32(v)
           for k, v in state["opt"].items()}
    return {"opt": opt, "params": unflatten(ptree, state["params"]),
            "step": _int32(state["step"]), "strat": strat}


def _whole(leaves, layout):
    if layout is None:
        return leaves
    return [layout.gather(i, t.detach()) for i, t in enumerate(leaves)]


def to_reference(state, model, group=None, layout=None):
    """The reference's global state tree for this rank's ``state``.
    Collective over ``group`` when the strategy keeps per-rank state:
    each leaf gains a leading axis holding every rank's row, in rank
    order; and over ``layout``'s group when it shards leaves, which are
    gathered whole."""
    if layout is not None:
        state = dict(state, params=_whole(state["params"], layout),
                     opt={k: _whole(v, layout) if isinstance(v, list)
                          else v for k, v in state["opt"].items()})
    leaves = _strat_leaves(state["strat"])
    if leaves is None:
        return _tree(state, model, ())
    W = dist.get_world_size(group) if dist.is_initialized() else 1
    rows = []
    for t in leaves:
        t = t.detach().contiguous()
        out = t.new_empty((W,) + tuple(t.shape))
        if W == 1:
            out[0].copy_(t)
        else:
            dist.all_gather_into_tensor(out.view(-1), t.view(-1),
                                        group=group)
        rows.append(out)
    return _tree(state, model, rows)


def _meta(t, lead=()):
    return torch.empty(lead + tuple(t.shape), dtype=t.dtype, device="meta")


def describe(tree):
    """``tree`` with each tensor replaced by an empty one of its shape
    and dtype on the ``meta`` device: a restore template that allocates
    nothing."""
    return unflatten(tree, [_meta(t) for t in flatten(tree)])


def template(state, model, n_workers: int, layout=None):
    """``to_reference``'s tree, described (no allocation, no collective),
    with strategy rows for ``n_workers`` and, under ``layout``, the
    sharded leaves whole."""
    leaves = _strat_leaves(state["strat"])
    strat = () if leaves is None else [_meta(t, (n_workers,))
                                       for t in leaves]
    if layout is not None:
        def whole(ts):
            return [torch.empty(shape, dtype=t.dtype, device="meta")
                    for t, shape in zip(ts, layout.shapes)]
        state = dict(state, params=whole(state["params"]),
                     opt={k: whole(v) if isinstance(v, list) else v
                          for k, v in state["opt"].items()})
    return describe(_tree(state, model, strat))


def _place(dst, src):
    """``src`` into ``dst`` in place where the shapes agree; else a copy
    of ``src`` on ``dst``'s device and dtype, to take its place."""
    if tuple(dst.shape) == tuple(src.shape):
        return dst.copy_(src)
    return src.to(device=dst.device, dtype=dst.dtype).clone()


@torch.no_grad()
def from_reference(tree, state, row: int, layout=None, model=None):
    """Write a restored reference tree into ``state`` in place: the
    parameters and moments are copied into the tensors the train step
    holds (the module's own parameters stay the same objects), the steps
    become ints and the strategy state becomes row ``row`` of each
    leaf, on the device of the parameters.  With ``model``, the
    parameters are laid out by ``layout`` (None: whole) and so are the
    moments, which take new tensors where their shape changes."""
    params = flatten(tree["params"])
    if model is not None:
        set_leaves(model, params, layout)
    else:
        for dst, src in zip(state["params"], params):
            dst.copy_(src)
    for k, v in state["opt"].items():
        if isinstance(v, list):
            state["opt"][k] = [
                _place(dst, src if layout is None else layout.shard(i, src))
                for i, (dst, src) in enumerate(zip(v, flatten(
                    tree["opt"][k])))]
        else:
            state["opt"][k] = int(tree["opt"][k])
    state["step"] = int(tree["step"])
    leaves = flatten(tree["strat"])
    dev = state["params"][0].device
    state["strat"] = [t[row].to(dev) for t in leaves] if leaves else ()
    return state
