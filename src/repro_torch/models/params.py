"""The reference's parameter tree <-> a module's parameters.

A module whose parameter names are the reference tree's paths
(``blocks.0.attn.wq`` for ``tree["blocks"][0]["attn"]["wq"]``) holds the
same leaves as the tree.  These helpers list them in the reference's
leaf order and move a tree of numpy arrays in and out of the module; the
CNNs and the transformer share them.  ``cache_from_reference`` and
``cache_to_reference`` move a decode cache, a tree of dicts and lists of
the same layout in both packages, the same way.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _path(name: str):
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def reference_leaves(model: nn.Module):
    """The module's parameters in the reference tree's leaf order
    (``jax.tree.leaves``: dict keys sorted, list entries in order)."""
    return [p for _, p in sorted(model.named_parameters(),
                                 key=lambda kv: _path(kv[0]))]


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield prefix, np.asarray(tree)


def params_from_reference(tree, mesh=None, rank=None, *, data_axes=None,
                          model_axis="auto", fsdp: bool = True) -> dict:
    """State dict for ``load_state_dict`` from the reference's parameter
    tree of numpy arrays.  With ``mesh``, each leaf keeps only global
    ``rank``'s slice under ``param_pspecs`` (at ``fsdp`` over
    ``data_axes``, by default the mesh's ``pod``/``data`` axes, and over
    ``model_axis``): the state of a model that ``build_train_step(...,
    fsdp=fsdp)`` has sharded.  ``model_axis`` defaults to ``"model"`` where
    the mesh has that axis (the reference's default), else None."""
    flat = {".".join(path): arr for path, arr in _walk(tree)}
    if mesh is not None:
        from repro_torch.core import sharding
        from repro_torch.launch.mesh import data_axes_of
        if model_axis == "auto":
            model_axis = "model" if "model" in mesh.axis_names else None
        specs = sharding.param_pspecs(
            _map_tree(np.asarray, tree), mesh, fsdp=fsdp,
            data_axes=data_axes or data_axes_of(mesh),
            model_axis=model_axis)
        for path, spec in _walk_specs(specs):
            key = ".".join(path)
            flat[key] = sharding.Sharding(mesh, spec).shard(
                torch.from_numpy(np.asarray(flat[key])), rank).numpy()
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in flat.items()}


def _walk_specs(tree, prefix=()):
    from repro_torch.core.sharding import PSpec
    if isinstance(tree, PSpec):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_specs(v, prefix + (str(k),))
    else:
        for i, v in enumerate(tree):
            yield from _walk_specs(v, prefix + (str(i),))


def param_tree(model: nn.Module):
    """The module's parameters as the reference's tree (dicts, and lists
    where the keys are indices); the leaves are the parameters
    themselves.  The top-level lists a module names in
    ``reference_lists`` are kept when empty, as the reference keeps them
    (a transformer's ``'tail': []`` where the depth is whole pattern
    blocks)."""
    root: dict = {}
    for name, p in model.named_parameters():
        node, path = root, _path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p

    def listify(node):
        if not isinstance(node, dict):
            return node
        if all(isinstance(k, int) for k in node):
            return [listify(node[i]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}
    tree = listify(root)
    for key in getattr(model, "reference_lists", ()):
        tree.setdefault(key, [])
    return tree


def params_to_reference(model: nn.Module):
    """The reference's parameter tree of numpy arrays for ``model``; the
    inverse of ``params_from_reference``.  A sharded model
    (``model.param_layout``) gathers its shards first: collective over the
    layout's groups."""
    full = {id(p): t for p, t in zip(reference_leaves(model),
                                     full_leaves(model))}
    return _map_tree(lambda p: np.ascontiguousarray(
        full[id(p)].detach().cpu().numpy()), param_tree(model))


# ---------------------------------------------------------------------------
# FSDP and TP: a module holding slices of its parameters
# ---------------------------------------------------------------------------
def layout_of(model: nn.Module):
    """The module's layout (``core.sharding.ShardLayout``), None where it
    holds every parameter whole."""
    return getattr(model, "param_layout", None)


def global_shapes(model: nn.Module):
    """Each parameter's global shape, in the reference's leaf order."""
    layout = layout_of(model)
    if layout is not None:
        return list(layout.shapes)
    return [tuple(p.shape) for p in reference_leaves(model)]


def global_tree(model: nn.Module):
    """``param_tree`` with each leaf an empty ``meta`` tensor of the
    parameter's global shape and dtype."""
    shapes = {id(p): s for p, s in zip(reference_leaves(model),
                                       global_shapes(model))}
    return _map_tree(lambda p: torch.empty(shapes[id(p)], dtype=p.dtype,
                                           device="meta"), param_tree(model))


def full_leaves(model: nn.Module):
    """The parameters whole, in the reference's leaf order (the slices of
    a sharded leaf gathered: collective over the layout's groups)."""
    params = reference_leaves(model)
    layout = layout_of(model)
    if layout is None:
        return params
    with torch.no_grad():
        return [layout.gather(i, p.detach()) for i, p in enumerate(params)]


@torch.no_grad()
def set_leaves(model: nn.Module, leaves, layout=None):
    """Write whole parameter values (reference leaf order) into ``model``
    laid out by ``layout`` (None: whole): a parameter whose shape changes
    gets new storage, the Parameter object stays the same."""
    for i, (p, full) in enumerate(zip(reference_leaves(model), leaves)):
        t = full if layout is None else layout.shard(i, full)
        t = t.to(device=p.device, dtype=p.dtype)
        if tuple(p.shape) == tuple(t.shape):
            p.copy_(t)
        else:
            p.data = t.clone()
    model.param_layout = layout


def shard_model(model: nn.Module, layout):
    """Lay the module's parameters out by ``layout`` (a no-op where they
    already are); from another layout the slices are gathered first,
    collectively over the old layout's groups."""
    old = layout_of(model)
    if old is None and layout is None:
        return
    if old is not None and layout is not None and old.key() == layout.key():
        model.param_layout = layout
        return
    set_leaves(model, full_leaves(model), layout)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def cache_from_reference(tree, device=None):
    """The port's decode cache from the reference's cache tree of numpy
    arrays (``{"blocks": [...], "tail": [...]}``), on ``device``."""
    return _map_tree(lambda a: torch.from_numpy(np.array(a, order="C"))
                     .to(device), tree)


def cache_to_reference(cache):
    """The reference's cache tree of numpy arrays for a port's cache."""
    return _map_tree(lambda t: np.ascontiguousarray(t.detach().cpu()
                                                    .numpy()), cache)
