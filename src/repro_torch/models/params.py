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


def params_from_reference(tree) -> dict:
    """State dict for ``load_state_dict`` from the reference's parameter
    tree of numpy arrays."""
    return {".".join(path): torch.from_numpy(np.array(arr, order="C"))
            for path, arr in _walk(tree)}


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
    inverse of ``params_from_reference``."""
    return _map_tree(lambda p: np.ascontiguousarray(
        p.detach().cpu().numpy()), param_tree(model))


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
