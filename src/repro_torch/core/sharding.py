"""Divisibility-aware sharding rules for parameter and cache trees
(``repro.core.sharding``).

Rules, as in the reference:
  * 'model' goes on the widest eligible dim of each leaf (tensor
    parallelism); the leading stacking dim of ``blocks``/``tail``/
    ``encoder`` leaves (the reference's ``lax.scan`` axis) is never
    sharded;
  * with ``fsdp=True``, block/tail/encoder leaves also shard their widest
    remaining dim over the data axes (ZeRO-3): the train step all-gathers
    each layer's shard inside the layer and reduce-scatters its gradient.

A spec is a :class:`PSpec`, a tuple of entries (``None``, an axis name, or
a tuple of names) equal to a ``PartitionSpec``'s entries.  A spec tree
mirrors the parameter tree (``models.param_tree``) or the decode cache
tree; its leaves may be tensors, meta tensors or anything with a
``shape``.  :class:`Sharding` (the reference's ``NamedSharding``) puts a
spec on a :class:`~repro_torch.launch.mesh.Mesh` and gives the local
shard of a global shape for one rank.

A model axis larger than 1 is tensor parallelism (``models.tp``) for
every transformer family; a CNN there raises ``NotImplementedError``
(``require_tp_family``), as the reference runs none.  A
:class:`ShardLayout` says which slice of each parameter a rank holds over
the model axis and, under FSDP, over the data axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class PSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim split over their product, the first
    axis major).  A one-name tuple is stored as the name, as
    ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"


def _is_spec(x) -> bool:
    return isinstance(x, PSpec)


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        return mesh.shape[axes]
    return int(np.prod([mesh.shape[a] for a in axes]))


def _map_with_path(fn, tree, path=(), is_leaf=None):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; ``path``
    holds the dict keys and list indices on the way to the leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,), is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(_map_with_path(fn, v, path + (i,), is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree, is_leaf=_is_spec):
    """The leaves in the reference's order (``jax.tree.leaves``: dict keys
    sorted, list entries in order)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k],
                                                             is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def leaf_pspec(shape: Sequence[int], mesh, *, model_axis="model",
               data_axes=None, skip_leading=False, fsdp=False) -> PSpec:
    """Assign mesh axes to tensor dims by divisibility, widest first.
    ``model_axis=None`` disables tensor parallelism (pure-DP profile)."""
    shape = tuple(shape)
    ndim = len(shape)
    assign: list = [None] * ndim
    start = 1 if (skip_leading and ndim > 1) else 0
    order = sorted(range(start, ndim), key=lambda i: -shape[i])
    if model_axis is not None:
        msize = _axis_size(mesh, model_axis)
        for i in order:
            if shape[i] % msize == 0 and shape[i] >= msize:
                assign[i] = model_axis
                break
    if fsdp and data_axes is not None:
        dsize = _axis_size(mesh, data_axes)
        for i in order:
            if assign[i] is None and shape[i] % dsize == 0 \
                    and shape[i] >= dsize:
                assign[i] = data_axes
                break
    return PSpec(*assign)


def param_pspecs(params, mesh, *, fsdp=False, data_axes=("data",),
                 model_axis="model"):
    """Spec tree for a transformer's parameter tree."""
    def one(path, leaf):
        in_blocks = any(k in ("blocks", "tail", "encoder") for k in path)
        return leaf_pspec(
            leaf.shape, mesh, model_axis=model_axis,
            data_axes=data_axes if in_blocks else None,
            skip_leading=in_blocks, fsdp=fsdp and in_blocks)
    return _map_with_path(one, params)


def cache_pspecs(cache, mesh, *, batch_axes=("data",), model_axis="model",
                 shard_seq=False):
    """KV caches: batch over the data axes when divisible; at batch 1
    (``long_500k``) optionally the sequence dim instead (context
    parallelism for decode)."""
    bsize = _axis_size(mesh, batch_axes)

    def one(path, leaf):
        stacked = any(k in ("blocks", "tail") for k in path) or \
            "enc_kv" in path
        shape = tuple(leaf.shape)
        bdim = 1 if stacked else 0
        assign: list = [None] * len(shape)
        if shape[bdim] % bsize == 0 and shape[bdim] >= bsize:
            assign[bdim] = batch_axes
        elif shard_seq and len(shape) > bdim + 1:
            sdim = bdim + 1     # the ring buffer's (or state's) next dim
            if shape[sdim] % bsize == 0 and shape[sdim] >= bsize:
                assign[sdim] = batch_axes
        # the model axis on a head/width dim, the KV-heads dim (-2) first
        # so an int8 payload and its (.., KV, 1) scales shard alike
        if model_axis is not None:
            msize = _axis_size(mesh, model_axis)
            ndim = len(shape)
            prefer = [ndim - 2, ndim - 1] + list(range(ndim - 3, bdim, -1))
            for i in prefer:
                if i <= bdim or i >= ndim:
                    continue
                if assign[i] is None and shape[i] % msize == 0 \
                        and shape[i] >= msize:
                    assign[i] = model_axis
                    break
        return PSpec(*assign)
    return _map_with_path(one, cache)


def survivor_mesh(mesh, dead: int, *, data_axis: str = "data"):
    """The mesh with the ``dead`` data-parallel slice removed.

    The surviving ranks keep their order (so the reduction order over
    survivors is stable) and every other axis is untouched.
    ``param_pspecs`` on the survivor mesh turns any dim that no longer
    divides back to replication, so restoring a checkpoint, or adopting a
    dead peer's partition, onto the smaller mesh is always defined."""
    from repro_torch.launch.mesh import Mesh
    if data_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {data_axis!r}; axes are "
                         f"{tuple(mesh.axis_names)}")
    axis = list(mesh.axis_names).index(data_axis)
    devs = np.asarray(mesh.devices)
    n = devs.shape[axis]
    if not 0 <= dead < n:
        raise ValueError(
            f"dead worker {dead} out of range for {data_axis}={n}")
    if n < 2:
        raise ValueError(
            f"cannot remove the last {data_axis!r} shard (size {n}); "
            "a one-worker fleet has no survivors to re-mesh")
    return Mesh(np.delete(devs, dead, axis=axis), mesh.axis_names)


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: PSpec

    def shard_shape(self, shape) -> tuple:
        """The local shape of a global ``shape``."""
        shape = list(shape)
        for d, entry in enumerate(self.spec):
            n = _axis_size(self.mesh, _entry_axes(entry)) if entry else 1
            if shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {entry!r} ({n})")
            shape[d] //= n
        return tuple(shape)

    def index(self, rank: int) -> tuple:
        """Per dim, (start, length) of ``rank``'s shard along a global
        dim of length 1 (multiply by the dim)."""
        coords = self.mesh.coords(rank)
        out = []
        for entry in self.spec:
            axes = _entry_axes(entry)
            if not axes:
                out.append((0, 1))
                continue
            sizes = [self.mesh.shape[a] for a in axes]
            idx = int(np.ravel_multi_index([coords[a] for a in axes],
                                           sizes))
            out.append((idx, int(np.prod(sizes))))
        return tuple(out)

    def shard(self, full, rank: int):
        """``rank``'s shard of the global tensor ``full`` (a view)."""
        out = full
        for d, (i, n) in enumerate(self.index(rank)):
            if n > 1:
                size = full.shape[d] // n
                out = out.narrow(d, i * size, size)
        return out


def shardings(tree_pspecs, mesh):
    return _map_with_path(lambda _, s: Sharding(mesh, s), tree_pspecs,
                          is_leaf=_is_spec)


def data_dim(spec, data_axes) -> Optional[int]:
    """The dim of ``spec`` sharded over exactly ``data_axes``, else None
    (the reference's ``_fsdp_dims``)."""
    dset = set(data_axes) if isinstance(data_axes, tuple) else {data_axes}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        if set(_entry_axes(entry)) == dset:
            return dim
    return None


def model_size(mesh, model_axis) -> int:
    """The ranks along ``model_axis`` (1 where it is None)."""
    return 1 if model_axis is None else _axis_size(mesh, model_axis)


def require_tp_family(cfg, mesh, model_axis):
    """Raise ``NotImplementedError`` where ``model_axis`` spans more than
    one rank and ``cfg`` is a CNN: the reference runs the CNNs on a model
    axis of 1 only.  Every transformer family runs tensor parallelism
    (``models.tp``)."""
    M = model_size(mesh, model_axis)
    if M > 1 and getattr(cfg, "family", "cnn") == "cnn":
        raise NotImplementedError(
            f"tensor parallelism for {cfg.name} (a CNN) over a model axis "
            f"of {M}: the reference runs the CNNs on a model axis of 1")


# ---------------------------------------------------------------------------
# the FSDP all-gather and its reduce-scatter transpose
# ---------------------------------------------------------------------------
def gather_dim(shard, dim: int, group=None):
    """All ranks' ``shard`` laid end to end along ``dim`` (tiled), in
    ``shard``'s dtype, through one ``all_gather_into_tensor``."""
    W = dist.get_world_size(group)
    shard = shard.contiguous()
    out = shard.new_empty((W,) + tuple(shard.shape))
    dist.all_gather_into_tensor(out.view(-1), shard.view(-1), group=group)
    return out.movedim(0, dim).reshape(
        *shard.shape[:dim], W * shard.shape[dim], *shard.shape[dim + 1:])


def scatter_dim(full, dim: int, group=None, dtype=torch.float32):
    """This rank's 1/W of the sum over ranks of ``full`` along ``dim``,
    through one ``reduce_scatter_tensor`` in ``dtype``, cast back."""
    W = dist.get_world_size(group)
    n = full.shape[dim] // W
    chunks = full.to(dtype).reshape(*full.shape[:dim], W, n,
                                    *full.shape[dim + 1:])
    chunks = chunks.movedim(dim, 0).contiguous()
    out = chunks.new_empty(chunks.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), chunks.view(-1),
                               op=dist.ReduceOp.SUM, group=group)
    return out.to(full.dtype)


class _Gather(torch.autograd.Function):
    """The reference's ``_make_fsdp_gather``: gather in the parameter's
    dtype; the backward reduce-scatters in ``rs_dtype``."""

    @staticmethod
    def forward(ctx, shard, dim, group, rs_dtype):
        ctx.dim, ctx.group, ctx.rs_dtype = dim, group, rs_dtype
        return gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.dim, ctx.group, ctx.rs_dtype), None, \
            None, None


def make_gather_hook(data_axes, group=None, rs_dtype=torch.float32):
    """Per-layer FSDP all-gather for ``Model.param_hook``.

    Returns ``hook(layer_params, layer_pspecs)``: each leaf whose spec
    (of the layer, leading stack dim removed) carries ``data_axes`` is
    all-gathered along that dim; the rest pass through."""
    def hook(layer_params, layer_pspecs):
        def one(path, g):
            spec = _get(layer_pspecs, path)
            dim = data_dim(spec, data_axes)
            return g if dim is None else _Gather.apply(g, dim, group,
                                                       rs_dtype)
        return _map_with_path(one, layer_params)
    return hook


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def drop_leading(spec: PSpec) -> PSpec:
    """One layer's spec of a stacked leaf (the stacking dim removed)."""
    return PSpec(*spec[1:])


# ---------------------------------------------------------------------------
# which slice of each leaf a rank holds (FSDP over the data axes, TP over
# the model axis)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class ShardLayout:
    """The layout of a parameter list (the reference tree's leaf order) on
    one rank: each leaf's global shape, the dim sharded over the data axes
    (``dims``; None: replicated there) and over the model axis (``mdims``),
    the data-parallel width ``W`` and the model width ``M``, this rank's
    slice along each (``index``, ``mindex``) and the groups the slices are
    gathered over (``group``, ``mgroup``; their ranks in slice order)."""
    shapes: tuple
    dims: tuple
    W: int
    index: int
    group: Any = None
    mdims: tuple = None
    M: int = 1
    mindex: int = 0
    mgroup: Any = None

    def __post_init__(self):
        if self.mdims is None:
            object.__setattr__(self, "mdims", (None,) * len(self.shapes))

    def key(self):
        return (self.shapes, self.dims, self.W, self.index, self.mdims,
                self.M, self.mindex)

    @property
    def mask(self):
        """Per leaf: True where the leaf is sharded over the data axes
        (FSDP: its gradient arrives reduce-scattered)."""
        return [d is not None for d in self.dims]

    def local_shape(self, i: int) -> tuple:
        shape = list(self.shapes[i])
        for d, n in ((self.dims[i], self.W), (self.mdims[i], self.M)):
            if d is not None:
                shape[d] //= n
        return tuple(shape)

    def shard(self, i: int, full):
        """This rank's slice of leaf ``i``'s global tensor (a view)."""
        out = full
        for d, n, k in ((self.dims[i], self.W, self.index),
                        (self.mdims[i], self.M, self.mindex)):
            if d is not None:
                size = full.shape[d] // n
                out = out.narrow(d, k * size, size)
        return out

    def gather(self, i: int, local):
        """Leaf ``i``'s global tensor from every rank's slice (collective
        over ``group`` for a data-sharded leaf, then over ``mgroup`` for a
        model-sharded one)."""
        d, md = self.dims[i], self.mdims[i]
        out = local if d is None else gather_dim(local, d, self.group)
        return out if md is None else gather_dim(out, md, self.mgroup)


def data_index(mesh, data_axes, rank: int) -> int:
    """Global ``rank``'s place along ``data_axes`` (row-major over them):
    the shard of a dim sharded over those axes that it holds."""
    coords = mesh.coords(rank)
    axes = _entry_axes(data_axes)
    return int(np.ravel_multi_index([coords[a] for a in axes],
                                    [mesh.shape[a] for a in axes]))


def shard_layout(shapes, specs, mesh, data_axes, rank: int, group=None, *,
                 model_axis=None, mgroup=None):
    """The :class:`ShardLayout` of global rank ``rank`` for leaves of
    ``shapes`` under ``specs`` (``param_pspecs``' leaves in order)."""
    axes = _entry_axes(data_axes)
    M = model_size(mesh, model_axis)
    return ShardLayout(
        shapes=tuple(tuple(s) for s in shapes),
        dims=tuple(data_dim(s, axes) for s in specs),
        W=_axis_size(mesh, axes), index=data_index(mesh, axes, rank),
        group=group,
        mdims=tuple(data_dim(s, model_axis) if M > 1 else None
                    for s in specs),
        M=M, mindex=mesh.coords(rank)[model_axis] if M > 1 else 0,
        mgroup=mgroup)
