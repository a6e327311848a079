"""Tensor parallelism over a model-parallel process group: the reference's
``model`` mesh axis, which XLA's auto-partitioner carries there
(``param_pspecs`` places it on a leaf's widest dim; inside the train
step's ``shard_map`` the axis stays *auto*).  The port spells the
collectives out, as ``autograd.Function``\\ s around plain products and
the hand-written kernels.

Activations are replicated over the model group between sub-layers.  A
rank holds the slice ``index`` of each model-sharded leaf (the dim that
``core.sharding.param_pspecs`` names), and a layer reads it by shape:

* a weight ``(in, out)`` sharded on ``in`` is a row-parallel linear: ``y =
  all_reduce(x[..., mine] @ w)``; backward ``dW = x_mineᵀ·dy`` and ``dx =
  all_gather(dy @ wᵀ)``, since x is replicated;
* sharded on ``out``, a column-parallel linear: ``y_mine = x @ w``,
  backward ``dx = all_reduce(dy_mine @ wᵀ)``; a gated MLP is column,
  local gate, row, with no gather between;
* a leaf used whole (a norm scale, a bias over gathered heads) is
  all-gathered; its backward keeps the rank's own slice of the gradient,
  which every rank computes alike from replicated activations (a
  reduce-scatter would multiply it by M);
* the vocab-parallel embedding looks up the rank's rows, zeroes the ids
  outside them and all-reduces; the vocab-parallel cross-entropy
  all-reduces the max, then the sum of exps and the label's logit.

A recurrent layer (RWKV6's time-mix, the RG-LRU) keeps its channels
sharded between its projections: row-parallel products of this rank's
slice of the input features end in a reduce-scatter onto this rank's
slice of the output channels (``scatter_rows``), the channel-wise work
runs on that slice, and the row-parallel output projection all-reduces
once.

The four primitives (Megatron-LM's f, g and their split / gather pair):
``copy`` (forward identity, backward all-reduce: a replicated tensor that
ranks consume differently), ``reduce`` (forward all-reduce, backward
identity), ``split`` (forward the rank's slice, backward all-gather) and
``gather`` (forward all-gather, backward the rank's slice); and
``reduce_scatter`` (forward a sum's slice, backward all-gather).
Collectives run in the tensor's dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x, dim, group, M):
    """The ranks' ``x`` laid end to end along ``dim``."""
    dim = dim % x.dim()
    x = x.contiguous()
    out = x.new_empty((M,) + tuple(x.shape))
    dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
    return out.movedim(0, dim).reshape(
        *x.shape[:dim], M * x.shape[dim], *x.shape[dim + 1:])


def _chunk(x, dim, M, index):
    n = x.shape[dim] // M
    return x.narrow(dim, index * n, n).contiguous()


def _reduce_scatter(x, dim, group, M):
    """This rank's 1/M slice along ``dim`` of the sum over ranks."""
    dim = dim % x.dim()
    n = x.shape[dim] // M
    chunks = x.reshape(*x.shape[:dim], M, n, *x.shape[dim + 1:])
    chunks = chunks.movedim(dim, 0).contiguous()
    out = chunks.new_empty(chunks.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), chunks.view(-1),
                               op=dist.ReduceOp.SUM, group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _chunk(x, dim, tp.size, tp.index)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return _all_gather(g, ctx.dim, tp.group, tp.size), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _all_gather(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return _chunk(g, ctx.dim, tp.size, tp.index), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _reduce_scatter(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return _all_gather(g, ctx.dim, tp.group, tp.size), None, None


class _VocabCrossEntropy(torch.autograd.Function):
    """Per token: the fp32 logsumexp over every rank's vocab columns (the
    padded ones included, as in the reference) minus the label's logit."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        lf = logits.float()
        V = lf.shape[-1]
        m = _all_reduce(lf.detach().amax(dim=-1), tp.group,
                        dist.ReduceOp.MAX)
        e = torch.exp(lf - m[..., None])
        local = labels.long() - tp.index * V
        own = (local >= 0) & (local < V)
        local = local.clamp(0, V - 1)
        gold = torch.gather(lf, -1, local[..., None])[..., 0] * own
        s, gold = _all_reduce(torch.stack([e.sum(dim=-1), gold]), tp.group)
        ctx.save_for_backward(e, s, local, own)
        ctx.dtype = logits.dtype
        return m + torch.log(s) - gold

    @staticmethod
    def backward(ctx, g):
        e, s, local, own = ctx.saved_tensors
        grad = e * (g / s)[..., None]
        grad.scatter_add_(-1, local[..., None], -(g * own)[..., None])
        return grad.to(ctx.dtype), None, None


class TensorParallel:
    """This rank's place in its model-parallel ``group``: ``size`` ranks
    (M), this one holding slice ``index`` of each model-sharded leaf."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def __repr__(self):
        return f"TensorParallel(size={self.size}, index={self.index})"

    # -- the primitives ----------------------------------------------------
    def copy(self, x):
        return _Copy.apply(x, self)

    def reduce(self, x):
        return _Reduce.apply(x, self)

    def split(self, x, dim):
        return _Split.apply(x, dim, self)

    def gather(self, x, dim):
        return _Gather.apply(x, dim, self)

    def reduce_scatter(self, x, dim):
        return _ReduceScatter.apply(x, dim, self)

    # -- leaves --------------------------------------------------------------
    def dim_of(self, t, shape):
        """The dim of ``t`` (this rank's slice of a leaf of global
        ``shape``) that is sharded over the group, None where it is held
        whole."""
        if tuple(t.shape) == tuple(shape):
            return None
        for d, (a, b) in enumerate(zip(t.shape, shape)):
            if a != b:
                if a * self.size != b:
                    break
                return d
        raise ValueError(f"a slice {tuple(t.shape)} of {tuple(shape)} "
                         f"over {self.size} ranks")

    def slice(self, t, dim):
        """This rank's slice of a replicated ``t`` along ``dim`` (no
        autograd: the serving path)."""
        return _chunk(t, dim, self.size, self.index)

    def slice_like(self, full, like):
        """This rank's slice of ``full`` along the dim where ``like`` (a
        cache leaf of the rank) is shorter, or ``full`` where it is not
        (no autograd: the serving path)."""
        d = self.dim_of(like, full.shape)
        return full if d is None else self.slice(full, d)

    def whole(self, t, shape):
        """A leaf used whole: gathered along its sharded dim; backward, the
        rank's own slice of the gradient."""
        d = self.dim_of(t, shape)
        return t if d is None else self.gather(t, d)

    def part(self, t, shape, dim):
        """This rank's slice along ``dim`` of a leaf of global ``shape``
        that a layer uses on this rank's slice of that dim only: the leaf
        as it is where it is sharded there; else split (from whole),
        whose backward gathers the slices' gradients."""
        d = self.dim_of(t, shape)
        if d == dim % len(shape):
            return t
        return self.split(self.whole(t, shape), dim)

    def scatter_rows(self, xls, ws):
        """This rank's slice of the output columns of each ``xls[i] @
        ws[i]``, where ``xls[i]`` is this rank's slice of a replicated
        input's features and ``ws[i]`` the matching rows of a row-parallel
        weight: the partial products packed into one reduce-scatter."""
        parts = [xl @ w for xl, w in zip(xls, ws)]
        lead, M = parts[0].shape[:-1], self.size
        packed = torch.cat([y.reshape(*lead, M, -1) for y in parts], dim=-1)
        out = self.reduce_scatter(packed, -2).squeeze(-2)
        return out.split([y.shape[-1] // M for y in parts], dim=-1)

    def linear(self, x, w, shape):
        """``x @ w`` for a replicated x and a weight of global ``shape``
        (in, out), replicated: row-parallel, column-parallel then
        gathered, or plain."""
        d = self.dim_of(w, shape)
        if d is None:
            return x @ w
        if d == 0:
            return self.reduce(self.split(x, -1) @ w)
        return self.gather(self.copy(x) @ w, -1)

    def embed(self, table, ids, shape):
        """Rows of a ``shape`` (V, d) table: vocab-parallel where the rows
        are sharded (ids outside this rank's rows give zeros before the
        all-reduce), gathered along d where the columns are."""
        d = self.dim_of(table, shape)
        if d is None:
            return F.embedding(ids, table)
        if d == 1:
            return self.gather(F.embedding(ids, table), -1)
        V = table.shape[0]
        local = ids.long() - self.index * V
        own = (local >= 0) & (local < V)
        rows = F.embedding(local.clamp(0, V - 1), table)
        return self.reduce(rows * own[..., None].to(rows.dtype))

    def unembed(self, table, x, shape):
        """``x @ table`` for a ``shape`` (d, V) head: this rank's vocab
        columns of the logits where the columns are sharded (see
        ``cross_entropy``), else the whole logits."""
        d = self.dim_of(table, shape)
        if d == 1:
            return self.copy(x) @ table
        return self.linear(x, table, shape)

    def cross_entropy(self, logits, labels):
        """Per-token cross-entropy of vocab-parallel ``logits`` (this
        rank's columns, ``unembed``'s output): fp32 logsumexp minus the
        label's logit, the same on every rank."""
        return _VocabCrossEntropy.apply(logits, labels, self)
