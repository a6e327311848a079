"""Serving steps (``repro.core.serve_step``): prefill and single-token
decode, on one device or over a data mesh.

The reference jits both under a mesh with explicit shardings and donates
the cache to decode.  The port runs them eagerly on the model's device:
the model holds its parameters, so neither step takes them, and decode
writes the cache in place (what donation buys the reference).
``make_inputs`` gives tensors on the ``meta`` device, which allocate
nothing, for the dry-run.

Over a mesh (``mesh``, one process a rank): the parameters are laid out
by ``param_shardings`` (``core.sharding.param_pspecs`` at ``fsdp=False``:
replicated over the data axes, sliced over a model axis larger than 1,
which is tensor parallelism, ``models.tp``) and the
cache by ``core.sharding.cache_pspecs``, as in the reference:

* batch-sharded, where the batch divides over the W ranks of the data
  axes: each rank holds B/W rows of every leaf (its rows of the global
  batch, ``local_rows``) and runs prefill and decode on them alone.  The
  reference's ``cache_pspecs`` takes a ``tail`` leaf for a stacked one
  and names its dim 1 for the batch; the port keeps a tail leaf's rows
  too, so ``cache_shardings`` puts the batch at dim 0 there;
* sequence-sharded otherwise (``long_500k``'s batch 1): every rank holds
  the whole batch and the 1/W slice of each leaf that ``cache_pspecs``
  names (a ring buffer's slots, a recurrent state's width, ``enc_kv``'s
  encoder positions).  Prefill computes the whole
  prompt and keeps each rank's slice; decode writes a token's k and v on
  the rank that owns slot ``pos % L`` and attends through flash-decode
  (``core.flash_decode``), which combines the ranks' partial softmaxes
  exactly, and gathers a sharded recurrent state for the step.

Under tensor parallelism each rank of a model group holds the same rows
and its slice of every ring along the model axis: its kv heads where M
divides them, else its slice of head_dim (and an int8 scale's slots
where they divide), else its range of the slots.  Prefill fills that
slice directly; decode computes every head (one all-reduce for q, k and
v) and :class:`TpCache` hands the inner cache operations (the whole
cache's or ``SeqShard``'s) this rank's heads, or its head_dim slice with
the scores summed over the model group, and gathers the output over it;
a ring cut on its slots goes through flash-decode over the model group,
as a sequence-sharded one does over the data group.  Logits come back
whole.

Every step's inputs and outputs are the rank's local shards (the logits
whole).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import flash_decode, sharding
from repro_torch.launch.mesh import rank_groups
from repro_torch.models import attention, kvquant
from repro_torch.models.params import (global_shapes, global_tree,
                                       layout_of, shard_model)
from repro_torch.models.tp import TensorParallel
from repro_torch.models.transformer import WHOLE_CACHE


@dataclasses.dataclass
class ServeStep:
    prefill_fn: Callable      # batch -> (last-token logits, cache)
    decode_fn: Callable       # (token, cache, pos) -> (logits, cache)
    make_inputs: Callable     # (shape_kind, seq_len) -> meta inputs
    param_shardings: Any = None
    cache_shardings: Any = None
    local_rows: Callable = None   # global batch tensor -> this rank's rows


class SeqShard:
    """The decode step's cache operations on this rank's slice of a
    sequence-sharded cache (``Model.decode_step(..., shard=)``);
    ``cache`` is the global cache on the ``meta`` device, for the global
    lengths."""

    def __init__(self, cache, group, W: int, index: int):
        self.cache, self.group, self.W, self.index = cache, group, W, index

    def gather(self, leaf, gleaf):
        """A recurrent state's leaves whole (the sharded ones gathered
        along their sharded dim)."""
        out = {}
        for k, t in leaf.items():
            d = _sharded_dim(t, gleaf[k])
            out[k] = t if d is None else sharding.gather_dim(t, d,
                                                             self.group)
        return out

    def keep(self, val, local):
        """This rank's slice of a whole state leaf ``val``."""
        d = _sharded_dim(local, val)
        if d is None:
            return val
        n = local.shape[d]
        return val.narrow(d, self.index * n, n)

    def attend(self, q, k, v, leaf, gleaf, pos, window, kv_quant, *,
               head_dim=None, partial=None, quantized=None):
        payload = leaf["k"]["q"] if kv_quant else leaf["k"]
        whole = gleaf["k"]["q"] if kv_quant else gleaf["k"]
        extra = dict(head_dim=head_dim, partial=partial)
        d = _sharded_dim(payload, whole)
        if d is None:
            return WHOLE_CACHE.attend(q, k, v, leaf, gleaf, pos, window,
                                      kv_quant, quantized=quantized, **extra)
        if d != 1:
            raise NotImplementedError(
                f"a ring buffer {tuple(whole.shape)} sharded on dim {d}, "
                "not on its slots")
        return ring_attend(q, k, v, leaf, pos, window, kv_quant,
                           group=self.group, index=self.index,
                           total_len=whole.shape[1], quantized=quantized,
                           **extra)

    def attend_all(self, q, enc, genc, **extra):
        d = _sharded_dim(enc["k"], genc["k"])
        if d is None:
            return WHOLE_CACHE.attend_all(q, enc, genc, **extra)
        if d != 1:
            raise NotImplementedError(
                f"encoder k/v {tuple(genc['k'].shape)} sharded on dim {d}, "
                "not on its positions")
        total = genc["k"].shape[1]
        return flash_decode.flash_decode_attention(
            q, enc["k"], enc["v"], total - 1, group=self.group,
            total_len=total, shard=self.index, **extra)


def ring_attend(q, k, v, leaf, pos, window, kv_quant, *, group, index,
                total_len, quantized=None, **extra):
    """Decode attention on slice ``index`` (B, L_loc, KV, hd) of a ring of
    ``total_len`` slots laid end to end over the ranks of ``group``: the
    slot's owner writes the token's k and v (``quantized``: its int8
    entries, as ``WHOLE_CACHE.attend``), every rank attends its slots with
    every query head, and flash-decode combines the partial softmaxes
    over ``group``; the output is whole on every rank."""
    kw = dict(total_len=total_len, shard=index)
    if kv_quant:
        if quantized is None:
            quantized = (*kvquant.quantize_kv(k), *kvquant.quantize_kv(v))
        for name, (qv, sv) in zip("kv", (quantized[:2], quantized[2:])):
            flash_decode.write_ring_shard(leaf[name]["q"], qv, pos, **kw)
            flash_decode.write_ring_shard(leaf[name]["scale"], sv, pos, **kw)
        return flash_decode.flash_decode_attention_quant(
            q, leaf["k"], leaf["v"], pos, group=group, window=window, **kw,
            **extra)
    flash_decode.write_ring_shard(leaf["k"], k, pos, **kw)
    flash_decode.write_ring_shard(leaf["v"], v, pos, **kw)
    return flash_decode.flash_decode_attention(
        q, leaf["k"], leaf["v"], pos, group=group, window=window, **kw,
        **extra)


class TpCache:
    """The decode step's cache operations under tensor parallelism: q, k
    and v arrive with every head (the same on every rank of the model
    group ``tp``), the ring holds this rank's slice along the model axis,
    and ``inner`` (``WHOLE_CACHE`` or a ``SeqShard``, whose ``cache`` then
    has the model-local shapes) runs on that slice.  Kv heads: the rank's
    heads of q, k and v, the output gathered over the heads.  head_dim:
    the rank's slice of each, the scores summed over the group
    (``partial``), the output gathered over head_dim; int8 entries are
    quantized over the whole head_dim first, and a scale whose slots are
    sharded over the group is written by its owner and gathered.  Slots
    (a ring of ``cache_len``, or of the window, whose kv heads and
    head_dim do not divide over the group): every query head against the
    rank's slots, flash-decode over the group (``ring_attend``), the
    output whole.  An encoder-decoder's ``enc_kv`` goes the same three
    ways (``attend_all``).  A recurrent state passes through ``inner`` in
    the model axis's layout, which the layer's own step reads
    (``rwkv6.rwkv_decode_step``, ``rglru.rglru_decode_step``)."""

    def __init__(self, inner, tp, cfg, cache_len):
        self.inner, self.tp, self.cfg = inner, tp, cfg
        self.cache_len = cache_len
        self.cache = getattr(inner, "cache", None)

    def _slots_cut(self, local, glocal, n):
        """Whether the model axis cut the slots (dim 1) of ``local``, a
        ring or encoder k/v of ``n`` slots (``glocal``: its leaf in
        ``inner``'s cache, the model-local shapes, or None).  The data
        axes never cut them beside it: ``cache_pspecs`` gives a ring's
        slots to the data axes first, and the model axis then skips
        them."""
        cut = (local if glocal is None else glocal).shape[1] < n
        assert not cut or local.shape[1] * self.tp.size == n, (
            f"slots {tuple(local.shape)} of {n} cut beyond the model axis")
        return cut

    def _partial(self, s):
        s = s.contiguous()
        dist.all_reduce(s, group=self.tp.group)
        return s

    def gather(self, leaf, gleaf):
        return self.inner.gather(leaf, gleaf)

    def keep(self, val, local):
        return self.inner.keep(val, local)

    def attend_all(self, q, enc, genc):
        """q (every head) against this rank's slice of the encoder's k and
        v: its kv heads, its range of the positions (flash-decode over
        the group), or its head_dim slice with the scores summed over the
        group."""
        tp, cfg = self.tp, self.cfg
        if enc["k"].shape[2] < cfg.n_kv_heads:
            o = self.inner.attend_all(tp.slice(q, 2), enc, genc)
            return sharding.gather_dim(o, 2, tp.group)
        gk = None if genc is None else genc["k"]
        if self._slots_cut(enc["k"], gk, cfg.encoder_seq):
            return flash_decode.flash_decode_attention(
                q, enc["k"], enc["v"], cfg.encoder_seq - 1, group=tp.group,
                total_len=cfg.encoder_seq, shard=tp.index)
        if enc["k"].shape[3] == cfg.head_dim:
            return self.inner.attend_all(q, enc, genc)
        o = self.inner.attend_all(tp.slice(q, 3), enc, genc,
                                  head_dim=cfg.head_dim,
                                  partial=self._partial)
        return sharding.gather_dim(o, 3, tp.group)

    def attend(self, q, k, v, leaf, gleaf, pos, window, kv_quant):
        tp, cfg = self.tp, self.cfg
        payload = leaf["k"]["q"] if kv_quant else leaf["k"]
        if payload.shape[2] < cfg.n_kv_heads:
            q, k, v = (tp.slice(t, 2) for t in (q, k, v))
            o = self.inner.attend(q, k, v, leaf, gleaf, pos, window,
                                  kv_quant)
            return sharding.gather_dim(o, 2, tp.group)
        if payload.shape[3] == cfg.head_dim:
            L = self.cache_len if window is None else min(window,
                                                          self.cache_len)
            gpay = None if gleaf is None else \
                gleaf["k"]["q"] if kv_quant else gleaf["k"]
            if self._slots_cut(payload, gpay, L):
                return ring_attend(q, k, v, leaf, pos, window, kv_quant,
                                   group=tp.group, index=tp.index,
                                   total_len=L)
            return self.inner.attend(q, k, v, leaf, gleaf, pos, window,
                                     kv_quant)
        kw = dict(head_dim=cfg.head_dim, partial=self._partial)
        ql = tp.slice(q, 3)
        if not kv_quant:
            o = self.inner.attend(ql, tp.slice(k, 3), tp.slice(v, 3), leaf,
                                  gleaf, pos, window, False, **kw)
            return sharding.gather_dim(o, 3, tp.group)
        (qk, sk), (qv, sv) = kvquant.quantize_kv(k), kvquant.quantize_kv(v)
        if leaf["k"]["scale"].shape[1] == payload.shape[1]:
            o = self.inner.attend(
                ql, None, None, leaf, gleaf, pos, window, True,
                quantized=(tp.slice(qk, 3), sk, tp.slice(qv, 3), sv), **kw)
            return sharding.gather_dim(o, 3, tp.group)
        # the scales' slots over the model axis (a ring held whole over the
        # data axes): the owner writes, every rank reads them all
        L = payload.shape[1]
        whole = {}
        for name, (qn, sn) in (("k", (qk, sk)), ("v", (qv, sv))):
            attention.write_slots(leaf[name]["q"], tp.slice(qn, 3), pos)
            flash_decode.write_ring_shard(leaf[name]["scale"], sn, pos,
                                          total_len=L, shard=tp.index)
            whole[name] = {"q": leaf[name]["q"], "scale": sharding.gather_dim(
                leaf[name]["scale"], 1, tp.group)}
        o = attention.decode_attention_quant(ql, whole["k"], whole["v"], pos,
                                             window=window, **kw)
        return sharding.gather_dim(o, 3, tp.group)


def _sharded_dim(local, whole):
    """The dim where a rank's slice is shorter than the whole leaf (None:
    held whole)."""
    for d, (a, b) in enumerate(zip(local.shape, whole.shape)):
        if a != b:
            return d
    return None


def _map_tree(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map_tree(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)) and not isinstance(t, sharding.PSpec):
        return [_map_tree(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _drop_axes(spec, axes):
    """``spec`` with every entry that names one of ``axes`` replicated."""
    axes = set(sharding._entry_axes(axes))
    return sharding.PSpec(*(None if e is not None and axes & set(
        sharding._entry_axes(e)) else e for e in spec))


def _empty(tree, shardings, device, zeros=True):
    """Tensors of ``tree``'s leaves at the local shapes of ``shardings``."""
    make = torch.zeros if zeros else torch.empty
    return _map_tree(lambda t, sh: make(sh.shard_shape(t.shape),
                                        dtype=t.dtype, device=device),
                     tree, shardings)


def build_serve_step(model, mesh=None, *, group=None, data_axes=("data",),
                     model_axis=None, batch_size: int, cache_len: int,
                     swa_variant: bool = False) -> ServeStep:
    """Prefill and decode for ``model``; with ``mesh`` (a
    ``launch.mesh.Mesh`` whose ``data_axes`` span the ranks of ``group``,
    or, with a ``model_axis`` above 1, the groups this makes from the
    mesh: every rank builds at once), over the mesh as the module
    docstring says.  Without tensor parallelism a model that holds slices
    of its parameters gathers them first (collective)."""
    cfg = model.cfg
    prefill = functools.partial(model.prefill, cache_len=cache_len,
                                swa_variant=swa_variant)
    meta = torch.device("meta")
    param_sh = cache_sh = None
    local_rows = None
    B_loc = batch_size
    shard = None
    tp = None
    M = 1 if mesh is None else sharding.model_size(mesh, model_axis)
    if M == 1 and layout_of(model) is not None:
        shard_model(model, None)
    model.batch_group = None
    if mesh is not None:
        sharding.require_tp_family(cfg, mesh, model_axis)
        mgroup = None
        if M > 1:
            if group is not None:
                raise ValueError("with a model axis the serve step makes "
                                 "its data and model groups from the mesh")
            group, mgroup = rank_groups(mesh, data_axes, model_axis)
        W = sharding._axis_size(mesh, data_axes)
        if W != dist.get_world_size(group):
            raise ValueError(f"data axes {data_axes} span {W} ranks, the "
                             f"group {dist.get_world_size(group)}")
        model.param_hook = None
        rank = dist.get_rank()
        pspecs = sharding.param_pspecs(
            global_tree(model), mesh, fsdp=False, data_axes=data_axes,
            model_axis=model_axis)
        param_sh = sharding.shardings(pspecs, mesh)
        if M > 1:
            layout = sharding.shard_layout(
                global_shapes(model), sharding.tree_leaves(pspecs), mesh,
                data_axes, rank, group, model_axis=model_axis, mgroup=mgroup)
            shard_model(model, layout)
            tp = TensorParallel(mgroup, M, layout.mindex)
        dp = data_axes if len(data_axes) > 1 else data_axes[0]
        batch_shardable = batch_size % W == 0
        gcache = model.init_cache(batch_size, cache_len,
                                  swa_variant=swa_variant, device=meta)
        specs = sharding.cache_pspecs(
            gcache, mesh, batch_axes=dp, model_axis=model_axis,
            shard_seq=not batch_shardable)
        if batch_shardable:
            # a tail leaf's rows, and its model entry as the reference's
            specs["tail"] = [sharding._map_with_path(
                lambda _, sp: sharding.PSpec(
                    dp, *_drop_axes(sp, data_axes)[1:]), leaf,
                is_leaf=sharding._is_spec) for leaf in specs["tail"]]
        cache_sh = sharding.shardings(specs, mesh)
        # the model axis alone: a rank's cache before the data axes cut it
        model_sh = sharding.shardings(_map_tree(
            lambda sp: _drop_axes(sp, data_axes), specs), mesh)
        index = sharding.data_index(mesh, data_axes, rank)
        if batch_shardable:
            B_loc = batch_size // W
            # the reference's MoE routes the whole batch (its capacity
            # and each expert's places), not a rank's rows
            model.batch_group = group if W > 1 else None

            def local_rows(x):
                return x[index * B_loc:(index + 1) * B_loc]

            if tp is not None:
                def prefill(batch):
                    return model.prefill(
                        batch, cache_len=cache_len, swa_variant=swa_variant,
                        cache=_empty(gcache, cache_sh,
                                     batch["tokens"].device))
        else:
            shard = SeqShard(_empty(gcache, model_sh, meta, zeros=False),
                             group, W, index)
            data_sh = sharding.shardings(_map_tree(
                lambda sp: _drop_axes(sp, model_axis), specs), mesh)

            def local_rows(x):
                return x

            def prefill(batch):
                cache = None if tp is None else _empty(
                    gcache, model_sh, batch["tokens"].device)
                logits, cache = model.prefill(batch, cache_len=cache_len,
                                              swa_variant=swa_variant,
                                              cache=cache)
                return logits, _map_tree(
                    lambda t, sh: sh.shard(t, rank).clone(), cache, data_sh)
    model.tp = tp
    if tp is not None:
        shard = TpCache(WHOLE_CACHE if shard is None else shard, tp, cfg,
                        cache_len)

    def decode(token, cache, pos):
        return model.decode_step(token, cache, pos, swa_variant=swa_variant,
                                 shard=shard)

    def make_inputs(shape_kind: str, seq_len: int):
        """Meta tensors of the step's inputs at this rank's local shapes:
        ``{"tokens": (B, seq_len)}`` (with a VLM's ``patch_emb`` (B,
        n_patches, d) and an encoder-decoder's ``frames`` (B,
        encoder_seq, d) in the model dtype) for ``"prefill"``, else
        (token (B, 1), the cache, pos ()), every id and position int32 as
        in the reference; B is the rank's rows."""
        B = B_loc
        if shape_kind == "prefill":
            batch = {"tokens": torch.empty((B, seq_len), dtype=torch.int32,
                                           device=meta)}
            dtype = getattr(torch, cfg.dtype)
            if cfg.family == "vlm":
                batch["patch_emb"] = torch.empty(
                    (B, cfg.n_patches, cfg.d_model), dtype=dtype, device=meta)
            if cfg.is_encoder_decoder:
                batch["frames"] = torch.empty(
                    (B, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                    device=meta)
            return batch
        token = torch.empty((B, 1), dtype=torch.int32, device=meta)
        cache = model.init_cache(batch_size, cache_len,
                                 swa_variant=swa_variant, device=meta)
        if cache_sh is not None:
            cache = _map_tree(lambda t, sh: torch.empty(
                sh.shard_shape(t.shape), dtype=t.dtype, device=meta),
                cache, cache_sh)
        return token, cache, torch.empty((), dtype=torch.int32, device=meta)

    return ServeStep(prefill_fn=prefill, decode_fn=decode,
                     make_inputs=make_inputs, param_shardings=param_sh,
                     cache_shardings=cache_sh, local_rows=local_rows)
