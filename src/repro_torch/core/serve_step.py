"""Serving steps (``repro.core.serve_step``): prefill and single-token
decode, on one device or over a data mesh.

The reference jits both under a mesh with explicit shardings and donates
the cache to decode.  The port runs them eagerly on the model's device:
the model holds its parameters, so neither step takes them, and decode
writes the cache in place (what donation buys the reference).
``make_inputs`` gives tensors on the ``meta`` device, which allocate
nothing, for the dry-run.

Over a mesh (``mesh``, one process a rank of ``group``): the parameters
are replicated (``param_shardings``; a model axis larger than 1 raises
``NotImplementedError``) and the cache is laid out by
``core.sharding.cache_pspecs``, as in the reference:

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

Every step's inputs and outputs are the rank's local shards.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import flash_decode, sharding
from repro_torch.models import kvquant
from repro_torch.models.params import global_tree
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

    def attend(self, q, k, v, leaf, gleaf, pos, window, kv_quant):
        payload = leaf["k"]["q"] if kv_quant else leaf["k"]
        whole = gleaf["k"]["q"] if kv_quant else gleaf["k"]
        d = _sharded_dim(payload, whole)
        if d is None:
            return WHOLE_CACHE.attend(q, k, v, leaf, gleaf, pos, window,
                                      kv_quant)
        if d != 1:
            raise NotImplementedError(
                f"a ring buffer {tuple(whole.shape)} sharded on dim {d}, "
                "not on its slots")
        kw = dict(total_len=whole.shape[1], shard=self.index)
        if kv_quant:
            for name, val in (("k", k), ("v", v)):
                qv, sv = kvquant.quantize_kv(val)
                flash_decode.write_ring_shard(leaf[name]["q"], qv, pos, **kw)
                flash_decode.write_ring_shard(leaf[name]["scale"], sv, pos,
                                              **kw)
            return flash_decode.flash_decode_attention_quant(
                q, leaf["k"], leaf["v"], pos, group=self.group,
                window=window, **kw)
        flash_decode.write_ring_shard(leaf["k"], k, pos, **kw)
        flash_decode.write_ring_shard(leaf["v"], v, pos, **kw)
        return flash_decode.flash_decode_attention(
            q, leaf["k"], leaf["v"], pos, group=self.group, window=window,
            **kw)

    def attend_all(self, q, enc, genc):
        d = _sharded_dim(enc["k"], genc["k"])
        if d is None:
            return WHOLE_CACHE.attend_all(q, enc, genc)
        if d != 1:
            raise NotImplementedError(
                f"encoder k/v {tuple(genc['k'].shape)} sharded on dim {d}, "
                "not on its positions")
        total = genc["k"].shape[1]
        return flash_decode.flash_decode_attention(
            q, enc["k"], enc["v"], total - 1, group=self.group,
            total_len=total, shard=self.index)


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


def build_serve_step(model, mesh=None, *, group=None, data_axes=("data",),
                     model_axis=None, batch_size: int, cache_len: int,
                     swa_variant: bool = False) -> ServeStep:
    """Prefill and decode for ``model``; with ``mesh`` (a
    ``launch.mesh.Mesh`` whose ``data_axes`` span the ranks of
    ``group``), over the data mesh as the module docstring says."""
    cfg = model.cfg
    prefill = functools.partial(model.prefill, cache_len=cache_len,
                                swa_variant=swa_variant)
    meta = torch.device("meta")
    param_sh = cache_sh = None
    local_rows = None
    B_loc = batch_size
    shard = None
    if mesh is not None:
        sharding.require_no_tp(mesh, model_axis)
        W = sharding._axis_size(mesh, data_axes)
        if W != dist.get_world_size(group):
            raise ValueError(f"data axes {data_axes} span {W} ranks, the "
                             f"group {dist.get_world_size(group)}")
        model.param_hook = None
        rank = dist.get_rank()
        param_sh = sharding.shardings(sharding.param_pspecs(
            global_tree(model), mesh, fsdp=False, data_axes=data_axes,
            model_axis=model_axis), mesh)
        dp = data_axes if len(data_axes) > 1 else data_axes[0]
        batch_shardable = batch_size % W == 0
        gcache = model.init_cache(batch_size, cache_len,
                                  swa_variant=swa_variant, device=meta)
        specs = sharding.cache_pspecs(
            gcache, mesh, batch_axes=dp, model_axis=model_axis,
            shard_seq=not batch_shardable)
        if batch_shardable:
            specs["tail"] = [sharding._map_with_path(
                lambda _, t: sharding.PSpec(dp, *[None] * (t.dim() - 1)),
                leaf) for leaf in gcache["tail"]]
        cache_sh = sharding.shardings(specs, mesh)
        index = sharding.data_index(mesh, data_axes, rank)
        if batch_shardable:
            B_loc = batch_size // W

            def local_rows(x):
                return x[index * B_loc:(index + 1) * B_loc]
        else:
            shard = SeqShard(gcache, group, W, index)

            def local_rows(x):
                return x

            def prefill(batch):
                logits, cache = model.prefill(batch, cache_len=cache_len,
                                              swa_variant=swa_variant)
                return logits, _map_tree(
                    lambda t, sh: sh.shard(t, rank).clone(), cache,
                    cache_sh)

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
