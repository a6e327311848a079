"""Context-parallel decode attention, flash-decoding
(``repro.core.flash_decode``; beyond the paper).

For ``long_500k`` (batch 1) the KV cache is split over ranks along its
sequence dimension.  Each rank attends to its own contiguous shard and the
ranks combine the partial softmaxes exactly:

    per shard:   local scores  -> local max m_i, sum l_i, weighted acc_i
    combine:     m = max_i m_i;  l = sum_i l_i * exp(m_i - m)
                 out = sum_i acc_i * exp(m_i - m) / l

The reference runs this inside a ``shard_map`` (``pmax``/``psum`` over a
mesh axis, the shard index from ``axis_index``); the port runs one
process per shard and combines with ``torch.distributed.all_reduce``
(MAX, then SUM) over ``group``, the shard index being the rank in it.
Wire bytes are O(B * H * hd) a step instead of the O(L * KV * hd) of
gathering the cache.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.attention import NEG_INF, bmm_f32, ring_valid


def _combine(s, acc_of, group, B, H, hd, dtype):
    """The exact distributed softmax of masked scores ``s`` (B, G, KV,
    L_loc): ``acc_of(p)`` gives the local weighted sum (B, KV, G, hd) of
    the unnormalised weights p."""
    m_loc = torch.amax(s, dim=-1)                        # (B, G, KV)
    p = torch.exp(s - m_loc[..., None])
    l_loc = torch.sum(p, dim=-1)
    acc_loc = acc_of(p)

    m = m_loc.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_loc - m)
    l = l_loc * corr
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    acc = acc_loc * corr[..., None].transpose(1, 2)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    out = acc / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.reshape(B, 1, H, hd).to(dtype)


def _valid(q, pos, B, L_loc, total_len, window, group, shard):
    shard = dist.get_rank(group) if shard is None else shard
    slots = shard * L_loc + torch.arange(L_loc, device=q.device)
    return ring_valid(pos, B, slots, total_len, window)


def flash_decode_attention(q, k_shard, v_shard, pos, *, group=None,
                           total_len, window=None, shard=None,
                           head_dim=None, partial=None):
    """q: (B, 1, H, hd), the same on every rank; k/v_shard: (B, L_loc,
    KV, hd), slice ``shard`` (by default the rank in ``group``) of a ring
    buffer of global length ``total_len`` laid out contiguously over the
    ranks of ``group``.  Returns (B, 1, H, hd), the same on every rank.
    ``head_dim`` and ``partial`` as in ``attention.decode_attention`` (a
    slice that is also sharded on head_dim, over another group)."""
    B, L_loc, KV, hd = k_shard.shape
    H = q.shape[2]
    G = H // KV
    valid = _valid(q, pos, B, L_loc, total_len, window, group, shard)
    qg = q.reshape(B, KV, G, hd)
    s = torch.stack([bmm_f32(qg[:, j], k_shard[:, :, j].transpose(1, 2))
                     for j in range(KV)], dim=2) / ((head_dim or hd) ** 0.5)
    if partial is not None:
        s = partial(s)                                          # (B,G,KV,L)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)

    def acc_of(p):
        p = p.to(v_shard.dtype)
        return torch.stack([bmm_f32(p[:, :, j], v_shard[:, :, j])
                            for j in range(KV)], dim=1)  # (B, KV, G, hd)
    return _combine(s, acc_of, group, B, H, hd, q.dtype)


def flash_decode_attention_quant(q, k_shard, v_shard, pos, *, group=None,
                                 total_len, window=None, shard=None,
                                 head_dim=None, partial=None):
    """``flash_decode_attention`` over int8 cache slices (``{"q": int8,
    "scale": fp16}`` per k and v, ``models.kvquant``): the scales fold
    into the fp32 scores and weights, as ``attention.
    decode_attention_quant`` does over a whole cache."""
    kq, ks = k_shard["q"], k_shard["scale"]
    vq, vs = v_shard["q"], v_shard["scale"]
    B, L_loc, KV, hd = kq.shape
    H = q.shape[2]
    G = H // KV
    valid = _valid(q, pos, B, L_loc, total_len, window, group, shard)
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,blkh->bgkl", qg, kq.float()) / \
        ((head_dim or hd) ** 0.5)
    if partial is not None:
        s = partial(s)
    s = s * ks[..., 0].float().transpose(1, 2)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)

    def acc_of(p):
        pv = p * vs[..., 0].float().transpose(1, 2)[:, None]
        return torch.einsum("bgkl,blkh->bkgh", pv, vq.float())
    return _combine(s, acc_of, group, B, H, hd, q.dtype)


def write_ring_shard(cache, new, pos, *, total_len, shard):
    """Writes (B, 1, ...) ``new`` into slice ``shard`` (B, L_loc, ...) of a
    ring buffer of global length ``total_len`` at slot ``pos %
    total_len``, in place, where that slot lies in the slice (a scalar
    ``pos``, or (B,) per-row positions); elsewhere the slice is unchanged.
    No host sync: the owner test is a select on the device."""
    L_loc = cache.shape[1]
    pos = torch.as_tensor(pos, device=cache.device)
    slot = torch.remainder(pos.long().reshape(-1), total_len) - shard * L_loc
    own = (slot >= 0) & (slot < L_loc)
    slot = slot.clamp(0, L_loc - 1)
    new = new.to(cache.dtype)
    if pos.dim() == 0:
        keep = own.reshape((1, 1) + (1,) * (new.dim() - 2))
        cache.index_copy_(1, slot, torch.where(keep, new,
                                               cache.index_select(1, slot)))
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        keep = own.reshape((-1,) + (1,) * (new.dim() - 2))
        cache[rows, slot] = torch.where(keep, new[:, 0], cache[rows, slot])
    return cache
