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


def flash_decode_attention(q, k_shard, v_shard, pos, *, group=None,
                           total_len, window=None):
    """q: (B, 1, H, hd), the same on every rank; k/v_shard: (B, L_loc,
    KV, hd), this rank's slice of a ring buffer of global length
    ``total_len`` laid out contiguously over the ranks of ``group``.
    Returns (B, 1, H, hd), the same on every rank."""
    B, L_loc, KV, hd = k_shard.shape
    H = q.shape[2]
    G = H // KV
    base = dist.get_rank(group) * L_loc
    slots = base + torch.arange(L_loc, device=q.device)  # global slot ids
    valid = ring_valid(pos, B, slots, total_len, window)

    qg = q.reshape(B, KV, G, hd)
    s = torch.stack([bmm_f32(qg[:, j], k_shard[:, :, j].transpose(1, 2))
                     for j in range(KV)], dim=2) / (hd ** 0.5)  # (B,G,KV,L)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)

    m_loc = torch.amax(s, dim=-1)                        # (B, G, KV)
    p = torch.exp(s - m_loc[..., None])
    l_loc = torch.sum(p, dim=-1)
    p = p.to(v_shard.dtype)
    acc_loc = torch.stack([bmm_f32(p[:, :, j], v_shard[:, :, j])
                           for j in range(KV)], dim=1)   # (B, KV, G, hd)

    m = m_loc.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_loc - m)
    l = l_loc * corr
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    acc = acc_loc * corr[..., None].transpose(1, 2)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    out = acc / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)
