"""Attention (``repro.models.attention``): GQA projections and chunked
(flash-style) softmax attention with causal / sliding-window masking.

``chunked_attention`` is the reference's plain path: an online-softmax
forward over (q chunk, kv chunk) pairs and a two-pass chunked backward (dq
pass; dk/dv pass) in an ``autograd.Function``, so the backward never holds
O(S^2) residuals.  KV chunks that lie outside a query chunk's causal or
window span are skipped, so sliding-window attention does O(S * W) work.
When the call is causal over one sequence (Sq == Skv) and ``pallas_fn``
is given, the call goes to it instead (``kernels.ops.swa_attention``, the
Hopper kernel).

Layouts are the reference's: q (B, Sq, H, hd), k and v (B, Skv, KV, hd),
with head h reading kv head h // G (G = H // KV).  Score and gradient
products are fp32 (the reference's ``preferred_element_type``); the
forward casts p to v's dtype before the p.v product, as the reference
does.

Decode attention (one new token against a ring-buffer KV cache) is the
reference's plain einsum form, not a TPU kernel: scores in fp32 from the
cache's dtype, masked with ``NEG_INF`` and a softmax over every slot, p
cast to the cache's dtype for an fp32-accumulated p.v product.  The
products run one kv head at a time (``torch.bmm`` on strided views of the
(B, L, KV, hd) cache, so no copy of the cache is made); a bf16 cache on
the card accumulates in fp32 through ``out_dtype``.  ``cache_update``
writes the new entries into the cache in place (the reference donates the
cache to its decode step, so XLA writes one slot in place too).

Under tensor parallelism (``tp``, ``models.tp``) the projections read
this rank's slices of wq, wk and wv (row-parallel over d: one collective
for the three): where M divides the query heads each rank keeps its H/M
heads (a reduce-scatter over the heads; k and v too where M divides the
kv heads, else whole, and ``heads_for`` narrows them to the kv heads
those queries read),
otherwise every rank holds every head (an all-reduce).  ``attention_out``
applies wo to either.  The decode functions take the global ``head_dim``
and a ``partial`` hook for a cache sharded on head_dim: the scores are
then partial dot products, summed over the model group by ``partial``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def attention_init(gen, cfg, dtype, lead=()):
    """``lead`` prepends a stacking dim (the layers of a scanned block)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": layers.dense_init(gen, (*lead, d, H * hd), dtype),
         "wk": layers.dense_init(gen, (*lead, d, KV * hd), dtype),
         "wv": layers.dense_init(gen, (*lead, d, KV * hd), dtype),
         "wo": layers.dense_init(gen, (*lead, H * hd, d), dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, H * hd), dtype=dtype)
        p["bk"] = torch.zeros((*lead, KV * hd), dtype=dtype)
        p["bv"] = torch.zeros((*lead, KV * hd), dtype=dtype)
    return p


def project_qkv(p, x, cfg, tp=None, head_local=True):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd); under ``tp`` (see
    the module docstring) q may hold this rank's H/M heads and k/v this
    rank's KV/M heads, or every kv head (``heads_for`` gives those q
    reads); ``head_local=False`` keeps every head."""
    if tp is not None:
        return _project_qkv_tp(p, x, cfg, tp, head_local)
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def project_q(p, x, cfg, tp=None):
    """x: (B, S, d) -> q (B, S, H, hd), every head, and neither k nor v:
    decode's cross-attention reads its k and v from the cache
    (``enc_kv``).  Under ``tp`` the product is ``tp.linear`` on wq alone
    (row-parallel: one all-reduce of q)."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    if tp is None:
        q = x @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"].to(q.dtype)
    else:
        shapes = _qkv_shapes(cfg, d)
        q = tp.linear(x, p["wq"], shapes["wq"])
        if cfg.qkv_bias:
            q = q + tp.whole(p["bq"], shapes["bq"]).to(q.dtype)
    return q.reshape(B, S, H, hd)


def _qkv_shapes(cfg, d):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
            "bq": (H * hd,), "bk": (KV * hd,), "bv": (KV * hd,)}


def kv_for_heads(k, H, M, index):
    """The kv heads of whole k (B, S, KV, hd) that query heads [index *
    H/M, (index + 1) * H/M) read (head h reads kv head h // G): a range
    that keeps the grouping where it can, else one kv head a query
    head."""
    KV = k.shape[2]
    G, Hl = H // KV, H // M
    a = index * Hl
    if Hl % G == 0:
        return k.narrow(2, a // G, Hl // G)
    if G % Hl == 0:
        return k.narrow(2, a // G, 1)
    return k.index_select(2, torch.arange(a, a + Hl, device=k.device) // G)


def _project_qkv_tp(p, x, cfg, tp, head_local):
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    M = tp.size
    shapes = _qkv_shapes(cfg, d)
    names = ("wq", "wk", "wv")
    bias = {n: p["b" + n[1]] for n in names} if cfg.qkv_bias else {}
    if any(tp.dim_of(p[n], shapes[n]) != 0 for n in names):
        # a weight not sharded on d: each projection on its own, whole
        out = [tp.linear(x, p[n], shapes[n]) for n in names]
        if bias:
            out = [t + tp.whole(bias[n], shapes["b" + n[1]]).to(t.dtype)
                   for t, n in zip(out, names)]
        q, k, v = out
        return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
                v.reshape(B, S, KV, hd))
    xl = tp.split(x, -1)
    parts = [xl @ p[n] for n in names]
    if not (head_local and H % M == 0):
        # every head on every rank: one all-reduce for q, k and v
        q, k, v = tp.reduce(torch.cat(parts, dim=-1)).split(
            [H * hd, KV * hd, KV * hd], dim=-1)
        if bias:
            q, k, v = [t + tp.whole(bias[n], shapes["b" + n[1]]).to(t.dtype)
                       for t, n in zip((q, k, v), names)]
        return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
                v.reshape(B, S, KV, hd))
    # head-local: this rank's H/M query heads by one reduce-scatter over
    # the heads, which carries k and v too where M divides their heads
    kv_local = KV % M == 0
    rs = names if kv_local else names[:1]
    widths = [parts[i].shape[-1] // M for i in range(len(rs))]
    packed = torch.cat([parts[i].reshape(B, S, M, -1)
                        for i in range(len(rs))], dim=-1)
    out = list(tp.reduce_scatter(packed, 2)[:, :, 0].split(widths, dim=-1))
    if bias:
        for i, n in enumerate(rs):
            b = bias[n]
            if tp.dim_of(b, shapes["b" + n[1]]) is None:
                b = tp.split(b, 0)
            out[i] = out[i] + b.to(out[i].dtype)
    q = out[0].reshape(B, S, H // M, hd)
    if kv_local:
        return (q, out[1].reshape(B, S, KV // M, hd),
                out[2].reshape(B, S, KV // M, hd))
    k, v = tp.reduce(torch.cat(parts[1:], dim=-1)).split(KV * hd, dim=-1)
    if bias:
        k = k + tp.whole(bias["wk"], shapes["bk"]).to(k.dtype)
        v = v + tp.whole(bias["wv"], shapes["bv"]).to(v.dtype)
    # whole k and v, which every rank reads at its own kv heads
    # (``heads_for``): backward, their gradients are summed over the group
    return q, tp.copy(k.reshape(B, S, KV, hd)), \
        tp.copy(v.reshape(B, S, KV, hd))


def heads_for(q, k, v, cfg, tp=None):
    """The k and v that ``q``'s heads read: where ``project_qkv`` gave
    this rank's query heads beside whole k and v, their kv heads
    (``kv_for_heads``); else k and v as they are."""
    if tp is None or q.shape[2] == cfg.n_heads or \
            k.shape[2] < cfg.n_kv_heads:
        return k, v
    return (kv_for_heads(k, cfg.n_heads, tp.size, tp.index),
            kv_for_heads(v, cfg.n_heads, tp.size, tp.index))


def attention_out(p, o, cfg, tp=None):
    """o (B, S, Hq, hd) @ wo -> (B, S, d), replicated; under ``tp`` o
    holds every head or this rank's H/M (``project_qkv``)."""
    B, S = o.shape[:2]
    flat = o.reshape(B, S, -1)
    if tp is None:
        return flat @ p["wo"]
    shape = (cfg.n_heads * cfg.head_dim, cfg.d_model)
    if o.shape[2] < cfg.n_heads:
        if tp.dim_of(p["wo"], shape) == 0:
            # wo's rows of this rank's heads
            return tp.reduce(flat @ p["wo"])
        flat = tp.gather(flat, -1)
    return tp.linear(flat, p["wo"], shape)


# ---------------------------------------------------------------------------
# flash attention: chunked forward + chunked two-pass backward
# ---------------------------------------------------------------------------
def _block_mask(q_pos, kv_pos, Sq, Skv, causal, window):
    mask = (kv_pos[None, :] <= Skv - 1) & (q_pos[:, None] <= Sq - 1)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    return mask


def _relevant(q_lo, q_hi, k_lo, k_hi, causal, window) -> bool:
    """Does kv block [k_lo, k_hi) intersect the attention span of q block
    [q_lo, q_hi)?"""
    rel = True
    if causal:
        rel = rel and k_lo <= q_hi - 1
    if window is not None:
        rel = rel and k_hi > q_lo - window + 1
    return rel


def _pad_seq(x, n):
    return F.pad(x, (0, 0, 0, 0, 0, n)) if n else x


def _chunks(Sq, Skv, q_chunk, kv_chunk):
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    return q_chunk, kv_chunk, -(-Sq // q_chunk), -(-Skv // kv_chunk)


def _flash_fwd_impl(q, k, v, causal, window, q_chunk, kv_chunk):
    """Returns (out (B,Sq,H,hd), lse (B,Sq,G,KV) fp32)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk, kv_chunk, nq, nk = _chunks(Sq, Skv, q_chunk, kv_chunk)
    qp = _pad_seq(q, nq * q_chunk - Sq).reshape(B, nq, q_chunk, KV, G, hd)
    kp = _pad_seq(k, nk * kv_chunk - Skv).reshape(B, nk, kv_chunk, KV, hd)
    vp = _pad_seq(v, nk * kv_chunk - Skv).reshape(B, nk, kv_chunk, KV, hd)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        q_lo = qi * q_chunk
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        qblk = qp[:, qi].float()
        m = torch.full((B, q_chunk, G, KV), NEG_INF, device=dev)
        l = torch.zeros((B, q_chunk, G, KV), device=dev)
        acc = torch.zeros((B, q_chunk, G, KV, hd), device=dev)
        for ki in range(nk):
            k_lo = ki * kv_chunk
            if not _relevant(q_lo, q_lo + q_chunk, k_lo, k_lo + kv_chunk,
                             causal, window):
                continue
            kv_pos = k_lo + torch.arange(kv_chunk, device=dev)
            vblk = vp[:, ki]
            s = torch.einsum("bqkgh,bskh->bqgks", qblk,
                             kp[:, ki].float()) * scale
            mask = _block_mask(q_pos, kv_pos, Sq, Skv, causal, window)
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqgks,bskh->bqgkh", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        lc = torch.clamp_min(l, 1e-30)
        outs.append((acc / lc[..., None]).to(q.dtype))
        lses.append(m + torch.log(lc))
    out = torch.stack(outs, 1).permute(0, 1, 2, 4, 3, 5)
    out = out.reshape(B, nq * q_chunk, H, hd)
    lse = torch.stack(lses, 1).reshape(B, nq * q_chunk, G, KV)
    return out[:, :Sq], lse[:, :Sq]


def _flash_bwd_impl(q, k, v, out, lse, do, causal, window, q_chunk,
                    kv_chunk):
    """Two-pass chunked backward (dq pass; dk/dv pass)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk, kv_chunk, nq, nk = _chunks(Sq, Skv, q_chunk, kv_chunk)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    pq = nq * q_chunk - Sq
    qp = _pad_seq(q, pq).reshape(B, nq, q_chunk, KV, G, hd)
    dop = _pad_seq(do, pq).reshape(B, nq, q_chunk, KV, G, hd)
    op = _pad_seq(out, pq).reshape(B, nq, q_chunk, KV, G, hd)
    lsep = F.pad(lse, (0, 0, 0, 0, 0, pq)).reshape(B, nq, q_chunk, G, KV)
    kp = _pad_seq(k, nk * kv_chunk - Skv).reshape(B, nk, kv_chunk, KV, hd)
    vp = _pad_seq(v, nk * kv_chunk - Skv).reshape(B, nk, kv_chunk, KV, hd)
    # D = rowsum(do * out) per (b, q, g, kv)
    Dp = torch.einsum("bnqkgh,bnqkgh->bnqgk", dop.float(), op.float())

    def p_block(qi, ki):
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqkgh,bskh->bqgks", qp[:, qi].float(),
                         kp[:, ki].float()) * scale
        mask = _block_mask(q_pos, kv_pos, Sq, Skv, causal, window)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        return torch.exp(s - lsep[:, qi][..., None])

    def rel(qi, ki):
        return _relevant(qi * q_chunk, (qi + 1) * q_chunk, ki * kv_chunk,
                         (ki + 1) * kv_chunk, causal, window)

    # ---- pass 1: dq per q block ----
    dqs = []
    for qi in range(nq):
        dq = torch.zeros((B, q_chunk, KV, G, hd), device=dev)
        doblk = dop[:, qi].float()
        for ki in range(nk):
            if not rel(qi, ki):
                continue
            p = p_block(qi, ki)
            dp = torch.einsum("bqkgh,bskh->bqgks", doblk, vp[:, ki].float())
            ds = p * (dp - Dp[:, qi][..., None])
            dq = dq + torch.einsum("bqgks,bskh->bqkgh", ds,
                                   kp[:, ki].float()) * scale
        dqs.append(dq)
    dq = torch.stack(dqs, 1).reshape(B, nq * q_chunk, H, hd)

    # ---- pass 2: dk/dv per kv block ----
    dks, dvs = [], []
    for ki in range(nk):
        dk = torch.zeros((B, kv_chunk, KV, hd), device=dev)
        dv = torch.zeros((B, kv_chunk, KV, hd), device=dev)
        for qi in range(nq):
            if not rel(qi, ki):
                continue
            p = p_block(qi, ki)
            doblk = dop[:, qi].float()
            dv = dv + torch.einsum("bqgks,bqkgh->bskh", p, doblk)
            dp = torch.einsum("bqkgh,bskh->bqgks", doblk, vp[:, ki].float())
            ds = p * (dp - Dp[:, qi][..., None])
            dk = dk + torch.einsum("bqgks,bqkgh->bskh", ds,
                                   qp[:, qi].float()) * scale
        dks.append(dk)
        dvs.append(dv)
    dk = torch.stack(dks, 1).reshape(B, nk * kv_chunk, KV, hd)
    dv = torch.stack(dvs, 1).reshape(B, nk * kv_chunk, KV, hd)
    return (dq[:, :Sq].to(q.dtype), dk[:, :Skv].to(k.dtype),
            dv[:, :Skv].to(v.dtype))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_chunk,
                                   kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q, k, v, *, causal=True, window=None, q_chunk=512,
                      kv_chunk=512, pallas_fn=None):
    """Flash attention (see the module docstring).

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.
    ``window``: query at position i attends to [i-window+1, i].
    """
    if pallas_fn is not None and causal and q.shape[1] == k.shape[1]:
        return pallas_fn(q, k, v, window=window)
    return _Flash.apply(q, k, v, causal, window, q_chunk, kv_chunk)


# ---------------------------------------------------------------------------
# decode attention (single new token vs KV cache)
# ---------------------------------------------------------------------------
def bmm_f32(a, b):
    """a @ b batched, accumulated and returned in fp32 (the reference's
    ``preferred_element_type=jnp.float32``)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())      # exact products, fp32 sums


def ring_valid(pos, B, slots, L, window=None):
    """(B, len(slots)) bool: which of ``slots`` (global slot ids) of a ring
    buffer of length L hold a position that a token at ``pos`` attends to.
    Slot s holds position ``pos - ((pos - s) mod L)``; negative positions
    are empty.  ``torch.remainder`` takes the divisor's sign, as
    ``jnp.mod`` does."""
    pos_b = torch.broadcast_to(
        torch.as_tensor(pos, device=slots.device).long(), (B,))[:, None]
    slot_pos = pos_b - torch.remainder(pos_b - slots[None, :], L)
    valid = slot_pos >= 0
    if window is not None:
        valid = valid & (slot_pos > pos_b - window)
    return valid


def decode_attention(q, k_cache, v_cache, pos, *, window=None,
                     head_dim=None, partial=None):
    """q: (B, 1, H, hd); caches: (B, L, KV, hd) ring buffers.

    ``pos`` is the position (an int, a 0-dim or a (B,) tensor) of the new
    token.  Slot ``s`` of a ring buffer of length L holds sequence position
    ``pos - ((pos - s) mod L)``; slots with negative positions are invalid.
    ``head_dim`` scales the scores (default the caches' hd); ``partial``
    maps the scaled scores before the mask (a head_dim-sharded cache: the
    sum of the ranks' partial scores).
    """
    B, L, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    valid = ring_valid(pos, B, torch.arange(L, device=q.device), L, window)
    qg = q.reshape(B, KV, G, hd)
    s = torch.stack([bmm_f32(qg[:, j], k_cache[:, :, j].transpose(1, 2))
                     for j in range(KV)], dim=2) / ((head_dim or hd) ** 0.5)
    if partial is not None:
        s = partial(s)                                          # (B,G,KV,L)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.stack([bmm_f32(p[:, :, j], v_cache[:, :, j])
                       for j in range(KV)], dim=1)              # (B,KV,G,hd)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_quant(q, k_cache, v_cache, pos, *, window=None,
                           head_dim=None, partial=None):
    """``decode_attention`` against int8-quantized caches
    (``{"q": int8, "scale": fp16}`` per k and v, ``models.kvquant``).  The
    scales are folded into the fp32 scores and the softmax weights, as in
    the reference, so no full-precision cache is formed."""
    kq, ks = k_cache["q"], k_cache["scale"]
    vq, vs = v_cache["q"], v_cache["scale"]
    B, L, KV, hd = kq.shape
    H = q.shape[2]
    G = H // KV
    valid = ring_valid(pos, B, torch.arange(L, device=q.device), L, window)
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,blkh->bgkl", qg, kq.float()) / \
        ((head_dim or hd) ** 0.5)
    if partial is not None:
        s = partial(s)
    s = s * ks[..., 0].float().transpose(1, 2)[:, None]        # (B,1,KV,L)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    pv = p * vs[..., 0].float().transpose(1, 2)[:, None]       # v's scales
    out = torch.einsum("bgkl,blkh->bkgh", pv, vq.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def write_slots(cache, new, pos):
    """Writes (B, 1, ...) ``new`` into ``cache`` (B, L, ...) at ring slot
    ``pos % L``, in place: one slot for the whole batch under a scalar
    ``pos``, slot ``pos[b] % L`` of row b under a (B,) ``pos``."""
    pos = torch.as_tensor(pos, device=cache.device)
    slots = torch.remainder(pos.long().reshape(-1), cache.shape[1])
    if pos.dim() == 0:
        cache.index_copy_(1, slots, new.to(cache.dtype))
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slots] = new[:, 0].to(cache.dtype)
    return cache


def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Writes (B, 1, KV, hd) new entries at ring slot ``pos % L``, in
    place, and returns the two caches.

    ``pos`` may be a scalar (all requests aligned) or (B,) per-slot
    positions (continuous batching, ``serving.engine``)."""
    return write_slots(k_cache, k_new, pos), write_slots(v_cache, v_new, pos)
