"""Plain PyTorch twins of the port's kernels (``repro.kernels.ref``).

The CPU path of every kernel wrapper, and what ``chip_smoke.py`` holds
each kernel against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def block_norms(blocks):
    """(n, b) any float -> fp32 sum of squares per row (n,)."""
    return torch.sum(blocks.float() ** 2, dim=1)


def masked_filter(blocks, mask):
    """(n, b), mask (n,) bool -> (kept, residual), each (n, b).

    Filters in fp32 and emits in the input dtype: a bf16 gradient comes
    back bf16."""
    bf = blocks.float()
    kept = bf * mask[:, None].float()
    return kept.to(blocks.dtype), (bf - kept).to(blocks.dtype)


def block_significance(blocks, threshold):
    """MLLess significance mask: blocks whose RMS exceeds ``threshold``
    times the RMS over all blocks."""
    sq = block_norms(blocks)
    rms = torch.sqrt(torch.mean(sq) + 1e-20)
    return torch.sqrt(sq) > threshold * rms


def significance_filter(blocks, threshold):
    """(kept, residual, mask) of the significance filter."""
    mask = block_significance(blocks, threshold)
    kept, resid = masked_filter(blocks, mask)
    return kept, resid, mask


def _segment_blocks(grads, resid, layout):
    """Each leaf's acc = g.float() + r, zero-padded to whole rows and cut
    into (rows, block) blocks, as MLLess cuts it."""
    B = layout.block
    for g, n, b0, nb in zip(grads, layout.numels, layout.block0,
                            layout.blocks):
        acc = g.reshape(-1).float() + resid[b0 * B:b0 * B + n]
        pad = nb * B - n
        yield (F.pad(acc, (0, pad)) if pad else acc).view(-1, B)


def segment_norms(grads, resid, layout, threshold):
    """Leaf by leaf: each row's sum of squares, the leaf's mask (its RMS
    from ``torch.mean`` of its rows, as ``block_significance``) and its
    count of significant rows.  Returns (sq, mask, counts) over all rows
    and leaves."""
    sqs, masks, counts = [], [], []
    for blocks in _segment_blocks(grads, resid, layout):
        sq = block_norms(blocks)
        rms = torch.sqrt(torch.mean(sq) + 1e-20)
        mask = torch.sqrt(sq) > threshold * rms
        sqs.append(sq)
        masks.append(mask)
        counts.append(mask.sum())
    return torch.cat(sqs), torch.cat(masks), torch.stack(counts)


def segment_filter(grads, resid, layout, mask):
    """Leaf by leaf: ``masked_filter`` of the leaf's rows; returns (kept,
    unpadded and flat, each leaf at its offset; the padded flat
    residual)."""
    B = layout.block
    kept = resid.new_empty(layout.numel)
    new_resid = torch.empty_like(resid)
    for blocks, n, b0, nb, off in zip(
            _segment_blocks(grads, resid, layout), layout.numels,
            layout.block0, layout.blocks, layout.offsets):
        k, r = masked_filter(blocks, mask[b0:b0 + nb])
        kept[off:off + n] = k.view(-1)[:n]
        new_resid[b0 * B:(b0 + nb) * B] = r.view(-1)
    return kept, new_resid


# ---------------------------------------------------------------------------
# robust-aggregation reductions (the arithmetic of csrc/robust_agg.cu)
#
# Each takes a [W, ...] stack, computes in fp32 and performs the kernel's
# operations in the kernel's order: the masked trim=1 pass, the sorting
# network, Gram-form distances, the direct Weiszfeld distances.  Sums run
# row by row, and a division is by a tensor on the stack's device, not by
# a Python number: on the card PyTorch divides by a host scalar as a
# multiply by its reciprocal, which would round differently from the
# kernel's division.
# ---------------------------------------------------------------------------
def _rows32(stacked):
    return stacked.reshape(stacked.shape[0], -1).float()


def _div(a, n):
    return a / a.new_tensor(float(n))


def _batcher_pairs(n: int):
    """Compare-exchange pairs of Batcher's bitonic network for ``n`` a
    power of two; (lo, hi) means "row lo receives the minimum"."""
    pairs = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            for i in range(n):
                partner = i ^ j
                if partner > i:
                    pairs.append((i, partner) if (i & k) == 0
                                 else (partner, i))
            j //= 2
        k *= 2
    return pairs


def _sorted_rows(x):
    """Rows of a (W, D) block sorted per column by the network, W padded
    to a power of two with +inf rows that sink to the bottom."""
    W = x.shape[0]
    P = 1 << (W - 1).bit_length()
    rows = list(x.unbind(0))
    rows += [torch.full_like(rows[0], float("inf"))] * (P - W)
    for lo, hi in _batcher_pairs(P):
        a, b = rows[lo], rows[hi]
        rows[lo], rows[hi] = torch.minimum(a, b), torch.maximum(a, b)
    return rows[:W]


def _trimmed_mean1(x):
    """Masks the first argmin and the first argmax of each column, sums
    the rest in row order; a constant column returns x[0]."""
    W = x.shape[0]
    lo, hi = x[0], x[0]
    imin = torch.zeros(x.shape[1], dtype=torch.long, device=x.device)
    imax = imin
    for i in range(1, W):
        lt, gt = x[i] < lo, x[i] > hi
        lo, imin = torch.where(lt, x[i], lo), torch.where(lt, i, imin)
        hi, imax = torch.where(gt, x[i], hi), torch.where(gt, i, imax)
    acc = torch.zeros_like(x[0])
    for i in range(W):
        acc = acc + x[i] * ((imin != i) & (imax != i)).float()
    return torch.where(imin == imax, x[0], _div(acc, W - 2))


def trimmed_mean(stacked, trim=1):
    """[W, ...] -> fp32 interior mean over axis 0 after dropping ``trim``
    values at each end per coordinate (needs W > 2*trim)."""
    x = _rows32(stacked)
    W = x.shape[0]
    if trim == 1:
        out = _trimmed_mean1(x)
    else:
        rows = _sorted_rows(x)
        out = rows[trim]
        for r in rows[trim + 1:W - trim]:
            out = out + r
        out = _div(out, W - 2 * trim)
    return out.reshape(stacked.shape[1:])


def coordinate_median(stacked):
    """[W, ...] -> fp32 per-coordinate median; even W averages the two
    middle values (``torch.median`` would return the lower one)."""
    x = _rows32(stacked)
    W = x.shape[0]
    rows = _sorted_rows(x)
    out = rows[W // 2] if W % 2 else 0.5 * (rows[W // 2 - 1] + rows[W // 2])
    return out.reshape(stacked.shape[1:])


def krum_pairwise(stacked):
    """[W, ...] -> (W, W) fp32 squared distances ||xi||^2 + ||xj||^2 -
    2 <xi, xj>, clamped at 0.  On the card TF32 must be off for the
    product to be fp32."""
    x = _rows32(stacked)
    n = torch.sum(x * x, dim=1)
    d = n[:, None] + n[None, :] - 2.0 * (x @ x.T)
    return torch.clamp_min(d, 0.0)


def weiszfeld_weights(sq, floor):
    """Weiszfeld weights 1 / max(sqrt(sq), floor) of the W squared
    distances, and their total (shared by the kernel's wrapper)."""
    w = 1.0 / torch.clamp_min(torch.sqrt(sq), floor)
    return w, torch.sum(w)


def weiszfeld_step(stacked, z, floor):
    """One Weiszfeld iteration on a [W, D] stack: direct squared
    distances to ``z``, the weights, the weighted rows summed in row
    order over the total weight.  Returns fp32 (D,)."""
    x = _rows32(stacked)
    z = z.reshape(-1).float()
    sq = torch.sum((x - z[None, :]) ** 2, dim=1)
    w, total = weiszfeld_weights(sq, floor)
    acc = torch.zeros_like(z)
    for i in range(x.shape[0]):
        acc = acc + w[i] * x[i]
    return acc / total


# ---------------------------------------------------------------------------
# sliding-window attention and fused AdamW (the LM training path)
# ---------------------------------------------------------------------------
def swa_attention(q, k, v, *, window=None, causal=True):
    """Naive O(S^2) masked softmax attention in fp32 (the reference's
    oracle).  q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0,
    head h reading kv head h // (H // KV); a query at position i attends
    to [i - window + 1, i].  Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qr, k.float()) / (hd ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def fused_adamw_flat(g, m, v, p, c1, c2, *, lr, b1, b2, eps, wd):
    """One AdamW step over 1-D operands: returns (u fp32, m', v').

    The kernel's operations in the kernel's order, each rounded once:
    ``m' = b1*m + (1-b1)*g``, ``v' = b2*v + ((1-b2)*g)*g``,
    ``u = -lr * ((m'/c1) / (sqrt(v'/c2) + eps) + wd*p)``, the root
    correctly rounded.  ``c1`` and
    ``c2`` are fp32 tensors on the operands' device: a division by a host
    scalar would be a reciprocal multiply on the card."""
    gf = g.float()
    pf = p.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    u = -lr * ((m_new / c1) / (_sqrt_rn(v_new / c2) + eps) + wd * pf)
    return u, m_new, v_new


def _sqrt_rn(x):
    """The correctly rounded fp32 square root (``__fsqrt_rn``): taken in
    float64 and rounded once.  PyTorch's vectorised CPU ``sqrt`` of fp32
    is off by one ulp in about 0.7% of values."""
    return torch.sqrt(x.double()).float()


# ---------------------------------------------------------------------------
# RWKV6 WKV recurrence (the RWKV training path)
# ---------------------------------------------------------------------------
def wkv6(r, k, v, logw, u):
    """The exact step-by-step RWKV6 recurrence (the oracle).

    r, k, v, logw: (B, T, H, N); u: (H, N).  S_t = diag(w_t) S_{t-1} +
    k_t v_t^T;  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T).  Returns y in r's
    dtype."""
    B, T, H, N = r.shape
    rf, kf, vf = (a.float() for a in (r, k, v))
    w = torch.exp(logw.float())
    uf = u.float()
    S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        kv = torch.einsum("bhn,bhm->bhnm", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t],
                               S + uf[None, :, :, None] * kv))
        S = w[:, t][..., None] * S + kv
    if not ys:
        return torch.zeros_like(r)
    return torch.stack(ys, dim=1).to(r.dtype)


def wkv6_chunk(r, k, v, logw, u, S):
    """One chunk of the chunked WKV form, batched over (B, H): r, k, v,
    logw (B, c, H, N) fp32, u (H, N), S (B, H, N, N) the state before the
    chunk.  Returns (y (B, c, H, N), S after the chunk).

    With L the inclusive cumsum of logw over the chunk and Lprev the
    exclusive one, y_t = (r_t * exp(Lprev_t)) S + sum_{s<t} a[t,s] v_s +
    (r_t . (u * k_t)) v_t, a[t,s] = sum_n r_t k_s exp(Lprev_t - L_s).  The
    pairwise difference is masked to -inf for s >= t before the exp (it is
    positive there and would overflow), and Lprev is L shifted by one step
    rather than L - logw, so exp(Lprev_t - L_{t-1}) is exactly 1, as in
    the kernel.  The model keeps its own chunk step (``models.rwkv6``, the
    reference's ``chunk_step``): this one is only the kernel's yardstick."""
    c = r.shape[1]
    L = torch.cumsum(logw, dim=1)
    Lprev = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], dim=1)
    y = torch.einsum("bthn,bhnm->bthm", r * torch.exp(Lprev), S)
    idx = torch.arange(c, device=r.device)
    mask = (idx[:, None] > idx[None, :])[None, :, :, None, None]
    diff = torch.where(mask, Lprev[:, :, None] - L[:, None],
                       torch.tensor(float("-inf"), device=r.device))
    a = torch.sum(r[:, :, None] * k[:, None] * torch.exp(diff), dim=-1)
    y = y + torch.einsum("btsh,bshn->bthn", a, v)
    y = y + torch.sum(r * u * k, dim=-1, keepdim=True) * v
    L_last = L[:, -1]                                       # (B, H, N)
    k_dec = k * torch.exp(L_last[:, None] - L)
    S = torch.exp(L_last)[..., None] * S + torch.einsum(
        "bshn,bshm->bhnm", k_dec, v)
    return y, S


def wkv6_chunked(r, k, v, logw, u, *, chunk=64):
    """The kernel's function in plain PyTorch: the chunked form, chunk by
    chunk from a zero state, fp32 inside.  r, k, v, logw: (B, T, H, N)
    with T % chunk == 0; u: (H, N).  Returns y in r's dtype."""
    B, T, H, N = r.shape
    if T % chunk:
        raise ValueError(f"T = {T} is not a multiple of chunk {chunk}")
    uf = u.float()
    S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t0 in range(0, T, chunk):
        y, S = wkv6_chunk(*(a[:, t0:t0 + chunk].float()
                            for a in (r, k, v, logw)), uf, S)
        ys.append(y)
    if not ys:
        return torch.zeros_like(r)
    return torch.cat(ys, dim=1).to(r.dtype)


LOG2E = 1.4426950408889634


def tf32_trunc(x):
    """fp32 -> TF32 by dropping the 13 low mantissa bits: what a TF32
    ``mma`` reads of an fp32 register."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_split(x):
    """x = hi + lo as the tensor-core kernel splits an mma operand: hi is x
    truncated to TF32 (the kernel passes x itself and the mma reads its top
    19 bits), lo = x - hi, exact in fp32.  Finite for every finite x (a
    rounded hi would carry into inf at the top of fp32's range); an
    infinite x gives a NaN lo."""
    hi = tf32_trunc(x)
    return hi, x - hi


def _mm_tf32x3(a, b):
    """a @ b as the tensor-core kernel forms it: each fp32 operand split
    by ``tf32_split``, lo truncated to TF32 by the mma, three products
    (lo.hi, hi.lo, hi.hi) summed in fp32; lo.lo is dropped."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    al, bl = tf32_trunc(al), tf32_trunc(bl)
    return (al @ bh + ah @ bl) + ah @ bh


def wkv6_subchunked(r, k, v, logw, u, *, chunk=64, sub=16, tf32x3=True):
    """The arithmetic of the tensor-core WKV kernel (``csrc/wkv6_tc.cu``)
    in plain PyTorch: the same function as ``wkv6_chunked``, in the
    two-level form.  Each chunk is cut into sub-chunks of ``sub``; L is
    the inclusive cumsum of logw * log2(e), Lprev the exclusive one, E_i
    the L at the end of sub-chunk i and Lam_i = E_{i-1} (0 for the first).

    - A sub-chunk's own block of a keeps the exact pairwise decay for
      s < t, as the kernel forms it: the running product of the per-step
      decays w_m = exp2(logw_m * log2(e)) for s < m < t (never above 1),
      and the bonus r_t . (u * k_t) on its diagonal.
    - Across sub-chunks (t in i, s in j < i) a[t, s] = rho_t . (D_ij *
      kap_s) with rho_t = r_t exp2(Lprev_t - Lam_i), kap_s = k_s
      exp2(E_j - L_s) and D_ij = exp2(Lam_i - E_j): every exponent is
      <= 0, so nothing overflows under any decay.
    - y = (rho * exp2(Lam)) S + a V; S <- exp2(L_last) S + (kap *
      exp2(L_last - E))^T V.

    With ``tf32x3`` the four products (rho.kap^T, the S product, a V and
    the state update) split and truncate their operands as the kernel's
    3xTF32 ``mma.sync`` does (``_mm_tf32x3``); without it they are fp32
    products.  r, k, v, logw: (B, T, H, N), T % chunk == 0; u: (H, N).
    Returns y in r's dtype."""
    B, T, H, N = r.shape
    if T % chunk:
        raise ValueError(f"T = {T} is not a multiple of chunk {chunk}")
    sub = min(sub, chunk)
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a multiple of sub {sub}")
    mm = _mm_tf32x3 if tf32x3 else torch.matmul
    ns = chunk // sub
    rf, kf, vf = (a.float().permute(0, 2, 1, 3) for a in (r, k, v))
    lw = logw.float().permute(0, 2, 1, 3) * LOG2E          # (B, H, T, N)
    uf = u.float()[None, :, None, :]
    eye = torch.eye(sub, dtype=torch.float32, device=r.device)
    S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t0 in range(0, T, chunk):
        rc, kc, vc = (a[:, :, t0:t0 + chunk] for a in (rf, kf, vf))
        L = torch.cumsum(lw[:, :, t0:t0 + chunk], dim=2)
        Lp = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
        Ls, Lps, rs, ks = (a.reshape(B, H, ns, sub, N)
                           for a in (L, Lp, rc, kc))
        E = Ls[:, :, :, -1]                                  # (B, H, ns, N)
        Lam = torch.cat([torch.zeros_like(E[:, :, :1]), E[:, :, :-1]], dim=2)
        ws = torch.exp2(lw[:, :, t0:t0 + chunk]).reshape(B, H, ns, sub, N)
        a_diag = torch.sum(rs * uf[:, :, None] * ks, dim=-1,
                           keepdim=True) * eye
        dec = torch.ones_like(rs)               # prod_{t-d<m<t} w_m at row t
        for d in range(1, sub):
            t, s = torch.arange(d, sub), torch.arange(0, sub - d)
            a_diag[:, :, :, t, s] = torch.sum(
                rs[:, :, :, t] * ks[:, :, :, s] * dec[:, :, :, t], dim=-1)
            dec[:, :, :, t] = dec[:, :, :, t] * ws[:, :, :, s]
        rho = rs * torch.exp2(Lps - Lam[:, :, :, None])
        kap = ks * torch.exp2(E[:, :, :, None] - Ls)
        a = torch.zeros((B, H, chunk, chunk), dtype=torch.float32,
                        device=r.device)
        for i in range(ns):
            ri = slice(i * sub, (i + 1) * sub)
            a[:, :, ri, ri] = a_diag[:, :, i]
            for j in range(i):
                D = torch.exp2(Lam[:, :, i] - E[:, :, j])[:, :, None]
                a[:, :, ri, j * sub:(j + 1) * sub] = mm(
                    rho[:, :, i] * D, kap[:, :, j].transpose(-1, -2))
        qdec = (rho * torch.exp2(Lam)[:, :, :, None]).reshape(B, H, chunk, N)
        kdec = (kap * torch.exp2(E[:, :, -1:] - E)[:, :, :, None]).reshape(
            B, H, chunk, N)
        ys.append(mm(qdec, S) + mm(a, vc))
        S = torch.exp2(E[:, :, -1])[..., None] * S + mm(
            kdec.transpose(-1, -2), vc)
    if not ys:
        return torch.zeros_like(r)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).contiguous().to(r.dtype)
