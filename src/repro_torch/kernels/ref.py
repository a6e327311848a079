"""Plain PyTorch twins of the port's kernels (``repro.kernels.ref``).

The CPU path of every kernel wrapper, and what ``chip_smoke.py`` holds
each kernel against on the card.
"""
from __future__ import annotations

import torch


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
