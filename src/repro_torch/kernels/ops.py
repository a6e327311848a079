"""Public entry points of the port's kernels (``repro.kernels.ops``).

Dispatch follows the tensor: on CUDA the Hopper kernels run (or raise),
on the CPU their plain twins in ``ref.py`` do.  The four robust-aggregation
reductions and MLLess's segmented filter (``segment_norms``,
``segment_filter``) are the wrappers of ``robust_agg.py`` and
``block_significance.py`` themselves.  ``wkv6``
has no backward here: ``models.rwkv6`` wraps it in an ``autograd.Function``
whose backward recomputes through the plain chunked form.

``swa_attention`` carries a backward that recomputes attention through the
model library's chunked flash attention (``models.attention``), exactly as
the reference's ``_swa_bwd`` does: the reference has no backward kernel for
attention, so its gradient is plain PyTorch on the card too, by design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import block_significance as _bs
from repro_torch.kernels import fused_adamw as _fa
from repro_torch.kernels import swa_attention as _swa
from repro_torch.kernels import wkv6 as _wkv
from repro_torch.kernels.block_significance import (  # noqa: F401
    segment_filter, segment_norms,
)
from repro_torch.kernels.robust_agg import (  # noqa: F401
    coordinate_median, krum_pairwise, trimmed_mean, weiszfeld_step,
)


def block_significance(blocks, threshold):
    """blocks: (n, b) -> bool mask of significant blocks."""
    sq = _bs.block_norms(blocks)
    rms = torch.sqrt(torch.mean(sq) + 1e-20)
    return torch.sqrt(sq) > threshold * rms


def significance_filter(blocks, threshold):
    """Returns (kept, residual, mask)."""
    mask = block_significance(blocks, threshold)
    kept, resid = _bs.masked_filter(blocks, mask)
    return kept, resid, mask


# ---------------------------------------------------------------------------
# sliding-window flash attention
# ---------------------------------------------------------------------------
class _SwaAttention(torch.autograd.Function):
    """Forward: the kernel (or its plain version for a CPU tensor).
    Backward: a memory-light recompute, the chunked flash backward of
    ``models.attention.chunked_attention`` (plain PyTorch, as in the
    reference); nothing of size S^2 is saved."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.causal = window, causal
        return _swa.swa_attention_fwd(q, k, v, window=window, causal=causal)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models import attention as _att
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _att.chunked_attention(q, k, v, window=ctx.window,
                                         causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def swa_attention(q, k, v, *, window=None, causal=True):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd), with a
    gradient."""
    return _SwaAttention.apply(q, k, v, window, causal)


# ---------------------------------------------------------------------------
# fused AdamW
# ---------------------------------------------------------------------------
def fused_adamw(g, m, v, p, *, lr, b1, b2, eps, wd, c1, c2):
    """Leaf update: any-shape operands, flattened for the kernel.  m and v
    (fp32) are updated in place; returns (u in p's dtype, m, v)."""
    u, _, _ = _fa.fused_adamw_flat(
        g.reshape(-1), m.view(-1), v.view(-1), p.reshape(-1), c1, c2,
        lr=lr, b1=b1, b2=b2, eps=eps, wd=wd)
    return u.view(p.shape), m, v


# ---------------------------------------------------------------------------
# RWKV6 chunked WKV
# ---------------------------------------------------------------------------
def wkv6(r, k, v, logw, u, *, chunk=64):
    """The chunked WKV recurrence from a zero state (the kernel's state
    stays on chip).  Shapes as ``ref.wkv6``; the chunk is halved until it
    divides T."""
    T = r.shape[1]
    c = chunk
    while T % c:
        c //= 2
    return _wkv.wkv6_chunked(r, k, v, logw, u, chunk=max(c, 1))
