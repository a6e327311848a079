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
