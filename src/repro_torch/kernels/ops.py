"""Public entry points of the port's kernels (``repro.kernels.ops``).

Dispatch follows the tensor: on CUDA the Hopper kernels run (or raise),
on the CPU their plain twins in ``ref.py`` do.  The four robust-aggregation
reductions are the wrappers of ``robust_agg.py`` themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import block_significance as _bs
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
