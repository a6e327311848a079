"""MLLess significance filter: wrappers of the two Hopper kernels in
``csrc/block_significance.cu``.

``block_norms`` replaces the Pallas kernel
``repro/kernels/block_significance.py:block_norms`` (fp32 sum of squares
per row of an (n, b) gradient view); ``masked_filter`` replaces
``repro/kernels/block_significance.py:masked_filter`` (kept = x * mask and
residual = x - kept, in fp32, emitted in the input dtype).  The source
states each kernel's bound and design.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it returns the plain version from ``ref.py``.  ``LAUNCHES`` counts the
kernel launches, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"block_norms": 0, "masked_filter": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "rt_block_norms": [_P, _I, _LL, _I, _I, _P, _P],
    "rt_masked_filter": [_P, _P, _I, _LL, _LL, _I, _P, _P, _P],
}


def _on_cuda(blocks) -> bool:
    if blocks.device.type == "cpu":
        return False
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if blocks.dim() != 2 or blocks.shape[1] == 0:
        raise ValueError(f"expected (n, b) blocks with b > 0, got "
                         f"{tuple(blocks.shape)}")
    if blocks.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {blocks.dtype}; the kernels "
                        f"take {sorted(map(str, _DTYPES))}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    return True


def _packed(b: int, dtype, *tensors) -> bool:
    width = 16 // dtype.itemsize
    return b % width == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _check(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def block_norms(blocks):
    """blocks: (n, b) fp32 or bf16 -> fp32 squared L2 norm per row (n,)."""
    if not _on_cuda(blocks):
        return _ref.block_norms(blocks)
    n, b = blocks.shape
    out = torch.empty(n, dtype=torch.float32, device=blocks.device)
    if n == 0:
        return out
    lib = _build._library("block_significance", _SIGNATURES)
    with torch.cuda.device(blocks.device):
        err = lib.rt_block_norms(
            blocks.data_ptr(), _DTYPES[blocks.dtype], n, b,
            int(_packed(b, blocks.dtype, blocks)), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(err, "block_norms")
    LAUNCHES["block_norms"] += 1
    return out


def masked_filter(blocks, mask):
    """blocks: (n, b); mask: (n,) bool -> (kept (n, b), residual (n, b))
    in the dtype of ``blocks``."""
    if not _on_cuda(blocks):
        return _ref.masked_filter(blocks, mask)
    n, b = blocks.shape
    if mask.shape != (n,) or mask.dtype != torch.bool \
            or mask.device != blocks.device or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous ({n},) bool tensor on "
                         f"{blocks.device}")
    kept = torch.empty_like(blocks)
    resid = torch.empty_like(blocks)
    if n == 0:
        return kept, resid
    lib = _build._library("block_significance", _SIGNATURES)
    with torch.cuda.device(blocks.device):
        err = lib.rt_masked_filter(
            blocks.data_ptr(), mask.data_ptr(), _DTYPES[blocks.dtype], n, b,
            int(_packed(b, blocks.dtype, blocks, kept, resid)),
            kept.data_ptr(), resid.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(err, "masked_filter")
    LAUNCHES["masked_filter"] += 1
    return kept, resid
