"""Sliding-window attention forward: the wrapper of the Hopper kernels in
``csrc/swa_attention_tc.cu`` (bf16) and ``csrc/swa_attention_tf32.cu``
(fp32), both on the tensor cores.

``swa_attention_fwd`` replaces the Pallas kernel
``repro/kernels/swa_attention.py:swa_attention_fwd``: causal GQA attention
with an optional sliding window and an fp32 online softmax.  The route
follows the dtype.  bf16 at every head_dim of
``HEAD_DIMS`` (up to pixtral-12b's 160, recurrentgemma-2b's 256 and
gemma3-4b's 320) runs wgmma and TMA (P.V as two bf16 products of P's high
and low halves).  fp32 at every head_dim (``TF32_HEAD_DIMS``) runs
``mma.sync`` in 3xTF32, each fp32 operand split into a TF32 high part and
the rest, three TF32 products where one would miss the fp32 gate; at hd
320 two warps share each 16 rows, each owning half of O's columns.  The
first, CUDA-core kernel (``csrc/swa_attention.cu``) is on no route: it
stays built as the design the others are timed against.  The sources
state each kernel's bound and design.  The gradient is
``kernels.ops.swa_attention``.

On a CUDA tensor the wrapper launches a kernel or raises; on a CPU tensor
it returns the plain version from ``ref.py``.  ``LAUNCHES`` counts the
launches of every route under ``"swa_attention_fwd"`` and those of the
tensor-core routes under ``"swa_attention_fwd_wgmma"`` (bf16) or
``"swa_attention_fwd_tf32"`` (fp32) as well, so a run shows which route
each launch took.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"swa_attention_fwd": 0, "swa_attention_fwd_wgmma": 0,
            "swa_attention_fwd_tf32": 0}

# head_dims the wgmma, 3xTF32 and CUDA-core kernels are built for
HEAD_DIMS = (32, 64, 96, 128, 160, 256, 320)
TF32_HEAD_DIMS = HEAD_DIMS
MAX_GROUP = 64                  # H / KV: a q tile holds 64 (query, head) rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the CUDA-core kernel's entry point, on no route (``chip_smoke`` times it)
_SIGNATURES = {
    "rt_swa_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _F, _P],
}
_TC_SIGNATURES = {
    "rt_swa_attention_fwd_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _F, _P],
}
_TF32_SIGNATURES = {
    "rt_swa_attention_fwd_tf32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _F, _P],
}


def _validate(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, S, H, hd) and k, v (B, S, KV, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H {H} is not divisible by KV {k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def swa_attention_fwd(q, k, v, *, window=None, causal=True):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd), fp32 or bf16 alike.
    Returns (B, S, H, hd) in q's dtype."""
    _validate(q, k, v, window)
    if q.device.type == "cpu":
        return _ref.swa_attention(q, k, v, window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of "
                        f"{sorted(map(str, _DTYPES))}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not supported: the kernels are "
                         f"built for head_dim in {HEAD_DIMS}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"H / KV = {H // KV} > {MAX_GROUP} heads a kv head")
    wgmma = q.dtype == torch.bfloat16
    q, k, v = _build._aligned(q), _build._aligned(k), _build._aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, KV, hd, 0 if window is None else int(window),
            int(bool(causal)), 1.0 / math.sqrt(hd)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if wgmma:
            lib = _build._library("swa_attention_tc", _TC_SIGNATURES)
            err = lib.rt_swa_attention_fwd_wgmma(*args, stream)
        else:
            lib = _build._library("swa_attention_tf32", _TF32_SIGNATURES)
            err = lib.rt_swa_attention_fwd_tf32(*args, stream)
    if err:
        raise RuntimeError(f"swa_attention_fwd kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["swa_attention_fwd"] += 1
    LAUNCHES["swa_attention_fwd_wgmma"] += wgmma
    LAUNCHES["swa_attention_fwd_tf32"] += not wgmma
    return out
