"""Chunked RWKV6 WKV recurrence: the wrapper of the Hopper kernels in
``csrc/wkv6_tc.cu`` (tensor cores) and ``csrc/wkv6.cu`` (CUDA cores).

``wkv6_chunked`` replaces the Pallas kernel
``repro/kernels/wkv6.py:wkv6_chunked``: per (batch, head) it walks the
sequence in chunks from a zero state held on chip and returns y in r's
dtype, fp32 inside.  The route follows the shape: N in ``TC_HEAD_DIMS``
with a chunk in ``TC_CHUNKS`` (every call of the model's main path) runs
the two-level form on the tensor cores, 3xTF32 products (plain twin
``ref.wkv6_subchunked``); every other shape (N 16, chunks under 16, as a
ragged T gets them from ``ops.wkv6``) runs on the CUDA cores.  The sources
state each kernel's bound and design.  The gradient is ``models.rwkv6``'s,
which recomputes through the plain chunked form, as the reference's
``_wkv_bwd`` does.

On a CUDA tensor the wrapper launches a kernel or raises; on a CPU tensor
it returns the plain chunked twin from ``ref.py``.  ``LAUNCHES`` counts
the launches of both routes under ``"wkv6_chunked"`` and those of the
tensor-core route under ``"wkv6_chunked_tc"`` as well.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"wkv6_chunked": 0, "wkv6_chunked_tc": 0}

HEAD_DIMS = (16, 32, 64)        # N the CUDA-core kernel is built for
MAX_CHUNK = 64
TC_HEAD_DIMS = (32, 64)         # the tensor-core kernel's N
TC_CHUNKS = (16, 32, 64)        # and its chunks
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"rt_wkv6_chunked": _ARGS}
_TC_SIGNATURES = {"rt_wkv6_chunked_tc": _ARGS}


def _validate(r, k, v, logw, u, chunk):
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"expected r, k, v, logw of one shape (B, T, H, "
                         f"N), got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}")
    B, T, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u must be (H, N) = {(H, N)}, got "
                         f"{tuple(u.shape)}")
    if chunk < 1 or chunk & (chunk - 1) or T % chunk:
        raise ValueError(f"chunk must be a power of two dividing T = {T}, "
                         f"got {chunk}")


def wkv6_chunked(r, k, v, logw, u, *, chunk=64):
    """r, k, v, logw: (B, T, H, N); u: (H, N); T % chunk == 0.  Returns
    y (B, T, H, N) in r's dtype.  On the card all five share fp32 or bf16,
    N is 16, 32 or 64 and chunk at most 64."""
    _validate(r, k, v, logw, u, chunk)
    if r.device.type == "cpu":
        return _ref.wkv6_chunked(r, k, v, logw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    B, T, H, N = r.shape
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype
                                     for t in (k, v, logw, u)):
        raise TypeError(f"r, k, v, logw and u must share one of "
                        f"{sorted(map(str, _DTYPES))}, got "
                        f"{[str(t.dtype) for t in (r, k, v, logw, u)]}")
    if any(t.device != r.device for t in (k, v, logw, u)):
        raise ValueError("r, k, v, logw and u must be on one device")
    if N not in HEAD_DIMS:
        raise ValueError(f"head dim N {N} is not supported: the kernel is "
                         f"built for N in {HEAD_DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")
    tc = N in TC_HEAD_DIMS and chunk in TC_CHUNKS
    r, k, v, logw, u = (_build._aligned(t) for t in (r, k, v, logw, u))
    y = torch.empty_like(r)
    if y.numel() == 0:
        return y
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), y.data_ptr(), _DTYPES[r.dtype], B, T, H, N, chunk)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            lib = _build._library("wkv6_tc", _TC_SIGNATURES)
            err = lib.rt_wkv6_chunked_tc(*args, stream)
        else:
            lib = _build._library("wkv6", _SIGNATURES)
            err = lib.rt_wkv6_chunked(*args, stream)
    if err:
        raise RuntimeError(f"wkv6_chunked kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["wkv6_chunked"] += 1
    LAUNCHES["wkv6_chunked_tc"] += tc
    return y
