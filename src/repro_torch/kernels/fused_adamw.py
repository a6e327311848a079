"""Fused AdamW: the wrapper of the Hopper kernel in
``csrc/fused_adamw.cu``.

``fused_adamw_flat`` replaces the Pallas kernel
``repro/kernels/fused_adamw.py:fused_adamw_flat``: one pass over a leaf's
(g, m, v, p) with the step's bias corrections (c1, c2) gives the update u
and the new moments.  The source states the kernel's bound and design.

The kernel writes m' and v' in place over m and v and emits u in p's
dtype.  On a CUDA tensor the wrapper launches it or raises; on a CPU
tensor it runs the plain version from ``ref.py`` and copies the moments
into m and v, so both return the same things.  ``LAUNCHES`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"fused_adamw_flat": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "rt_fused_adamw": [_P, _I, _P, _P, _P, _I, _P, _LL, _P, _P, _F, _F, _F,
                       _F, _F, _F, _F, _I, _P],
}


def _validate(g, m, v, p, c1, c2):
    n = p.numel()
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name} must be 1-D of length {n}, got "
                             f"{tuple(t.shape)}")
    if p.dim() != 1:
        raise ValueError(f"p must be 1-D, got {tuple(p.shape)}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"m and v must be fp32, got {m.dtype} {v.dtype}")
    for name, t in (("c1", c1), ("c2", c2)):
        if not isinstance(t, torch.Tensor) or t.numel() != 1 \
                or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a one-element fp32 tensor")


def fused_adamw_flat(g, m, v, p, c1, c2, *, lr, b1, b2, eps, wd):
    """g, p: (n,) fp32 or bf16; m, v: (n,) fp32, updated in place; c1,
    c2: one-element fp32 tensors on the same device.  Returns (u in p's
    dtype, m, v)."""
    _validate(g, m, v, p, c1, c2)
    if p.device.type == "cpu":
        u, m_new, v_new = _ref.fused_adamw_flat(
            g, m, v, p, c1, c2, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd)
        m.copy_(m_new)
        v.copy_(v_new)
        return u.to(p.dtype), m, v
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    for name, t in (("g", g), ("p", p)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"unsupported {name} dtype {t.dtype}; the "
                            f"kernel takes {sorted(map(str, _DTYPES))}")
    for name, t in (("g", g), ("m", m), ("v", v), ("p", p), ("c1", c1),
                    ("c2", c2)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    u = torch.empty_like(p)
    n = p.numel()
    if n == 0:
        return u, m, v
    lib = _build._library("fused_adamw", _SIGNATURES)
    with torch.cuda.device(p.device):
        sms = torch.cuda.get_device_properties(p.device).multi_processor_count
        err = lib.rt_fused_adamw(
            g.data_ptr(), _DTYPES[g.dtype], m.data_ptr(), v.data_ptr(),
            p.data_ptr(), _DTYPES[p.dtype], u.data_ptr(), n, c1.data_ptr(),
            c2.data_ptr(), -lr, b1, b2, 1.0 - b1, 1.0 - b2, eps, wd, sms,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_adamw_flat kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["fused_adamw_flat"] += 1
    return u, m, v
