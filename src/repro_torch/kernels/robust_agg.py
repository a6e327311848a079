"""Byzantine-robust aggregation: wrappers of the four Hopper kernels in
``csrc/robust_agg.cu``.

Each reduces the fleet's ``[W, ...]`` gradient stack (W workers) over the
worker axis and replaces the Pallas kernel of the same name in
``repro/kernels/robust_agg.py``:

  ``trimmed_mean``       interior mean per coordinate (trim == 1: the
                         masked one-pass form; trim >= 2: a sorting
                         network), fp32 with the stack's trailing shape
  ``coordinate_median``  per-coordinate median (even W: the mean of the
                         two middle values)
  ``krum_pairwise``      (W, W) squared distances in Gram form (W <= 8:
                         one streaming pass with the rows of a column
                         in registers; above: the shared-memory tile
                         form, ``rt_krum_pairwise_tile``)
  ``weiszfeld_step``     one geometric-median iteration

The stack is cast to fp32 and flattened to (W, D) first, as the
reference's ``_flatten_stack`` does.  On a CUDA tensor a wrapper launches
its kernel or raises (W above ``MAX_W`` raises too); on a CPU tensor it
returns the plain version from ``ref.py``.  ``LAUNCHES`` counts kernel
launches: one per call, two per ``weiszfeld_step`` (its two passes).
The source states each kernel's bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"trimmed_mean": 0, "coordinate_median": 0, "krum_pairwise": 0,
            "weiszfeld_step": 0}
MAX_W = 32           # the kernels are instantiated for W <= 32

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "rt_rowstat": [_P, _LL, _I, _I, _P, _P],
    "rt_krum_pairwise": [_P, _LL, _I, _P, _P, _P, _P],
    "rt_krum_pairwise_tile": [_P, _LL, _I, _P, _P, _P, _P],
    "rt_weiszfeld_sqdist": [_P, _P, _LL, _I, _P, _P, _P, _P],
    "rt_weiszfeld_wsum": [_P, _P, _P, _LL, _I, _P, _P],
    "rt_partial_floats": [_I],
}


def _lib():
    return _build._library("robust_agg", _SIGNATURES)


def _flat(stacked):
    """[W, ...] -> contiguous (W, D) fp32 and the trailing shape."""
    W = stacked.shape[0]
    return stacked.reshape(W, -1).float().contiguous(), stacked.shape[1:]


def _on_cuda(flat) -> bool:
    if flat.device.type == "cpu":
        return False
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    W, D = flat.shape
    if not 1 <= W <= MAX_W:
        raise ValueError(f"the robust-aggregation kernels take 1 <= W <= "
                         f"{MAX_W} workers, got W={W}")
    if D == 0:
        raise ValueError("empty gradient stack")
    return True


def _check(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _rowstat(flat, trim: int, name: str):
    W, D = flat.shape
    out = torch.empty(D, dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        err = _lib().rt_rowstat(flat.data_ptr(), D, W, trim, out.data_ptr(),
                                _stream(flat))
    _check(err, name)
    LAUNCHES[name] += 1
    return out


def _scratch(flat):
    """Block partials and a zeroed ticket counter for a two-level sum."""
    partial = torch.empty(_lib().rt_partial_floats(flat.shape[0]),
                          dtype=torch.float32, device=flat.device)
    counter = torch.zeros(1, dtype=torch.int32, device=flat.device)
    return partial, counter


def trimmed_mean(stacked, trim: int = 1):
    """Mean over axis 0 of a ``[W, ...]`` stack after dropping the
    ``trim`` smallest and largest values per coordinate; fp32 with the
    trailing shape.  Needs ``W > 2*trim``."""
    W = stacked.shape[0]
    if trim < 1:
        raise ValueError(f"trimmed_mean kernel needs trim >= 1, got "
                         f"trim={trim}")
    if W <= 2 * trim:
        raise ValueError(f"trimmed_mean needs W > 2*trim, got W={W}, "
                         f"trim={trim}")
    flat, trailing = _flat(stacked)
    if not _on_cuda(flat):
        return _ref.trimmed_mean(flat, trim).reshape(trailing)
    return _rowstat(flat, trim, "trimmed_mean").reshape(trailing)


def coordinate_median(stacked):
    """Per-coordinate median over axis 0 (fp32; even W averages the two
    middle values, as ``jnp.median`` does)."""
    flat, trailing = _flat(stacked)
    if not _on_cuda(flat):
        return _ref.coordinate_median(flat).reshape(trailing)
    return _rowstat(flat, -1, "coordinate_median").reshape(trailing)


def krum_pairwise(stacked):
    """``[W, ...]`` stack -> (W, W) fp32 squared Euclidean distances
    between rows, in Gram form, clamped at 0 (diagonal 0)."""
    flat, _ = _flat(stacked)
    if not _on_cuda(flat):
        return _ref.krum_pairwise(flat)
    W, D = flat.shape
    out = torch.empty((W, W), dtype=torch.float32, device=flat.device)
    partial, counter = _scratch(flat)
    with torch.cuda.device(flat.device):
        err = _lib().rt_krum_pairwise(
            flat.data_ptr(), D, W, partial.data_ptr(), counter.data_ptr(),
            out.data_ptr(), _stream(flat))
    _check(err, "krum_pairwise")
    LAUNCHES["krum_pairwise"] += 1
    return out


def weiszfeld_step(stacked, z, floor, *, row_sqnorms=None):
    """One Weiszfeld iteration on a ``[W, D]`` stack: every row's
    distance to ``z``, weights ``1 / max(distance, floor)``, the weighted
    mean.  Returns the new fp32 (D,) estimate.  ``row_sqnorms`` is
    accepted and ignored, as the reference's kernel path ignores it: the
    distances are the direct ``sum((x - z)^2)``."""
    del row_sqnorms
    flat, _ = _flat(stacked)
    W, D = flat.shape
    z = z.reshape(-1).float().contiguous()
    if z.shape[0] != D:
        raise ValueError(f"weiszfeld_step needs z of length {D}, got "
                         f"{z.shape[0]}")
    if not _on_cuda(flat):
        return _ref.weiszfeld_step(flat, z, floor)
    if z.device != flat.device:
        raise ValueError(f"z is on {z.device}, the stack on {flat.device}")
    lib = _lib()
    sq = torch.empty(W, dtype=torch.float32, device=flat.device)
    partial, counter = _scratch(flat)
    with torch.cuda.device(flat.device):
        err = lib.rt_weiszfeld_sqdist(
            flat.data_ptr(), z.data_ptr(), D, W, partial.data_ptr(),
            counter.data_ptr(), sq.data_ptr(), _stream(flat))
    _check(err, "weiszfeld_step (distances)")
    LAUNCHES["weiszfeld_step"] += 1
    w, total = _ref.weiszfeld_weights(sq, floor)
    out = torch.empty(D, dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        err = lib.rt_weiszfeld_wsum(
            flat.data_ptr(), w.data_ptr(), total.data_ptr(), D, W,
            out.data_ptr(), _stream(flat))
    _check(err, "weiszfeld_step (weighted sum)")
    LAUNCHES["weiszfeld_step"] += 1
    return out
