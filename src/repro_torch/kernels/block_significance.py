"""MLLess significance filter: wrappers of the Hopper kernels in
``csrc/block_significance.cu``.

``block_norms`` replaces the Pallas kernel
``repro/kernels/block_significance.py:block_norms`` (fp32 sum of squares
per row of an (n, b) gradient view); ``masked_filter`` replaces
``repro/kernels/block_significance.py:masked_filter`` (kept = x * mask and
residual = x - kept, in fp32, emitted in the input dtype).

``segment_norms`` and ``segment_filter`` are the same two functions over
every leaf of a gradient list at once, with the error-feedback residual
added in: the form ``MLLess.sync`` runs, three launches a step whatever
the number of leaves.  ``SegmentLayout`` says where each leaf lies in
their buffers.  The source states each kernel's bound and design.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it returns the plain version from ``ref.py``.  ``LAUNCHES`` counts the
kernel launches, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"block_norms": 0, "masked_filter": 0, "segment_norms": 0,
            "segment_filter": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "rt_block_norms": [_P, _I, _LL, _I, _I, _P, _P],
    "rt_masked_filter": [_P, _P, _I, _LL, _LL, _I, _P, _P, _P],
    "rt_segment_norms": [_P, _P, _P, _I, _LL, _I, _P, ctypes.c_float, _P,
                         _P, _P, _P],
    "rt_segment_filter": [_P, _P, _P, _LL, _I, _P, _P, _P, _P, _P],
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


# ---------------------------------------------------------------------------
# the segmented pair: every leaf of a gradient list in one pass
# ---------------------------------------------------------------------------
class SegmentLayout:
    """Where each leaf of a gradient list lies in the segmented filter's
    buffers, for one list of leaf shapes and dtypes (``key``).

    Leaf i, of ``numels[i]`` values, fills ``blocks[i]`` rows of ``block``
    values from row ``block0[i]`` of the flat fp32 residual (zero past its
    numel), and lies at ``offsets[i]`` of the unpadded flat output.  On a
    card the layout also holds the kernels' segment table and row-to-leaf
    map, uploaded once, and the leaves' data pointers, uploaded again only
    when the gradients move."""

    def __init__(self, grads, block: int = 256):
        if block <= 0:
            raise ValueError(f"block must be positive, got {block}")
        self.key = tuple((tuple(g.shape), g.dtype) for g in grads)
        self.block = block
        self.numels = [g.numel() for g in grads]
        self.blocks = [-(-n // block) for n in self.numels]
        self.block0 = [0]
        self.offsets = [0]
        for n, nb in zip(self.numels, self.blocks):
            self.block0.append(self.block0[-1] + nb)
            self.offsets.append(self.offsets[-1] + n)
        self.n_rows, self.numel = self.block0.pop(), self.offsets.pop()
        self._tables = None
        self._ptrs = (None, None)

    def matches(self, grads) -> bool:
        return len(grads) == len(self.key) and all(
            g.shape == shape and g.dtype == dtype
            for g, (shape, dtype) in zip(grads, self.key))

    def residual_views(self, flat):
        """Each leaf's residual, a view of the padded flat buffer."""
        return [flat[b0 * self.block:b0 * self.block + n].view(shape)
                for b0, n, (shape, _) in zip(self.block0, self.numels,
                                             self.key)]

    def leaf_views(self, flat):
        """Each leaf, a view of the unpadded flat buffer."""
        return [flat[off:off + n].view(shape)
                for off, n, (shape, _) in zip(self.offsets, self.numels,
                                              self.key)]

    def pack(self, leaves, device):
        """The padded flat fp32 residual holding ``leaves``."""
        flat = torch.zeros(self.n_rows * self.block, dtype=torch.float32,
                           device=device)
        for view, leaf in zip(self.residual_views(flat), leaves):
            view.copy_(leaf)
        return flat

    def device_tables(self, grads, device):
        """(segment table, row-to-leaf map, data pointers) on ``device``."""
        if self._tables is None:
            table = torch.tensor(
                [[n, b0, off, _DTYPES[dtype]] for n, b0, off, (_, dtype) in
                 zip(self.numels, self.block0, self.offsets, self.key)],
                dtype=torch.int64).reshape(-1, 4)
            leaf_of = torch.repeat_interleave(
                torch.arange(len(self.numels), dtype=torch.int32),
                torch.tensor(self.blocks, dtype=torch.int64))
            self._tables = (table.to(device), leaf_of.to(device))
        ptrs = [g.data_ptr() for g in grads]
        if ptrs != self._ptrs[0]:
            self._ptrs = (ptrs, torch.tensor(ptrs, dtype=torch.int64)
                          .pin_memory().to(device, non_blocking=True))
        return (*self._tables, self._ptrs[1])


def _segment_operands(grads, resid, layout):
    """True for operands on the card (checked; raises on what the kernels
    do not take), False for CPU operands."""
    if resid.device.type == "cpu":
        return False
    if resid.device.type != "cuda":
        raise ValueError(f"unsupported device {resid.device}")
    if not layout.matches(grads):
        raise ValueError("the gradients do not match the segment layout")
    if layout.block % 4:
        raise ValueError(f"block {layout.block} is not a multiple of 4")
    if resid.dtype != torch.float32 or not resid.is_contiguous() \
            or resid.shape != (layout.n_rows * layout.block,) \
            or resid.data_ptr() % 16:
        raise ValueError(f"resid must be a contiguous, 16-byte aligned "
                         f"({layout.n_rows * layout.block},) fp32 tensor")
    for g in grads:
        if g.device != resid.device:
            raise ValueError(f"a gradient is on {g.device}, resid on "
                             f"{resid.device}")
        if g.dtype not in _DTYPES:
            raise TypeError(f"unsupported dtype {g.dtype}; the kernels "
                            f"take {sorted(map(str, _DTYPES))}")
    return True


def segment_norms(grads, resid, layout, threshold):
    """MLLess's significance test over every leaf at once.

    grads: the gradient leaves (fp32 or bf16, shapes ``layout.key``);
    resid: the padded flat fp32 residual.  With acc = g.float() + r cut
    into ``layout.block``-wide rows, returns each row's fp32 sum of
    squares (n_rows,), its mask sqrt(sq) > threshold * the leaf's RMS row
    norm (n_rows,) bool, and each leaf's count of significant rows
    (n_leaves,) int64."""
    if not _segment_operands(grads, resid, layout):
        return _ref.segment_norms(grads, resid, layout, threshold)
    dev = resid.device
    sq = torch.empty(layout.n_rows, dtype=torch.float32, device=dev)
    mask = torch.empty(layout.n_rows, dtype=torch.bool, device=dev)
    counts = torch.empty(len(layout.numels), dtype=torch.int64, device=dev)
    if not layout.numels:
        return sq, mask, counts
    grads = [g.contiguous() for g in grads]
    lib = _build._library("block_significance", _SIGNATURES)
    with torch.cuda.device(dev):
        table, leaf_of, ptrs = layout.device_tables(grads, dev)
        err = lib.rt_segment_norms(
            table.data_ptr(), ptrs.data_ptr(), leaf_of.data_ptr(),
            len(layout.numels), layout.n_rows, layout.block,
            resid.data_ptr(), threshold, sq.data_ptr(), mask.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(err, "segment_norms")
    LAUNCHES["segment_norms"] += 1
    return sq, mask, counts


def segment_filter(grads, resid, layout, mask):
    """MLLess's filter over every leaf at once: with acc = g.float() + r
    as in ``segment_norms`` and ``mask`` its row mask, returns (kept, the
    unpadded flat fp32 acc * mask, every leaf at its offset; the new
    padded flat fp32 residual acc - kept)."""
    if not _segment_operands(grads, resid, layout):
        return _ref.segment_filter(grads, resid, layout, mask)
    if mask.shape != (layout.n_rows,) or mask.dtype != torch.bool \
            or mask.device != resid.device or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous ({layout.n_rows},) "
                         f"bool tensor on {resid.device}")
    dev = resid.device
    kept = torch.empty(layout.numel, dtype=torch.float32, device=dev)
    new_resid = torch.empty_like(resid)
    if not layout.n_rows:
        return kept, new_resid
    grads = [g.contiguous() for g in grads]
    lib = _build._library("block_significance", _SIGNATURES)
    with torch.cuda.device(dev):
        table, leaf_of, ptrs = layout.device_tables(grads, dev)
        err = lib.rt_segment_filter(
            table.data_ptr(), ptrs.data_ptr(), leaf_of.data_ptr(),
            layout.n_rows, layout.block, resid.data_ptr(), mask.data_ptr(),
            kept.data_ptr(), new_resid.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(err, "segment_filter")
    LAUNCHES["segment_filter"] += 1
    return kept, new_resid
