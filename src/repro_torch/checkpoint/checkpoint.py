"""Checkpoints in the reference's MessagePack format
(``repro.checkpoint``).

A checkpoint is one blob, ``{"treedef": str, "leaves": [{"dtype",
"shape", "data"}, ...]}``, packed as ``msgpack.packb(payload,
use_bin_type=True)`` packs it (``codec``).  The leaves are a tree's in
``jax.tree.leaves`` order (dict keys sorted, lists and tuples in order)
and ``treedef`` is ``str(jax.tree.structure(tree))`` of the same tree
(``treedef``), so a file the port writes is the file the reference writes
for the same state, and each reads the other's.  ``dtype`` is numpy's
name of the leaf's type; a bf16 leaf is written from its bits as int16 and
named ``"bfloat16"``, as ``ml_dtypes`` names it, and never passes through
numpy as bf16.

``dumps``/``loads`` give the blob itself, which the resilience harness
partitions into its in-memory store (``repro_torch.resilience.store``);
``save``/``restore`` put it in a file.  ``loads`` places each leaf on the
device and in the dtype of the matching leaf of ``like``: a tensor on the
``meta`` device describes a target without allocating it (the
reference's ``jax.ShapeDtypeStruct``) and its leaf stays on the host; a
numpy ``like`` leaf gives a numpy array.  Restored leaves are writable:
each is copied out of the blob, never a view of it.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, List

import numpy as np
import torch

from repro_torch.checkpoint import codec

_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _is_leaf(x) -> bool:
    return not (x is None or isinstance(x, (dict, list, tuple)))


def flatten(tree) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples (``None`` is an
    empty node, as in JAX), in ``jax.tree.leaves`` order."""
    if _is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    kids = ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
            else list(tree))
    return [leaf for kid in kids for leaf in flatten(kid)]


def unflatten(like, leaves) -> Any:
    """``like``'s structure with ``leaves`` in ``flatten`` order."""
    it = iter(leaves)

    def build(node):
        if _is_leaf(node):
            return next(it)
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        kids = [build(v) for v in node]
        return tuple(kids) if isinstance(node, tuple) else kids

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef(tree) -> str:
    """``str(jax.tree.structure(tree))`` for a tree of dicts, lists and
    tuples: ``PyTreeDef({'a': *, 'b': [*, (*,)], 'c': []})``."""
    def fmt(node):
        if _is_leaf(node):
            return "*"
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        inner = ", ".join(fmt(v) for v in node)
        if isinstance(node, list):
            return f"[{inner}]"
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    return f"PyTreeDef({fmt(tree)})"


def _record(leaf) -> dict:
    """A leaf's ``{"dtype", "shape", "data"}`` record.  A tensor's bytes
    are copied (from the card, if it is there) straight into the blob; a
    bf16 tensor's as its int16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        raw = t.reshape(-1).view(torch.int16 if t.dtype == torch.bfloat16
                                 else t.dtype).view(torch.uint8)

        def fill(view):
            torch.frombuffer(view, dtype=torch.uint8).copy_(raw)
        return {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                "data": codec.Reserved(raw.numel(), fill)}
    arr = np.asarray(leaf, order="C")
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": memoryview(arr.reshape(-1).view(np.uint8))}


def dumps(tree: Any):
    """Serialize a tree to one blob: ``bytes``, or a ``bytearray`` when
    it holds tensors, whose bytes are copied once, into the blob."""
    return codec.packb({"treedef": treedef(tree),
                        "leaves": [_record(l) for l in flatten(tree)]})


def save(path: str, tree: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(dumps(tree))
    os.replace(tmp, path)


def _decode(rec: dict, ref) -> Any:
    """One stored record as a leaf placed like ``ref``."""
    shape = tuple(rec["shape"])
    if tuple(ref.shape) != shape:
        raise ValueError(f"shape mismatch {shape} vs {tuple(ref.shape)}")
    name, data = rec["dtype"], rec["data"]
    if isinstance(ref, np.ndarray):
        if name not in np.sctypeDict:
            raise TypeError(f"numpy has no dtype {name!r}")
        arr = np.frombuffer(bytearray(data), dtype=name).reshape(shape)
        return arr.astype(ref.dtype, copy=False)
    if name not in _DTYPES:
        raise TypeError(f"no torch dtype for checkpoint dtype {name!r}")
    dev = torch.device("cpu") if ref.device.type == "meta" else ref.device
    if len(data) == 0:
        t = torch.empty(shape, dtype=_DTYPES[name])
    elif dev.type == "cpu":
        t = torch.frombuffer(bytearray(data), dtype=_DTYPES[name])
    else:
        # read-only view of the blob: the copy to the device is the copy
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            t = torch.frombuffer(data, dtype=_DTYPES[name])
    return t.reshape(shape).to(device=dev, dtype=ref.dtype)


def loads(data, like: Any) -> Any:
    """Deserialize into the structure of ``like``, each leaf on the
    device and in the dtype of ``like``'s leaf.  The stored treedef must
    equal ``like``'s exactly, and every shape must match."""
    payload = codec.unpackb(data)
    stored, want = payload["treedef"], treedef(like)
    if stored != want:
        raise ValueError(
            f"checkpoint treedef does not match the restore template:\n"
            f"  stored: {stored}\n"
            f"  like:   {want}")
    refs = flatten(like)
    recs = payload["leaves"]
    if len(recs) != len(refs):
        raise ValueError(f"{len(recs)} stored leaves, {len(refs)} in like")
    return unflatten(like, [_decode(r, ref) for r, ref in zip(recs, refs)])


def restore(path: str, like: Any) -> Any:
    """Restore the file at ``path`` into the structure of ``like``."""
    with open(path, "rb") as f:
        return loads(f.read(), like)


def stored_treedef(data) -> str:
    """The treedef string a blob was written with."""
    return codec.unpackb(data)["treedef"]

