"""Transformer building blocks (``repro.models.layers``): initialisers,
RMSNorm, rotary embeddings, MLPs, embedding and unembedding.

Functions over tensors, with the reference's layouts and numerics:

* weights are ``(in, out)`` and applied as ``x @ w``;
* RMSNorm takes its statistics in fp32, eps 1e-6, and scales by
  ``(1 + w)`` with ``w`` an fp32 vector initialised to zeros;
* RoPE rotates the two halves of the head (not interleaved pairs), with
  frequencies ``1 / theta ** (arange(half) / half)`` in fp32;
* the GELU MLP uses the tanh approximation (``jax.nn.gelu``'s default);
* sinusoidal positions (the encoder-decoder's, in place of RoPE) are
  fp32, ``sin`` halves then ``cos`` halves.

Under tensor parallelism (``tp``, a ``models.tp.TensorParallel``) the
norm, MLP, embedding and unembedding take this rank's slices of their
leaves and replicated activations (``models.tp``); with ``tp=None`` they
are the plain functions.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initialisers (fp32 normal draws cast to the parameter dtype; the
# reference's ``jax.random`` draws cannot be reproduced, so parity starts
# from the reference's parameters)
# ---------------------------------------------------------------------------
def dense_init(gen, shape, dtype, scale=None):
    """Normal * 1/sqrt(fan_in), fan_in = shape[-2] (the input dim of one
    (in, out) weight, also of a stacked (n, in, out) one)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def embed_init(gen, shape, dtype):
    return (torch.randn(shape, generator=gen) * 0.02).to(dtype)


def rmsnorm_init(*shape):
    return torch.zeros(shape, dtype=torch.float32)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6, tp=None):
    if tp is not None:
        w = tp.whole(w, (x.shape[-1],))
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim, theta, device=None):
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)     # an fp32 power of a scalar base


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_frequencies(hd, theta, x.device)            # (half,)
    angles = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:2 * half].float()
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    out = torch.cat([rot1, rot2, x[..., 2 * half:].float()], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len, d_model, device=None):
    """(seq_len, d_model) fp32, built in float64 numpy and cast, as the
    reference builds it."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d_model)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


def sinusoidal_position_at(pos, d_model):
    """The sinusoidal embedding of a position tensor (0-dim or (B,)), in
    fp32 arithmetic: (..., d_model)."""
    pos = torch.as_tensor(pos)
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=pos.device)
    angle = pos.float()[..., None] / torch.pow(
        torch.tensor(10_000.0, device=pos.device), 2 * dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_init(gen, d_model, d_ff, kind, dtype, lead=()):
    """``lead`` prepends a stacking dim (the layers of a scanned block)."""
    if kind == "swiglu":
        return {"w_gate": dense_init(gen, (*lead, d_model, d_ff), dtype),
                "w_up": dense_init(gen, (*lead, d_model, d_ff), dtype),
                "w_down": dense_init(gen, (*lead, d_ff, d_model), dtype)}
    return {"w_up": dense_init(gen, (*lead, d_model, d_ff), dtype),
            "w_down": dense_init(gen, (*lead, d_ff, d_model), dtype)}


def mlp_apply(p, x, kind, tp=None, d_ff=None):
    """The MLP of replicated x; under ``tp`` (``d_ff`` the global width)
    column-parallel up (and gate) projections, the activation on this
    rank's ``d_ff`` slice and a row-parallel down projection, one
    all-reduce; a weight laid out otherwise is used whole."""
    if tp is not None:
        d = x.shape[-1]
        shapes = {"w_gate": (d, d_ff), "w_up": (d, d_ff),
                  "w_down": (d_ff, d)}
        dims = {k: tp.dim_of(w, shapes[k]) for k, w in p.items()}
        if dims == {**{k: 1 for k in p}, "w_down": 0}:
            xc = tp.copy(x)
            if kind == "swiglu":
                h = F.silu(xc @ p["w_gate"]) * (xc @ p["w_up"])
            else:
                h = F.gelu(xc @ p["w_up"], approximate="tanh")
            return tp.reduce(h @ p["w_down"])
        p = {k: tp.whole(w, shapes[k]) for k, w in p.items()}
    if kind == "swiglu":
        gate = F.silu(x @ p["w_gate"])
        return (gate * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed(table, tokens, tp=None, shape=None):
    """tokens: int32 or int64 ids -> rows of ``table`` (of global
    ``shape`` under ``tp``: vocab-parallel where its rows are sharded)."""
    if tp is not None:
        return tp.embed(table, tokens, shape)
    return F.embedding(tokens, table)


def unembed(table, x, tp=None, shape=None):
    """A separate (d_model, vocab) head: ``x @ table``; under ``tp``, this
    rank's vocab columns of the logits where the head's columns are
    sharded (``TensorParallel.unembed``)."""
    if tp is not None:
        return tp.unembed(table, x, shape)
    return x @ table
