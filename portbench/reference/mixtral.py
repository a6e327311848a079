"""Plain fp32 reference of the Mixtral family: a decoder of pre-norm
layers, each grouped-query attention with RoPE over a causal sliding
window and a top-k mixture of SwiGLU experts with capacity, as
arXiv:2401.04088 describes and the program runs it.

Routing as the configuration states: the router's softmax in fp32,
the k largest probabilities in a stable descending order (a tie keeps
the lower expert), gates renormalised over the k, each expert taking
(token, slot) pairs in token-major order up to its capacity
``max(8, ceil8(int(capacity_factor * k * T / E)))`` and dropping the
rest, and the load-balance loss ``router_aux_coef * E * sum(me * ce)``
added to the loss.  Leaves are named as the program's state dict names
them (``blocks.<j>.<path>``, a leading dim over the pattern's blocks).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (cross_entropy, mm, padded_vocab,
                                        rmsnorm, rope)


def leaf_specs(cfg: dict) -> dict:
    """{name: (shape, dtype, init)} of every leaf."""
    d, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    f, E, dt = cfg["d_ff"], cfg["n_experts"], cfg["dtype"]
    P = len(cfg["layer_pattern"])
    if cfg["n_layers"] % P:
        raise ValueError("the depth must be whole pattern blocks")
    nb = cfg["n_layers"] // P
    V = padded_vocab(cfg)
    specs = {"embed.table": ((V, d), dt, ("normal", 0.02)),
             "unembed.table": ((d, V), dt, ("normal", d ** -0.5)),
             "final_norm": ((d,), "float32", ("normal", 0.1))}
    for j in range(P):
        b = f"blocks.{j}."
        specs.update({
            b + "attn.wq": ((nb, d, H * hd), dt, ("normal", d ** -0.5)),
            b + "attn.wk": ((nb, d, KV * hd), dt, ("normal", d ** -0.5)),
            b + "attn.wv": ((nb, d, KV * hd), dt, ("normal", d ** -0.5)),
            b + "attn.wo": ((nb, H * hd, d), dt, ("normal",
                                                  (H * hd) ** -0.5)),
            b + "moe.router": ((nb, d, E), "float32", ("normal", 0.02)),
            b + "moe.w_gate": ((nb, E, d, f), dt, ("normal", d ** -0.5)),
            b + "moe.w_up": ((nb, E, d, f), dt, ("normal", d ** -0.5)),
            b + "moe.w_down": ((nb, E, f, d), dt, ("normal", f ** -0.5)),
            b + "norm1": ((nb, d), "float32", ("normal", 0.1)),
            b + "norm2": ((nb, d), "float32", ("normal", 0.1)),
        })
    return specs


def _attend(q, k, v, window, cast):
    """One kv head's group: q (S, G, hd), k and v (S, hd) -> (S, G, hd),
    softmax over the causal window."""
    S, hd = q.shape[0], q.shape[-1]
    s = torch.einsum("sgd,td->gst", cast(q), cast(k)) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("gst,td->sgd", cast(p), cast(v))


def attention(p, x, cfg, window, cast):
    B, S, d = x.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    G = H // KV
    q = rope(mm(x, p["attn.wq"], cast).view(B, S, H, hd), cfg["rope_theta"])
    k = rope(mm(x, p["attn.wk"], cast).view(B, S, KV, hd),
             cfg["rope_theta"])
    v = mm(x, p["attn.wv"], cast).view(B, S, KV, hd)
    q = q.view(B, S, KV, G, hd)
    # one (row, kv head) at a time, recomputed in the backward, so no
    # more than one S x S score block is held
    o = torch.stack([torch.stack([
        checkpoint(_attend, q[b, :, h], k[b, :, h], v[b, :, h], window, cast,
                   use_reentrant=False)
        for h in range(KV)], dim=1) for b in range(B)])
    return mm(o.reshape(B, S, H * hd), p["attn.wo"], cast)


def capacity(cfg: dict, T: int) -> int:
    k, E = cfg["experts_per_token"], cfg["n_experts"]
    c = int(cfg["capacity_factor"] * k * T / E)
    return max(8, -(-c // 8) * 8)


def moe(p, x, cfg, cast):
    """Top-k experts with capacity: (y like x, the load-balance loss)."""
    B, S, d = x.shape
    E, k = cfg["n_experts"], cfg["experts_per_token"]
    T = B * S
    xf = x.reshape(T, d)
    probs = torch.softmax(xf @ p["moe.router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    counts = F.one_hot(experts, E).float().sum(dim=1).mean(dim=0)
    aux = cfg["router_aux_coef"] * E * torch.sum(probs.mean(dim=0) * counts)
    flat = experts.reshape(-1)                      # (T * k,) token-major
    onehot = F.one_hot(flat, E)
    place = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    kept = place < capacity(cfg, T)
    gate_flat = gates.reshape(-1)
    y = torch.zeros_like(xf)
    for e in range(E):
        pairs = torch.nonzero((flat == e) & kept)[:, 0]
        tok = pairs // k
        h = xf[tok]
        out = mm(F.silu(mm(h, p["moe.w_gate"][e], cast))
                 * mm(h, p["moe.w_up"][e], cast), p["moe.w_down"][e], cast)
        y = y.index_add(0, tok, out * gate_flat[pairs][:, None])
    return y.view(B, S, d), aux


def loss(params: dict, batch: dict, cfg: dict, cast) -> torch.Tensor:
    """The training loss of one shard: cross-entropy over its tokens plus
    the layers' load-balance losses."""
    x = params["embed.table"][batch["tokens"].long()]
    pattern = cfg["layer_pattern"]
    nb = cfg["n_layers"] // len(pattern)
    aux = 0.0
    for i in range(nb):
        for j, kind in enumerate(pattern):
            pre = f"blocks.{j}."
            p = {n[len(pre):]: t[i] for n, t in params.items()
                 if n.startswith(pre)}
            window = cfg["window"] if kind == "local" else None
            x = x + attention(p, rmsnorm(x, p["norm1"]), cfg, window, cast)
            y, a = moe(p, rmsnorm(x, p["norm2"]), cfg, cast)
            x, aux = x + y, aux + a
    logits = mm(rmsnorm(x, params["final_norm"]), params["unembed.table"],
                cast)
    return cross_entropy(logits, batch["labels"]) + aux
