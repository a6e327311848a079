"""Plain fp32 reference of the RWKV-6 family as the program runs it: pre-norm
layers of the time-mix (a token shift mixed per channel, r, k, v and a
SiLU gate, the data-dependent decay ``w = exp(-exp(base + lora(x)))``)
and the WKV recurrence of arXiv:2404.05892, per head of size N

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

from a zero state, then the gate and the output projection; the
channel-mix is a tanh-GELU MLP (the program's stand-in for RWKV's
squared-ReLU channel-mix).  The recurrence is computed exactly in chunks
of ``CHUNK`` steps: inside a chunk by the pairwise decays, which never
exceed 1, across chunks through the state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (cross_entropy, mm, padded_vocab,
                                        rmsnorm)

CHUNK = 32


def leaf_specs(cfg: dict) -> dict:
    d, f, dt = cfg["d_model"], cfg["d_ff"], cfg["dtype"]
    N, r = cfg["rwkv_head_dim"], cfg["rwkv_lora_rank"]
    nb = cfg["n_layers"]
    if cfg["layer_pattern"] != ["rwkv"]:
        raise ValueError("the reference runs a pattern of RWKV layers")
    V = padded_vocab(cfg)
    b = "blocks.0."
    specs = {"embed.table": ((V, d), dt, ("normal", 0.02)),
             "unembed.table": ((d, V), dt, ("normal", d ** -0.5)),
             "final_norm": ((d,), "float32", ("normal", 0.1)),
             b + "norm1": ((nb, d), "float32", ("normal", 0.1)),
             b + "norm2": ((nb, d), "float32", ("normal", 0.1)),
             b + "mlp.w_up": ((nb, d, f), dt, ("normal", d ** -0.5)),
             b + "mlp.w_down": ((nb, f, d), dt, ("normal", f ** -0.5)),
             b + "rwkv.decay_a": ((nb, d, r), dt, ("normal", d ** -0.5)),
             b + "rwkv.decay_b": ((nb, r, d), dt, ("normal",
                                                  0.1 * r ** -0.5)),
             b + "rwkv.decay_base": ((nb, d), "float32", ("uniform", -6.0,
                                                         -1.0)),
             b + "rwkv.bonus_u": ((nb, d // N, N), "float32",
                                  ("normal", 0.5)),
             b + "rwkv.mix": ((nb, 5, d), "float32", ("uniform", 0.0, 1.0))}
    for w in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        specs[b + "rwkv." + w] = ((nb, d, d), dt, ("normal", d ** -0.5))
    return specs


def wkv(r, k, v, logw, u, chunk=CHUNK):
    """r, k, v, logw: (B, T, H, N); u: (H, N) -> y (B, T, H, N)."""
    B, T, H, N = r.shape
    c = min(chunk, T)
    while T % c:
        c -= 1
    S = r.new_zeros(B, H, N, N)
    t = torch.arange(c, device=r.device)
    below = (t[:, None] > t[None, :])[None, :, :, None, None]
    ys = []
    for a in range(0, T, c):
        rc, kc, vc, lw = (x[:, a:a + c] for x in (r, k, v, logw))
        L = torch.cumsum(lw, dim=1)                  # decay through step t
        Lx = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], dim=1)
        y = torch.einsum("bthn,bhnm->bthm", rc * torch.exp(Lx), S)
        gap = torch.where(below, Lx[:, :, None] - L[:, None],
                          torch.tensor(float("-inf"), device=r.device))
        att = (rc[:, :, None] * kc[:, None] * torch.exp(gap)).sum(-1)
        y = y + torch.einsum("btsh,bshn->bthn", att, vc)
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
        end = L[:, -1]
        S = torch.exp(end)[..., None] * S + torch.einsum(
            "bshn,bshm->bhnm", kc * torch.exp(end[:, None] - L), vc)
        ys.append(y)
    return torch.cat(ys, dim=1)


def time_mix(p, x, cfg, cast):
    B, T, d = x.shape
    N = cfg["rwkv_head_dim"]
    H = d // N
    shifted = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    mix = p["rwkv.mix"]
    xr, xk, xv, xg, xw = (x * mix[i] + shifted * (1 - mix[i])
                          for i in range(5))
    r = mm(xr, p["rwkv.w_r"], cast).view(B, T, H, N)
    k = mm(xk, p["rwkv.w_k"], cast).view(B, T, H, N)
    v = mm(xv, p["rwkv.w_v"], cast).view(B, T, H, N)
    g = F.silu(mm(xg, p["rwkv.w_g"], cast))
    lora = mm(mm(xw, p["rwkv.decay_a"], cast), p["rwkv.decay_b"], cast)
    logw = -torch.exp(p["rwkv.decay_base"] + lora).view(B, T, H, N)
    y = wkv(r, k, v, logw, p["rwkv.bonus_u"]).reshape(B, T, d)
    return mm(y * g, p["rwkv.w_o"], cast)


def _layer(x, p, cfg, cast):
    x = x + time_mix(p, rmsnorm(x, p["norm1"]), cfg, cast)
    h = rmsnorm(x, p["norm2"])
    return x + mm(F.gelu(mm(h, p["mlp.w_up"], cast), approximate="tanh"),
                  p["mlp.w_down"], cast)


def loss(params: dict, batch: dict, cfg: dict, cast) -> torch.Tensor:
    x = params["embed.table"][batch["tokens"].long()]
    pre = "blocks.0."
    for i in range(cfg["n_layers"]):
        p = {n[len(pre):]: t[i] for n, t in params.items()
             if n.startswith(pre)}
        # each layer recomputed in the backward: one layer's chunks held
        x = checkpoint(_layer, x, p, cfg, cast, use_reentrant=False)
    logits = mm(rmsnorm(x, params["final_norm"]), params["unembed.table"],
                cast)
    return cross_entropy(logits, batch["labels"])
