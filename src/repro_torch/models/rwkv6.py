"""RWKV-6 (Finch) time-mix block (``repro.models.rwkv6``): a linear
recurrence with data-dependent per-channel decay [arXiv:2404.05892].

Per head (head dim N):   S_t = diag(w_t) S_{t-1} + k_t^T v_t
                         y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(logw_t) in (0, 1) from a token-shifted low-rank projection.
The sequence form is chunked: within a chunk a masked product with decay
ratios, across chunks the state (``wkv_chunked``, plain PyTorch, the
reference's ``wkv_chunked_jnp`` with its ``chunk_step``).  With ``use_kernel`` a fresh-state call
whose length is a multiple of 64 goes through ``kernels.ops.wkv6``, the
Hopper kernel, exactly where the reference takes its Pallas kernel; its
backward recomputes through ``wkv_chunked`` at chunk 128 from a zero state,
as the reference's ``_wkv_bwd`` does (the reference has no backward
kernel).  Decode is the exact single-step recurrence on a (B, H, N, N)
state.

Under tensor parallelism (``tp``, ``models.tp``) the sequence form runs
the WKV (kernel 9 where the reference takes its kernel) on this rank's
H/M heads, and decode advances this rank's slice of the state along the
N dim the cache is sharded on (``_rwkv_apply_tp``, ``_rwkv_decode_tp``).

The reference's mixed-dtype products are kept: the token-shift mixing runs
in x's dtype (``mix`` is cast to it), logw is fp32, and the fp32 WKV output
times the gate meets ``w_o`` in an fp32 product (JAX promotes a bf16
``w_o``; torch would refuse the mixed product) before the cast to x's
dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers

KERNEL_CHUNK = 64       # the reference's gate: T % 64 == 0 takes the kernel
BACKWARD_CHUNK = 128    # the chunk of the kernel's recompute (``_wkv_bwd``)


def rwkv_init(gen, cfg, dtype, lead=()):
    """The reference's leaves and dtypes (``lead`` prepends the stacking
    dim of a scanned block)."""
    d = cfg.d_model
    N = cfg.rwkv_head_dim
    H = d // N
    r = cfg.rwkv_lora_rank

    def dense(*shape):
        return layers.dense_init(gen, (*lead, *shape), dtype)
    return {
        "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d),
        "w_g": dense(d, d), "w_o": dense(d, d),
        # data-dependent decay: low-rank projection of the shifted x
        "decay_a": dense(d, r), "decay_b": dense(r, d),
        "decay_base": torch.full((*lead, d), -6.0),   # w ~ exp(-exp(-6))
        "bonus_u": torch.zeros((*lead, H, N)),
        "mix": torch.full((*lead, 5, d), 0.5),         # token-shift mixing
    }


def rwkv_init_state(cfg, batch, dtype, device=None):
    d = cfg.d_model
    N = cfg.rwkv_head_dim
    H = d // N
    return {"S": torch.zeros((batch, H, N, N), dtype=torch.float32,
                             device=device),
            "x_last": torch.zeros((batch, d), dtype=dtype, device=device)}


def _token_shift(x, x_prev_last):
    """out_t = x_{t-1}; position 0 takes the carry."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _project(p, x, prev_last):
    """r, k, v, g and logw for a run of tokens. x: (B, T, d)."""
    xs = _token_shift(x, prev_last)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (x * mix[i] + xs * (1 - mix[i]) for i in range(5))
    r = xr @ p["w_r"]
    k = xk @ p["w_k"]
    v = xv @ p["w_v"]
    g = F.silu(xg @ p["w_g"])
    # decay in (0, 1): w = exp(-exp(base + lora(xw)))
    dw = (xw @ p["decay_a"]) @ p["decay_b"]
    logw = -torch.exp(p["decay_base"].float() + dw.float())
    return r, k, v, g, logw


def _chunk_step(rr, kk, vv, lw, u, S):
    """One chunk (the reference's ``chunk_step``): rr, kk, vv, lw (B, c, H,
    N) fp32, u (H, N), S (B, H, N, N) the state before the chunk.  Returns
    (y (B, c, H, N), S after the chunk)."""
    c = rr.shape[1]
    # cumulative log-decay inclusive of step t, and the exclusive one: L
    # shifted by one step, not the reference's L - lw, which under strong
    # decay misses L_{t-1} by an ulp of a large |L| that the exp turns into
    # a relative error near 1e-4
    L = torch.cumsum(lw, dim=1)
    Lprev = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], dim=1)
    # inter-chunk: y_inter[t] = (r_t * exp(L_{t-1})) @ S_prev
    y_inter = torch.einsum("bthn,bhnm->bthm", rr * torch.exp(Lprev), S)
    # intra-chunk: att[t,s] = sum_n r_t[n] exp(L_{t-1}-L_s)[n] k_s[n], s<t;
    # the pairwise difference is <= 0 below the diagonal and is masked to
    # -inf above it before the exp (positive there, it would overflow)
    tidx = torch.arange(c, device=rr.device)
    mask = (tidx[:, None] > tidx[None, :])[None, :, :, None, None]
    diff = torch.where(mask, Lprev[:, :, None] - L[:, None],
                       torch.tensor(float("-inf"), device=rr.device))
    a = torch.sum(rr[:, :, None] * kk[:, None] * torch.exp(diff), dim=-1)
    y_intra = torch.einsum("btsh,bshn->bthn", a, vv)
    # bonus (current token): y += (r_t . (u * k_t)) v_t
    y_bonus = torch.sum(rr * u * kk, dim=-1, keepdim=True) * vv
    # state update: S_new = diag(exp(L_c)) S + sum_s exp(L_c - L_s) k_s v_s
    L_last = L[:, -1]                                       # (B, H, N)
    k_dec = kk * torch.exp(L_last[:, None] - L)
    S_new = torch.exp(L_last)[..., None] * S + torch.einsum(
        "bshn,bshm->bhnm", k_dec, vv)
    return y_inter + y_intra + y_bonus, S_new


def wkv_chunked(rr, kk, vv, lw, u, S0, chunk=128):
    """The chunked WKV core (``wkv_chunked_jnp``).  rr, kk, vv, lw:
    (B, T, H, N) fp32; u: (H, N); S0: (B, H, N, N).  Returns (y, S_final).
    A T that is not a multiple of the chunk runs its remainder as one
    shorter chunk."""
    T = rr.shape[1]
    c = min(chunk, T)
    if T % c:
        T_main = (T // c) * c
        if T_main:
            y1, S = wkv_chunked(rr[:, :T_main], kk[:, :T_main],
                                vv[:, :T_main], lw[:, :T_main], u, S0,
                                chunk=c)
            y2, S = wkv_chunked(rr[:, T_main:], kk[:, T_main:],
                                vv[:, T_main:], lw[:, T_main:], u, S,
                                chunk=T - T_main)
            return torch.cat([y1, y2], dim=1), S
        c = T
    ys, S = [], S0
    for t0 in range(0, T, c):
        y, S = _chunk_step(rr[:, t0:t0 + c], kk[:, t0:t0 + c],
                           vv[:, t0:t0 + c], lw[:, t0:t0 + c], u, S)
        ys.append(y)
    return torch.cat(ys, dim=1), S


class _WkvKernel(torch.autograd.Function):
    """Forward: ``ops.wkv6`` (the kernel on the card, its plain twin on the
    CPU).  Backward: autograd through ``wkv_chunked`` at chunk 128 from a
    zero state (the reference's ``_wkv_bwd``)."""

    @staticmethod
    def forward(ctx, rr, kk, vv, lw, u):
        ctx.save_for_backward(rr, kk, vv, lw, u)
        return kops.wkv6(rr, kk, vv, lw, u)

    @staticmethod
    def backward(ctx, gy):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        B, _, H, N = ins[0].shape
        S0 = torch.zeros((B, H, N, N), dtype=torch.float32,
                         device=gy.device)
        with torch.enable_grad():
            y, _ = wkv_chunked(*ins, S0, chunk=BACKWARD_CHUNK)
        return torch.autograd.grad(y, ins, gy)


def rwkv_apply(p, x, cfg, state=None, chunk=128, use_kernel=False,
               with_state=True, tp=None):
    """Full-sequence (train / prefill) form.  x: (B, T, d); ``state`` a
    dict from an earlier call or None (zeros).  Returns (y in x's dtype,
    new state), the state None when not ``with_state``: the kernel path
    builds the final state only for a caller that uses it.  ``tp``: tensor
    parallelism (the module docstring)."""
    if tp is not None:
        return _rwkv_apply_tp(p, x, cfg, state, chunk, use_kernel,
                              with_state, tp)
    B, T, d = x.shape
    N = cfg.rwkv_head_dim
    H = d // N
    fresh = state is None
    if fresh:
        state = rwkv_init_state(cfg, B, x.dtype, x.device)
    r, k, v, g, logw = _project(p, x, state["x_last"])
    rr, kk, vv = (t.reshape(B, T, H, N).float() for t in (r, k, v))
    lw = logw.reshape(B, T, H, N)
    u = p["bonus_u"].float()
    S_fin = None
    if use_kernel and fresh and T % KERNEL_CHUNK == 0:
        y = _WkvKernel.apply(rr, kk, vv, lw, u)
        if with_state:
            # from a zero state: S_T = sum_s exp(L_T - L_s) k_s v_s^T
            L = torch.cumsum(lw, dim=1)
            k_dec = kk * torch.exp(L[:, -1:] - L)
            S_fin = torch.einsum("bthn,bthm->bhnm", k_dec, vv)
    else:
        y, S_fin = wkv_chunked(rr, kk, vv, lw, u, state["S"], chunk=chunk)
    y = y.reshape(B, T, d) * g.float()
    out = (y @ p["w_o"].float()).to(x.dtype)
    if not with_state:
        return out, None
    return out, {"S": S_fin, "x_last": x[:, -1, :]}


def rwkv_decode_step(p, x, cfg, state, tp=None):
    """The exact single-token recurrence. x: (B, 1, d)."""
    if tp is not None:
        return _rwkv_decode_tp(p, x, cfg, state, tp)
    B, _, d = x.shape
    N = cfg.rwkv_head_dim
    H = d // N
    r, k, v, g, logw = _project(p, x, state["x_last"])
    rr, kk, vv = (t.reshape(B, H, N).float() for t in (r, k, v))
    w = torch.exp(logw.reshape(B, H, N))
    u = p["bonus_u"].float()
    S = state["S"]                                          # (B, H, N, N)
    kv = torch.einsum("bhn,bhm->bhnm", kk, vv)
    y = torch.einsum("bhn,bhnm->bhm", rr, S + u[None, :, :, None] * kv)
    S_new = w[..., None] * S + kv
    y = y.reshape(B, 1, d) * g.float()
    return ((y @ p["w_o"].float()).to(x.dtype),
            {"S": S_new, "x_last": x[:, -1, :]})


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
_PROJ = ("w_r", "w_k", "w_v", "w_g")


def _shapes(cfg):
    d, N, r = cfg.d_model, cfg.rwkv_head_dim, cfg.rwkv_lora_rank
    return {"w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
            "w_o": (d, d), "decay_a": (d, r), "decay_b": (r, d),
            "decay_base": (d,), "bonus_u": (d // N, N), "mix": (5, d)}


def _rows_sharded(p, cfg, tp):
    """Whether the projections and the decay LoRA's first factor are
    row-parallel (``param_pspecs`` puts the model axis on the input dim of
    the square ones, and on d of ``decay_a``)."""
    shapes = _shapes(cfg)
    return all(tp.dim_of(p[n], shapes[n]) == 0
               for n in _PROJ + ("w_o", "decay_a"))


def _whole_leaves(p, cfg, tp):
    shapes = _shapes(cfg)
    return {n: tp.whole(t, shapes[n]) for n, t in p.items()}


def _state_shapes(cfg, B):
    d, N = cfg.d_model, cfg.rwkv_head_dim
    return {"S": (B, d // N, N, N), "x_last": (B, d)}


def _rwkv_apply_tp(p, x, cfg, state, chunk, use_kernel, with_state, tp):
    """``rwkv_apply`` over the model group: the WKV on this rank's H/M
    heads.  The square projections are row-parallel on this rank's slice
    of the features (the token shift and the mixing run on that slice) and
    end in one reduce-scatter onto this rank's heads (d = H x N is
    head-major); the decay LoRA's first product all-reduces its (B, T, r)
    activations, its second is column-parallel onto the heads; ``w_o`` is
    row-parallel back, one all-reduce.  A state (prefill) is in the
    cache's layout (``S`` on an N dim or its heads, ``x_last`` on d, or
    whole) and comes back in it; without one the state is zeros.  Leaves
    laid out otherwise, or heads that do not divide over the group, run
    every head on every rank from whole leaves."""
    B, T, d = x.shape
    N = cfg.rwkv_head_dim
    H, M = d // N, tp.size
    shapes, sshapes = _shapes(cfg), _state_shapes(cfg, B)
    if H % M or not _rows_sharded(p, cfg, tp):
        st = None if state is None else {
            n: tp.whole(t, sshapes[n]) for n, t in state.items()}
        y, new = rwkv_apply(_whole_leaves(p, cfg, tp), x, cfg, st, chunk,
                            use_kernel, with_state)
        if new is not None and state is not None:
            new = {n: tp.slice_like(t, state[n]) for n, t in new.items()}
        return y, new
    Hl, dl = H // M, d // M
    fresh = state is None
    if fresh:
        x_last = x.new_zeros((B, dl))
    else:
        x_last = tp.part(state["x_last"], sshapes["x_last"], 1)
    xl = tp.split(x, -1)
    xs = _token_shift(xl, x_last)
    mix = tp.part(p["mix"], shapes["mix"], 1).to(x.dtype)
    xr, xk, xv, xg, xw = (xl * mix[i] + xs * (1 - mix[i]) for i in range(5))
    r, k, v, g = tp.scatter_rows([xr, xk, xv, xg], [p[n] for n in _PROJ])
    g = F.silu(g)
    lora = tp.copy(tp.reduce(xw @ p["decay_a"]))
    dw = lora @ tp.part(p["decay_b"], shapes["decay_b"], 1)
    logw = -torch.exp(tp.part(p["decay_base"], shapes["decay_base"], 0)
                      .float() + dw.float())
    rr, kk, vv = (t.reshape(B, T, Hl, N).float() for t in (r, k, v))
    lw = logw.reshape(B, T, Hl, N)
    u = tp.part(p["bonus_u"], shapes["bonus_u"], 0).float()
    S_fin = None
    if use_kernel and fresh and T % KERNEL_CHUNK == 0:
        y = _WkvKernel.apply(rr, kk, vv, lw, u)
        if with_state:
            L = torch.cumsum(lw, dim=1)
            k_dec = kk * torch.exp(L[:, -1:] - L)
            S_fin = torch.einsum("bthn,bthm->bhnm", k_dec, vv)
    else:
        if fresh:
            S0 = torch.zeros((B, Hl, N, N), dtype=torch.float32,
                             device=x.device)
        elif tp.dim_of(state["S"], sshapes["S"]) == 1:
            S0 = state["S"]
        else:
            S0 = tp.slice(tp.whole(state["S"], sshapes["S"]), 1)
        y, S_fin = wkv_chunked(rr, kk, vv, lw, u, S0, chunk=chunk)
    y = y.reshape(B, T, dl) * g.float()
    out = tp.reduce(y @ p["w_o"].float()).to(x.dtype)
    if not with_state:
        return out, None
    S_fin = S_fin.detach()
    like = {"S": S_fin.new_empty(sshapes["S"]),
            "x_last": x.new_empty(sshapes["x_last"])} if fresh else state
    if tp.dim_of(like["S"], sshapes["S"]) != 1:
        S_fin = tp.slice_like(tp.gather(S_fin, 1), like["S"])
    return out, {"S": S_fin,
                 "x_last": tp.slice_like(x[:, -1, :], like["x_last"])}


def _rwkv_decode_tp(p, x, cfg, state, tp):
    """``rwkv_decode_step`` over the model group on the cache's layout:
    ``S`` (B, H, N, N) on this rank's slice of its first N dim (the dim
    ``cache_pspecs`` shards) and ``x_last`` on d.  The recurrence is
    separable over that N dim, so every rank computes r, k, v, g (one
    all-reduce of the row-parallel products, the LoRA's with them) and
    the decay (its column-parallel slice, all-gathered), advances its own
    slice of S, and its partial y is summed over the group (one
    all-reduce); ``w_o`` is row-parallel (one all-reduce).  A state laid
    out otherwise is gathered whole for the step and its slice kept."""
    B, _, d = x.shape
    N = cfg.rwkv_head_dim
    H, M = d // N, tp.size
    shapes, sshapes = _shapes(cfg), _state_shapes(cfg, B)
    if _rows_sharded(p, cfg, tp):
        xl = tp.slice(x, -1)
        xs = tp.part(state["x_last"], sshapes["x_last"], 1)[:, None]
        mix = tp.part(p["mix"], shapes["mix"], 1).to(x.dtype)
        xr, xk, xv, xg, xw = (xl * mix[i] + xs * (1 - mix[i])
                              for i in range(5))
        parts = [t @ p[n] for t, n in zip((xr, xk, xv, xg, xw),
                                          _PROJ + ("decay_a",))]
        r, k, v, g, lora = tp.reduce(torch.cat(parts, dim=-1)).split(
            [d] * 4 + [cfg.rwkv_lora_rank], dim=-1)
        g = F.silu(g)
        b = tp.part(p["decay_b"], shapes["decay_b"], 1)
        base = tp.part(p["decay_base"], shapes["decay_base"], 0)
        logw = tp.gather(-torch.exp(base.float() + (lora @ b).float()), -1)
    else:
        r, k, v, g, logw = _project(
            _whole_leaves(p, cfg, tp), x,
            tp.whole(state["x_last"], sshapes["x_last"]))
    u = tp.whole(p["bonus_u"], shapes["bonus_u"]).float()
    rr, kk, vv = (t.reshape(B, H, N).float() for t in (r, k, v))
    w = torch.exp(logw.reshape(B, H, N))
    S = state["S"]
    if tp.dim_of(S, sshapes["S"]) == 2:
        n = N // M
        own = slice(tp.index * n, (tp.index + 1) * n)
        kv = torch.einsum("bhn,bhm->bhnm", kk[..., own], vv)
        y = torch.einsum("bhn,bhnm->bhm", rr[..., own],
                         S + u[None, :, own, None] * kv)
        y = tp.reduce(y)
        S_new = w[..., own, None] * S + kv
    else:
        Sw = tp.whole(S, sshapes["S"])
        kv = torch.einsum("bhn,bhm->bhnm", kk, vv)
        y = torch.einsum("bhn,bhnm->bhm", rr, Sw + u[None, :, :, None] * kv)
        S_new = tp.slice_like(w[..., None] * Sw + kv, S)
    y = y.reshape(B, 1, d) * g.float()
    out = tp.linear(y, p["w_o"].float(), shapes["w_o"]).to(x.dtype)
    return out, {"S": S_new,
                 "x_last": tp.slice_like(x[:, -1, :], state["x_last"])}
