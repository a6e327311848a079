"""Mixture-of-Experts layer (``repro.models.moe``): top-k routing with
capacity-based dispatch, and its expert-parallel form.

No (T, E, C) one-hot tensors: each (token, slot) pair takes a position in
its expert's capacity buffer by a cumulative sum over the T*k pairs in
token-major order (each token's k slots in descending router probability,
ties to the lower expert index, as ``lax.top_k`` orders them); pairs at
or past the capacity go to an overflow row that is dropped.  The expert
SwiGLU FFNs are batched products over (E, C, d) (the reference computes
them outside any Pallas kernel, so they are plain products here too), and
the outputs are gathered back and weighted by the renormalised gates.

Numerics are the reference's: the router runs in fp32 (``router`` is an
fp32 leaf in a bf16 model), the capacity is Python float arithmetic
(``int(capacity_factor * k * T / E)``, then at least 8 and a multiple of
8), the gathered outputs are weighted and summed over k in the model
dtype.  The load-balance loss is ``router_aux_coef * E * sum(me * ce)``
(mean router probability times the fraction of slots, per expert).

``moe_apply_ep`` moves tokens instead of weights: each rank of a
``torch.distributed`` group routes its own tokens, ships each expert's
capacity buffer to the rank that owns the expert (one
``all_to_all_single`` of (W, E_loc, C, d) each way) and computes only
its E / W local experts.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import layers

FFN_CHUNK = 2048        # the capacity chunk of ``_expert_ffn_chunked``


def moe_init(gen, cfg, dtype, lead=()):
    """The reference's leaves (``lead`` prepends the stacking dim)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": layers.dense_init(gen, (*lead, d, E), torch.float32,
                                        scale=0.02),
            "w_gate": layers.dense_init(gen, (*lead, E, d, f), dtype),
            "w_up": layers.dense_init(gen, (*lead, E, d, f), dtype),
            "w_down": layers.dense_init(gen, (*lead, E, f, d), dtype)}


def _ffn(buf, w_gate, w_up, w_down):
    """SwiGLU experts: buf (E, C, d) x (E, d, f) -> (E, C, d)."""
    gate = F.silu(torch.bmm(buf, w_gate))
    return torch.bmm(gate * torch.bmm(buf, w_up), w_down)


def _expert_ffn_chunked(p, buf, chunk=FFN_CHUNK):
    """buf: (E, C, d) -> (E, C, d); the capacity in chunks of ``chunk``
    where it divides C (one shot otherwise), so the (E, C, d_ff)
    intermediates never form whole at long prefills."""
    C = buf.shape[1]
    c = min(chunk, C)
    if C % c:
        c = C
    w = (p["w_gate"], p["w_up"], p["w_down"])
    if c == C:
        return _ffn(buf, *w)
    return torch.cat([_ffn(b, *w) for b in buf.split(c, dim=1)], dim=1)


def capacity(cfg, T: int) -> int:
    """Slots per expert for T tokens (the reference's arithmetic)."""
    k, E = cfg.experts_per_token, cfg.n_experts
    c = int(cfg.capacity_factor * k * T / E)
    return max(8, -(-c // 8) * 8)


def _route(p, xf, cfg, tokens=None, group=None):
    """Router, top-k, aux loss and capacity dispatch of xf (T, d):
    (flat gates (T*k,) fp32, destination rows (T*k,), keep mask (T*k,),
    the (E*C, d) dispatch buffer filled from ``tokens`` (xf by default),
    C, aux).  ``group``: xf is this rank's block of rows of a batch
    sharded in rank order over the group's ranks, routed as the whole
    batch is (``moe_apply``)."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)       # (T, E)
    # stable descending sort: ties keep the lower expert index first
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    me = probs.mean(dim=0)
    ce = F.one_hot(expert_idx, E).float().sum(dim=1).mean(dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    flat_idx = expert_idx.reshape(T * k)
    eh = F.one_hot(flat_idx, E)                                  # (T*k, E)
    pos = ((torch.cumsum(eh, dim=0) - eh) * eh).sum(dim=-1)
    if group is None:
        C = capacity(cfg, T)
    else:
        # the whole batch's capacity; each expert's places taken by the
        # rows of the ranks before this one come first
        W, r = dist.get_world_size(group), dist.get_rank(group)
        C = capacity(cfg, T * W)
        counts = eh.sum(dim=0)
        every = counts.new_empty(W * E)
        dist.all_gather_into_tensor(every, counts, group=group)
        pos = pos + every.view(W, E)[:r].sum(dim=0)[flat_idx]
    keep = pos < C
    dest = flat_idx * C + torch.where(keep, pos, torch.full_like(pos, C))
    rows = torch.where(keep, dest, torch.full_like(dest, E * C))
    token_ids = torch.arange(T, device=xf.device).repeat_interleave(k)
    tokens = xf if tokens is None else tokens
    buf = xf.new_zeros((E * C + 1, d)).index_copy(0, rows, tokens[token_ids])
    return gate_vals.reshape(T * k), dest, keep, buf[:E * C], C, aux


def _combine(out_flat, flat_gate, dest, keep, T, k, dtype):
    """Gather each kept slot's expert output, weight it by its gate in the
    model dtype and sum over the k slots: (T, d)."""
    n = out_flat.shape[0]
    gathered = out_flat[torch.clamp(dest, max=n - 1)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    weighted = gathered * flat_gate[:, None].to(gathered.dtype)
    return weighted.reshape(T, k, -1).sum(dim=1).to(dtype)


def moe_apply(p, x, cfg, tp=None, batch_group=None):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux 0-dim fp32).

    ``batch_group``: x is this rank's rows of a batch sharded over the
    group (batch-sharded serving, whose reference routes the whole batch
    in one call): the capacity is the whole batch's and each expert's
    places go to the rows in batch order, one all-gather of the (E,)
    counts, so each token is kept or dropped as in the whole batch.

    Under tensor parallelism (``tp``, ``models.tp``; x replicated over the
    model group) the router is used whole, so every rank routes, drops
    and weighs exactly as the replicated layer does, and the aux loss,
    from those replicated probabilities, is not summed.  The experts run
    on this rank's d_ff slice (column-parallel gate and up, row-parallel
    down), so the combine, which is linear, gives this rank's partial
    (T, d) output: one all-reduce.  Backward, the gates' and the
    dispatched tokens' gradients are partial too (``tp.copy``).  Expert
    leaves laid out otherwise are used whole."""
    B, S, d = x.shape
    E, k, f = cfg.n_experts, cfg.experts_per_token, cfg.d_ff
    T = B * S
    xf = x.reshape(T, d)
    sliced = False
    if tp is not None:
        shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
                  "w_down": (E, f, d)}
        sliced = {n: tp.dim_of(p[n], shapes[n]) for n in shapes
                  if n != "router"} == {"w_gate": 2, "w_up": 2, "w_down": 1}
        p = {n: t if sliced and n != "router" else tp.whole(t, shapes[n])
             for n, t in p.items()}
    flat_gate, dest, keep, buf, C, aux = _route(
        p, xf, cfg, tokens=tp.copy(xf) if sliced else None,
        group=batch_group)
    out = _expert_ffn_chunked(p, buf.reshape(E, C, d))
    if sliced:
        flat_gate = tp.copy(flat_gate)
    y = _combine(out.reshape(E * C, d), flat_gate, dest, keep, T, k, x.dtype)
    if sliced:
        y = tp.reduce(y)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# expert-parallel form: move tokens, not expert weights
# ---------------------------------------------------------------------------
class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 (block i to rank i, block j from
    rank j); the exchange is its own transpose, so the backward is the
    same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()      # the exchange reads and writes dense rows
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def moe_apply_ep(p, x, cfg, group=None):
    """Expert-parallel ``moe_apply`` over the ranks of ``group`` (W ranks,
    ``n_experts % W == 0``).  Every rank holds the full (E, d, f) expert
    weights and computes experts ``[r * E/W, (r + 1) * E/W)``, r its rank
    in the group; x is this rank's (B, S, d) tokens.  Routing, capacity
    and the combine are ``moe_apply``'s on the local tokens, so the result
    equals ``moe_apply`` on this rank's shard."""
    W = dist.get_world_size(group)
    r = dist.get_rank(group)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    if E % W:
        raise ValueError(f"{E} experts do not split over {W} ranks")
    E_loc = E // W
    T = B * S
    flat_gate, dest, keep, buf, C, aux = _route(p, x.reshape(T, d), cfg)
    # ship each expert's buffer to its owner; receive our experts' buffers
    # from every peer: (W, E_loc, C, d), block j from rank j
    shipped = _AllToAll.apply(buf.reshape(W, E_loc, C, d), group)
    flat_in = shipped.transpose(0, 1).reshape(E_loc, W * C, d)
    sl = slice(r * E_loc, (r + 1) * E_loc)
    res = _ffn(flat_in, p["w_gate"][sl], p["w_up"][sl], p["w_down"][sl])
    back = res.reshape(E_loc, W, C, d).transpose(0, 1)
    out = _AllToAll.apply(back, group)                  # (W, E_loc, C, d)
    y = _combine(out.reshape(E * C, d), flat_gate, dest, keep, T, k, x.dtype)
    return y.reshape(B, S, d), aux
