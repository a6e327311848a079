"""RG-LRU recurrent block (``repro.models.rglru``; RecurrentGemma /
Griffin, arXiv:2402.19427).

    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a u_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Griffin's recurrent block: linear in, a short causal depthwise conv, the
RG-LRU, a GELU (tanh form) gate and a linear out.  The diagonal recurrence
over a sequence is a Hillis-Steele doubling scan in fp32: log2(T)
elementwise steps of the reference's ``associative_scan`` combine
``(a1, b1) . (a2, b2) = (a1 * a2, a2 * b1 + b2)``, no loop over T.  A
cumulative-product form is not used: log a reaches about -17 a step
(c = 8 times softplus(2)), so products underflow within a few steps.

Under tensor parallelism (``tp``, ``models.tp``; x replicated over the
model group) the block keeps its channels sharded: ``w_in`` and
``w_gate_in`` are row-parallel and end in one reduce-scatter onto this
rank's channels (the slice ``conv_w``, ``lam`` and the cache's state hold),
the conv is depthwise and ``w_a`` / ``w_i`` take that channel slice
against their own rows (one more reduce-scatter), the scan and the gate
are channel-local, and ``w_out`` is row-parallel back (one all-reduce).

Dtypes are the reference's: ``lam`` is fp32, the gates and h are fp32,
the conv runs in the model dtype (taps summed in order), h is cast to the
model dtype before the gate.  The state is ``{"h": (B, w) fp32, "conv":
(B, conv_width - 1, w)}``, the trailing conv inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

_C = 8.0  # Griffin's recurrence sharpness constant


def rglru_init(gen, cfg, dtype, lead=()):
    """The reference's leaves (``lead`` prepends the stacking dim)."""
    d, w = cfg.d_model, cfg.rglru_width
    return {
        "w_in": layers.dense_init(gen, (*lead, d, w), dtype),
        "w_gate_in": layers.dense_init(gen, (*lead, d, w), dtype),
        "w_a": layers.dense_init(gen, (*lead, w, w), dtype, scale=0.01),
        "w_i": layers.dense_init(gen, (*lead, w, w), dtype, scale=0.01),
        "lam": torch.full((*lead, w), 2.0),        # softplus(2) ~ 2.1
        "conv_w": (torch.randn((*lead, cfg.conv_width, w), generator=gen)
                   * 0.1).to(dtype),
        "w_out": layers.dense_init(gen, (*lead, w, d), dtype),
    }


def rglru_init_state(cfg, batch, dtype, device=None):
    w = cfg.rglru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def _gates(p, u):
    """u: (B, T, w) post-conv activations -> (a, gated input), fp32."""
    uf = u.float()
    return _gate_values(p["lam"], uf, uf @ p["w_a"].float(),
                        uf @ p["w_i"].float())


def _gate_values(lam, uf, a_pre, i_pre):
    log_a = -_C * F.softplus(lam) * torch.sigmoid(a_pre)
    a = torch.exp(log_a)
    i = torch.sigmoid(i_pre)
    x_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, x_in


def _conv(p, u, conv_state):
    """Causal depthwise temporal conv: (out, new conv state), the taps
    summed in order i = 0 .. cw - 1 in u's dtype."""
    cw = p["conv_w"].shape[0]
    T = u.shape[1]
    full = torch.cat([conv_state.to(u.dtype), u], dim=1)
    out = full[:, 0:T] * p["conv_w"][0]
    for i in range(1, cw):
        out = out + full[:, i:i + T] * p["conv_w"][i]
    return out, full[:, -(cw - 1):]


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0, by doubling:
    after the step at offset s each position holds the composition of the
    2s pairs that end there."""
    T = a.shape[1]
    s = 1
    while s < T:
        a_prev, b_prev = a[:, :-s], b[:, :-s]
        b = torch.cat([b[:, :s], a[:, s:] * b_prev + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a_prev * a[:, s:]], dim=1)
        s *= 2
    return b


def rglru_apply(p, x, cfg, state=None, tp=None):
    """Full-sequence form.  x: (B, T, d) -> (y, new state); ``tp``: tensor
    parallelism (the module docstring)."""
    if tp is not None:
        return _rglru_apply_tp(p, x, cfg, state, tp)
    B = x.shape[0]
    if state is None:
        state = rglru_init_state(cfg, B, x.dtype, x.device)
    u = x @ p["w_in"]
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    u, conv_state = _conv(p, u, state["conv"])
    a, x_in = _gates(p, u)
    # seed position 0 with the carried h
    x_in = torch.cat([x_in[:, :1] + a[:, :1] * state["h"][:, None],
                      x_in[:, 1:]], dim=1)
    h = linear_scan(a, x_in)
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y, {"h": h[:, -1], "conv": conv_state}


def rglru_decode_step(p, x, cfg, state, tp=None):
    """One token.  x: (B, 1, d) -> (y, new state)."""
    if tp is not None:
        # the sequence form at T = 1 is the same arithmetic
        return _rglru_apply_tp(p, x, cfg, state, tp)
    u = x @ p["w_in"]
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    u, conv_state = _conv(p, u, state["conv"])
    a, x_in = _gates(p, u)
    h = a[:, 0] * state["h"] + x_in[:, 0]
    y = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return y, {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
def _shapes(cfg):
    d, w = cfg.d_model, cfg.rglru_width
    return {"w_in": (d, w), "w_gate_in": (d, w), "w_a": (w, w),
            "w_i": (w, w), "lam": (w,), "conv_w": (cfg.conv_width, w),
            "w_out": (w, d)}


def _rglru_apply_tp(p, x, cfg, state, tp):
    """``rglru_apply`` over the model group on this rank's channels (the
    module docstring).  A state (prefill, decode) holds this rank's
    channels or every channel (the reference's ``tail`` leaves put their
    channels on the data axes, not the model axis) and comes back laid out
    as it came; without one it is zeros and comes back on this rank's
    channels.  Leaves laid out otherwise run whole on every rank."""
    B, _, d = x.shape
    w, M = cfg.rglru_width, tp.size
    shapes = _shapes(cfg)
    dims = {n: tp.dim_of(t, shapes[n]) for n, t in p.items()}
    into = {dims["w_in"], dims["w_gate_in"]}
    fast = w % M == 0 and len(into) == 1 and into <= {0, 1} and all(
        dims[n] == 0 for n in ("w_a", "w_i", "w_out"))
    sshapes = {"h": (B, w), "conv": (B, cfg.conv_width - 1, w)}
    if not fast:
        st = None if state is None else {
            n: tp.whole(t, sshapes[n]) for n, t in state.items()}
        y, new = rglru_apply({n: tp.whole(t, shapes[n]) for n, t in
                              p.items()}, x, cfg, st)
        if state is not None:
            new = {n: tp.slice_like(t, state[n]) for n, t in new.items()}
        return y, new
    if state is None:
        state = rglru_init_state(cfg, B, x.dtype, x.device)
        state = {n: tp.slice(t, -1) for n, t in state.items()}
    local = {n: t if t.shape[-1] < w else tp.slice(t, -1)
             for n, t in state.items()}
    if dims["w_in"] == 0:
        xl = tp.split(x, -1)
        u, gate = tp.scatter_rows([xl, xl], [p["w_in"], p["w_gate_in"]])
    else:
        xc = tp.copy(x)
        u, gate = xc @ p["w_in"], xc @ p["w_gate_in"]
    gate = F.gelu(gate, approximate="tanh")
    conv_w = tp.part(p["conv_w"], shapes["conv_w"], 1)
    u, conv_state = _conv({"conv_w": conv_w}, u, local["conv"])
    uf = u.float()
    a_pre, i_pre = tp.scatter_rows([uf, uf], [p["w_a"].float(),
                                              p["w_i"].float()])
    a, x_in = _gate_values(tp.part(p["lam"], shapes["lam"], 0), uf, a_pre,
                           i_pre)
    x_in = torch.cat([x_in[:, :1] + a[:, :1] * local["h"][:, None],
                      x_in[:, 1:]], dim=1)
    h = linear_scan(a, x_in)
    y = tp.reduce((h.to(x.dtype) * gate) @ p["w_out"])
    new = {"h": h[:, -1], "conv": conv_state}
    return y, {n: t if state[n].shape[-1] < w else tp.gather(t, -1)
               for n, t in new.items()}
