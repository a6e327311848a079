"""The yardstick: the card's peaks, the model FLOPs a token needs, and
the operations and bytes of each hand-written kernel's call.

Frozen here, apart from the program, so that a change to the program
cannot move what its numbers are held against.  Every count is of the
work the model or the call needs at its shapes, whatever a kernel does
to get it: no recompute under remat, the k experts a token uses and not
the capacity slots, the WKV recurrence and not a chunked form of it,
each input byte read once and each output byte written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def causal_pairs(seq: int, window=None) -> int:
    """(query, key) pairs a causal attention over ``seq`` positions
    scores, keys limited to the last ``window`` positions (None: all)."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    # the first ``window`` queries see 1..window keys, the rest window
    return window * (window + 1) // 2 + (seq - window) * window


def _attention_layer_flops(cfg: dict, seq: int, window) -> float:
    """Forward FLOPs a token of one attention layer needs: the q, k, v
    and o projections and the scores and values over its causal span."""
    d, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        head_dim(cfg)
    proj = 2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d
    keys = causal_pairs(seq, window) / seq
    return proj + 4 * H * hd * keys


def _ffn_flops(cfg: dict) -> float:
    """Forward FLOPs a token of one FFN needs: the router and the k
    experts it uses for an MoE layer, else the MLP."""
    d, f = cfg["d_model"], cfg["d_ff"]
    mats = 3 if cfg.get("mlp", "swiglu") == "swiglu" else 2
    if cfg.get("n_experts", 0):
        return 2 * d * cfg["n_experts"] + \
            cfg["experts_per_token"] * mats * 2 * d * f
    return mats * 2 * d * f


def wkv_flops_per_token_head(N: int) -> float:
    """One step of the WKV recurrence for one head of size N:
    S = diag(w) S + k^T v (3 N^2) and y = r (S + diag(u) k^T v), taken as
    r S (2 N^2) plus the bonus (r . (u * k)) v (4 N)."""
    return 5 * N * N + 4 * N


def _rwkv_layer_flops(cfg: dict) -> float:
    d, N, r = cfg["d_model"], cfg["rwkv_head_dim"], cfg["rwkv_lora_rank"]
    proj = 5 * 2 * d * d                       # r, k, v, g, o
    lora = 2 * d * r + 2 * r * d               # the decay's low rank
    return proj + lora + (d // N) * wkv_flops_per_token_head(N)


def forward_flops_per_token(cfg: dict, seq: int) -> float:
    """Forward FLOPs a token of the model needs at sequence ``seq``."""
    pattern = cfg["layer_pattern"]
    total = 0.0
    for i in range(cfg["n_layers"]):
        kind = pattern[i % len(pattern)]
        if kind == "rwkv":
            total += _rwkv_layer_flops(cfg)
        elif kind in ("global", "local"):
            window = cfg.get("window") if kind == "local" else None
            total += _attention_layer_flops(cfg, seq, window)
        else:
            raise ValueError(f"no FLOP count for layer kind {kind!r}")
        total += _ffn_flops(cfg)
    return total + 2 * cfg["d_model"] * cfg["vocab_size"]


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """Three times the forward: the backward's two products a forward
    one."""
    return 3 * forward_flops_per_token(cfg, seq)


# ---------------------------------------------------------------------------
# kernels: (operations, bytes) of one call, and its least time
# ---------------------------------------------------------------------------
def least_time(ops: float, nbytes: float, peak_flops: float) -> float:
    """The larger of the operations at the peak and the bytes at the
    memory's bandwidth, in seconds."""
    return max(ops / peak_flops, nbytes / PEAK_HBM_BYTES_PER_S)


def adamw_bytes(numel: int, param_dtype: str, grad_dtype: str) -> float:
    """One fused AdamW call over a leaf: reads g, m, v (fp32) and p,
    writes the update u (p's dtype) and m and v."""
    p, g = _BYTES[param_dtype], _BYTES[grad_dtype]
    return numel * (g + 4 + 4 + p + p + 4 + 4)


def swa_attention_cost(B, S, H, KV, hd, window, dtype="bfloat16"):
    """(operations, bytes) of one causal sliding-window attention forward:
    q.k and p.v over the causal window's pairs; q, k, v read and o
    written once."""
    ops = 4 * hd * B * H * causal_pairs(S, window)
    nbytes = _BYTES[dtype] * B * S * hd * (2 * H + 2 * KV)
    return ops, nbytes


def wkv6_cost(B, T, H, N):
    """(operations, bytes) of one WKV6 forward from a zero state: the
    recurrence's steps; r, k, v, log w (fp32) and u read, y written."""
    ops = B * T * H * wkv_flops_per_token_head(N)
    nbytes = 4 * (5 * B * T * H * N + H * N)
    return ops, nbytes
