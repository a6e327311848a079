"""Analytic FLOP / byte / parameter counting per ModelConfig
(``repro.costmodel.flops``, copied; pure arithmetic on the config).

Every matmul the model performs is counted, exactly, from the config
(the reference's dry-run cost analysis counts a scanned layer stack's
body once, so it cannot be the source of these counts).

Conventions: 1 MAC = 2 FLOPs; causal attention counts the ~1/2 factor
(the chunked implementation skips fully-masked KV blocks);
sliding-window attention costs O(S·W).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import GLOBAL, LOCAL, RGLRU, RWKV, ModelConfig


def param_count(cfg: ModelConfig) -> int:
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = V * d * 2                       # embed + unembed
    per_layer: Dict[str, int] = {}
    per_layer[GLOBAL] = per_layer[LOCAL] = (
        d * H * hd + 2 * d * KV * hd + H * hd * d)
    w = cfg.rglru_width
    per_layer[RGLRU] = 2 * d * w + 2 * w * w + w * d + cfg.conv_width * w
    r = cfg.rwkv_lora_rank
    per_layer[RWKV] = 5 * d * d + 2 * d * r
    mlp = (3 if cfg.mlp == "swiglu" else 2) * d * f
    moe = cfg.n_experts * 3 * d * f + d * cfg.n_experts

    pat = cfg.layer_pattern
    for i in range(cfg.n_layers):
        kind = pat[i % len(pat)]
        n += per_layer[kind]
        if cfg.is_moe and kind in (GLOBAL, LOCAL):
            n += moe
        else:
            n += mlp
    if cfg.is_encoder_decoder:
        n += cfg.n_encoder_layers * (per_layer[GLOBAL] + mlp)
        n += cfg.n_layers * per_layer[GLOBAL]      # cross attention
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k experts only)."""
    if not cfg.is_moe:
        return param_count(cfg)
    full = param_count(cfg)
    d, f = cfg.d_model, cfg.d_ff
    inactive = (cfg.n_experts - cfg.experts_per_token) * 3 * d * f
    n_moe_layers = cfg.n_layers
    return full - inactive * n_moe_layers


def _attn_flops(cfg, tokens: int, kv_len: float) -> float:
    """One attention layer, ``tokens`` queries against kv_len keys avg."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * tokens * d * (H + 2 * KV) * hd + 2 * tokens * H * hd * d
    scores = 2 * tokens * kv_len * H * hd * 2     # QK^T and PV
    return proj + scores


def _mixer_flops(cfg, kind, tokens: int, seq_len: int, decode: bool) -> float:
    d = cfg.d_model
    if kind == GLOBAL:
        kv = seq_len if decode else seq_len / 2    # causal half
        return _attn_flops(cfg, tokens, kv)
    if kind == LOCAL:
        kv = min(cfg.window, seq_len) if decode else \
            min(cfg.window, seq_len / 2)
        return _attn_flops(cfg, tokens, kv)
    if kind == RGLRU:
        w = cfg.rglru_width
        return 2 * tokens * (2 * d * w + 2 * w * w + w * d)
    if kind == RWKV:
        N = cfg.rwkv_head_dim
        r = cfg.rwkv_lora_rank
        proj = 2 * tokens * (5 * d * d + 2 * d * r)
        # chunked wkv: intra ~2*T*c*d*2, inter/state ~2*T*d*N*2
        c = 64
        wkv = 2 * tokens * d * (2 * c + 2 * N)
        return proj + wkv
    raise ValueError(kind)


def _ffn_flops(cfg, kind, tokens: int) -> float:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.is_moe and kind in (GLOBAL, LOCAL):
        router = 2 * tokens * d * cfg.n_experts
        expert_tokens = tokens * cfg.experts_per_token * cfg.capacity_factor
        return router + 2 * expert_tokens * 3 * d * f
    n_mat = 3 if cfg.mlp == "swiglu" else 2
    return 2 * tokens * n_mat * d * f


def forward_flops(cfg: ModelConfig, batch: int, seq_len: int,
                  kind: str = "train") -> float:
    """Exact forward FLOPs for one step.

    kind: "train"/"prefill" (full sequence) or "decode" (1 token vs
    seq_len-long cache).
    """
    decode = kind == "decode"
    tokens = batch * (1 if decode else seq_len)
    pat = cfg.layer_pattern
    total = 0.0
    for i in range(cfg.n_layers):
        k = pat[i % len(pat)]
        total += _mixer_flops(cfg, k, tokens, seq_len, decode)
        total += _ffn_flops(cfg, k, tokens)
        if cfg.is_encoder_decoder:
            total += _attn_flops(cfg, tokens, cfg.encoder_seq)  # cross
    if cfg.is_encoder_decoder:
        enc_tokens = batch * cfg.encoder_seq
        for _ in range(cfg.n_encoder_layers):
            total += _attn_flops(cfg, enc_tokens, cfg.encoder_seq)
            total += _ffn_flops(cfg, GLOBAL, enc_tokens)
    total += 2 * tokens * cfg.d_model * cfg.vocab_size   # unembed
    return total


def train_step_flops(cfg: ModelConfig, batch: int, seq_len: int,
                     remat: bool = True) -> float:
    """fwd + bwd (2x fwd) + remat recompute (1x fwd) = 4x forward."""
    f = forward_flops(cfg, batch, seq_len, "train")
    return f * (4.0 if remat else 3.0)


def model_flops_6nd(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    """The standard 6·N·D estimate (N = active params, D = tokens)."""
    return 6.0 * active_param_count(cfg) * batch * seq_len


def step_bytes_hbm(cfg: ModelConfig, batch: int, seq_len: int,
                   kind: str = "train", dtype_bytes: int = 2) -> float:
    """Lower-bound HBM traffic: params read (+grad/opt write for train)
    + KV-cache read for decode."""
    N = param_count(cfg)
    if kind == "train":
        # params read fwd + bwd, grads written, adam m/v read+write fp32
        return N * dtype_bytes * 3 + N * 4 * 4
    if kind == "prefill":
        return N * dtype_bytes
    # decode: params + full cache read per token
    pat = cfg.layer_pattern
    cache = 0
    for i in range(cfg.n_layers):
        k = pat[i % len(pat)]
        if k == GLOBAL:
            cache += seq_len * cfg.n_kv_heads * cfg.head_dim * 2
        elif k == LOCAL:
            cache += min(cfg.window, seq_len) * cfg.n_kv_heads \
                * cfg.head_dim * 2
        elif k == RGLRU:
            cache += cfg.rglru_width * (cfg.conv_width + 1)
        elif k == RWKV:
            cache += (cfg.d_model // cfg.rwkv_head_dim) \
                * cfg.rwkv_head_dim ** 2
    return N * dtype_bytes + batch * cache * dtype_bytes
