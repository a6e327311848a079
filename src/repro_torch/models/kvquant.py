"""int8 KV-cache quantization (``repro.models.kvquant``; beyond the paper,
the lever for memory-bound decode shapes).

Per-entry symmetric quantization with an fp16 scale per (position, head)
vector: the cache's bytes drop about 2x against bf16 (an int8 payload and a
2-byte scale per hd-vector), and decode reads that much less.  The
attention dequantizes in its fp32 products
(``attention.decode_attention_quant``).

The reference always runs quantization compiled, and XLA turns its
division by the constant 127.0 into a product with fp32(1/127); the port
computes that compiled form, so payloads and scales equal the reference's
bit for bit (``torch.round`` and ``jnp.round`` both round half to even).
Cache writes are in place, as the rest of the port's serving path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention

INV_127 = float(np.float32(1.0) / np.float32(127.0))   # what XLA multiplies by


def quantize_kv(x):
    """x: (..., hd) -> (int8 payload, fp16 per-vector scales (..., 1))."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) * INV_127
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def dequantize_kv(q, scale):
    return q.float() * scale.float()


def init_quant_cache(batch, length, kv_heads, head_dim, stacked=(),
                     device=None):
    shape = tuple(stacked) + (batch, length, kv_heads, head_dim)
    return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
            "scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float16,
                                 device=device)}


def quant_cache_update(cache, new, pos):
    """cache: {"q", "scale"} of (B, L, KV, ...); new: (B, 1, KV, hd) raw
    values, quantized and written at ring slot ``pos % L`` in place (a
    scalar ``pos``, as in the reference).  Returns the cache."""
    qn, sn = quantize_kv(new)
    attention.write_slots(cache["q"], qn, pos)
    attention.write_slots(cache["scale"], sn, pos)
    return cache
