"""Gemma-3 4B — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family card, scaled per the assignment]:
34 layers, d_model 2560, 8 heads / 4 KV heads, d_ff 10240, vocab 262144.
Pattern: 5 sliding-window layers (window 1024) then 1 global layer; the
MLP is GELU (tanh form).  Its head_dim is 320.
"""
from repro_torch.configs.base import GLOBAL, LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    layer_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),
    window=1024,
    rope_theta=1_000_000.0,
    mlp="gelu",
    long_context="native",
    citation="hf:google/gemma-3-1b-pt",
))
