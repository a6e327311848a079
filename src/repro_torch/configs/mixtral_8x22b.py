"""Mixtral 8x22B — MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] (Mixtral of Experts; 8x22B per its public model card):
56 layers, d_model 6144, 48 heads / 8 KV heads, d_ff 16384, vocab 32768;
140,630,071,296 parameters in 13 leaves.
"""
from repro_torch.configs.base import LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    layer_pattern=(LOCAL,),          # SWA on every layer
    window=4096,
    n_experts=8,
    experts_per_token=2,
    rope_theta=1_000_000.0,
    long_context="native",           # SWA => sub-quadratic decode cache
    citation="arXiv:2401.04088",
))
