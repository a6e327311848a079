"""Mixtral 8x7B — MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088]: 32 layers, d_model 4096, 32 heads / 8 KV heads,
d_ff 14336, vocab 32000.  Every layer's MLP is the top-2 expert layer
(``models.moe``); 46,702,792,704 parameters in 13 leaves.
"""
from repro_torch.configs.base import LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    layer_pattern=(LOCAL,),
    window=4096,
    n_experts=8,
    experts_per_token=2,
    rope_theta=1_000_000.0,
    long_context="native",
    citation="arXiv:2401.04088",
))
