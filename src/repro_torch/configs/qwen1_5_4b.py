"""Qwen1.5 4B — dense with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family card, scaled per the assignment]:
40 layers, d_model 2560, 20 heads / 20 KV heads, d_ff 6912, vocab 151936.
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    layer_pattern=(GLOBAL,),
    qkv_bias=True,
    window=4096,
    long_context="swa",
    citation="hf:Qwen/Qwen1.5-0.5B",
))
