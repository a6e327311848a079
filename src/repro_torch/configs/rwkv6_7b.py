"""RWKV-6 (Finch) 7B — attention-free SSM with data-dependent decay.

[arXiv:2404.05892]: 32 layers, d_model 4096, d_ff 14336, vocab 65536.
Head size 64 (64 wkv heads).  6,997,282,816 parameters in 17 leaves.
"""
from repro_torch.configs.base import RWKV, ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=(RWKV,),
    rwkv_head_dim=64,
    rwkv_lora_rank=64,
    mlp="gelu",              # channel-mix uses squared-relu-ish; gelu stand-in
    long_context="native",   # constant-size recurrent state
    citation="arXiv:2404.05892",
))
