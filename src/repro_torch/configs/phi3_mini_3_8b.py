"""Phi-3-mini 3.8B — dense, RoPE + SwiGLU + GQA (32 KV heads = MHA).

[arXiv:2404.14219]: 32 layers, d_model 3072, 32 heads / 32 KV heads,
d_ff 8192, vocab 32064 (padded to 32128 in the embedding tables).
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    layer_pattern=(GLOBAL,),
    window=4096,
    long_context="swa",
    citation="arXiv:2404.14219",
))
