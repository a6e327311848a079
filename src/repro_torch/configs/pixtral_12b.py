"""Pixtral 12B — VLM: Pixtral-ViT front end (stub) + Mistral-Nemo decoder.

[hf:mistralai/Pixtral-12B-2409]: decoder 40 layers, d_model 5120, 32
heads / 8 KV heads (head_dim 160), d_ff 14336, vocab 131072.  The vision
encoder and projector are a stub: batches carry precomputed patch
embeddings (B, n_patches, d_model) as ``patch_emb``, which take the place
of the first n_patches token embeddings; 12,772,070,400 parameters in 12
leaves.
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    layer_pattern=(GLOBAL,),
    n_patches=1024,                 # stub ViT patches prepended to text
    rope_theta=1_000_000.0,
    window=4096,
    long_context="swa",
    citation="hf:mistralai/Pixtral-12B-2409",
))
