"""SmolLM-135M — small llama-architecture dense model.

[hf:HuggingFaceTB/SmolLM-135M]: 30 layers, d_model 576, 9 heads / 3 KV
heads, d_ff 1536, vocab 49152.  With untied embedding and unembedding it
has 162,826,560 parameters in 12 leaves.
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    layer_pattern=(GLOBAL,),
    window=4096,
    long_context="swa",
    citation="hf:HuggingFaceTB/SmolLM-135M",
))
