"""RecurrentGemma 2B — hybrid: RG-LRU recurrence + local attention, 2:1.

[arXiv:2402.19427] (Griffin): 26 layers, d_model 2560, 10 heads / 1 KV
head (MQA), d_ff 7680, vocab 256000.  Pattern: 2 recurrent blocks
(``models.rglru``) then 1 local-attention block, so 8 pattern blocks and
a tail of 2 recurrent layers; 3,038,615,040 parameters in 55 leaves.
"""
from repro_torch.configs.base import LOCAL, RGLRU, ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=(RGLRU, RGLRU, LOCAL),
    window=2048,
    mlp="gelu",
    long_context="native",    # recurrent state + window cache only
    citation="arXiv:2402.19427",
))
