"""Whisper-small — encoder-decoder audio backbone (conv front end stubbed).

[arXiv:2212.04356]: 12 encoder + 12 decoder layers, d_model 768, 12 heads
(MHA), d_ff 3072, vocab 51865.  The mel-spectrogram and conv feature
extractor are a stub: batches carry precomputed frame embeddings
(B, encoder_seq, d_model) as ``frames``.  No rotary embedding: sinusoidal
positions on the decoder's and the encoder's inputs; 278,134,272
parameters in 34 leaves.
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                 # decoder layers
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    layer_pattern=(GLOBAL,),
    encoder_seq=1500,
    qkv_bias=True,
    mlp="gelu",
    long_context="skip",
    citation="arXiv:2212.04356",
))
