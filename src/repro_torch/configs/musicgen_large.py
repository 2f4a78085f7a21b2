"""MusicGen-large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

The EnCodec audio codec frontend is a STUB per the assignment: the decoder
consumes precomputed frame embeddings (the sum of the 4 codebook embeddings
under the delay pattern) supplied by ``input_specs``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    frontend="audio", sliding_window=8192,
    source="arXiv:2306.05284",
))
