"""Qwen2-VL-72B [arXiv:2409.12191] — VLM backbone, M-RoPE, GQA kv=8.

Vision frontend (ViT + projector) is a STUB per the assignment: the decode
backbone consumes precomputed patch embeddings supplied by ``input_specs``.
M-RoPE runs in text mode (temporal/height/width sections share positions).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    rope_theta=1e6, use_qkv_bias=True, frontend="vision",
    sliding_window=8192,  # enables long_500k decode (beyond-paper variant)
    source="arXiv:2409.12191",
))
