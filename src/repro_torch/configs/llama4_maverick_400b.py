"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE with 128 routed experts, top-1 routing, interleaved dense/MoE FFN
(moe_every=2), early-fusion multimodal (text path exercised here).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    num_experts=128, top_k=1, moe_every=2,
    rope_theta=5e5, sliding_window=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
