"""Phi-3.5-MoE 42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct] — 16e top-2."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064, head_dim=128,
    num_experts=16, top_k=2, moe_every=1,
    rope_theta=1e4, sliding_window=8192,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
