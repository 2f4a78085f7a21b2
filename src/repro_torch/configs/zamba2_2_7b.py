"""Zamba2-2.7B [arXiv:2411.15242] — mamba2 backbone + shared attention block.

The shared attention block (one weight set, applied every `attn_every`
mamba2 layers) follows the Zamba2 design; d_state=64 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_version=2,
    attn_every=6,
    source="arXiv:2411.15242",
))
