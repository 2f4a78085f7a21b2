"""Falcon-Mamba-7B [arXiv:2410.05355] — attention-free mamba1, d_state=16."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_version=1,
    source="arXiv:2410.05355",
))
