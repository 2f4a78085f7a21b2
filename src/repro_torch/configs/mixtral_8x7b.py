"""Mixtral-8x7B [arXiv:2401.04088] — the paper's primary testbed model."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        head_dim=128,
        num_experts=8,
        top_k=2,
        moe_every=1,
        rope_theta=1e6,
        sliding_window=8192,
        source="arXiv:2401.04088",
    )
)
