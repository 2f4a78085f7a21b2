"""StarCoder2-3B [arXiv:2402.19173] — dense, GQA kv=2, RoPE."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        head_dim=128,
        rope_theta=1e5,
        use_qkv_bias=True,
        sliding_window=4096,
        source="arXiv:2402.19173",
    )
)
