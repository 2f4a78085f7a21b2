"""DeepSeek-V2-Lite [arXiv:2405.04434] — the paper's second testbed model.

26 layers, 64 routed experts with top-8 routing (simplified: standard GQA
attention instead of MLA; the placement study concerns the expert layers).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite", family="moe",
    num_layers=26, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    num_experts=64, top_k=8, moe_every=1,
    rope_theta=1e4, sliding_window=8192,
    source="arXiv:2405.04434",
))
