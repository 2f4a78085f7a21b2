"""DeepSeek-V2-Lite at its published widths [arXiv:2405.04434;
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json]:
multi-head latent attention (MLA) with no q LoRA, YaRN RoPE on the rope
dims, one leading dense layer, then MoE layers of 64 routed experts
(top-6, softmax weights not renormalised) and 2 shared experts
(``configs/mla.py``'s ``MLAConfig``). The stand-in ``deepseek-v2-lite``
(``configs/deepseek_v2_lite.py``: GQA, top-8, no dense layer) stays the
JAX package's twin."""

from repro_torch.configs.base import register
from repro_torch.configs.mla import MLAConfig

CONFIG = register(MLAConfig(
    name="deepseek-v2-lite-mla", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    num_experts=64, top_k=6, moe_every=1,
    rope_theta=1e4, norm_eps=1e-6,
    source="https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite",
))
