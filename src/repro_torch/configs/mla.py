"""The port's multi-head latent attention configuration (``MLAConfig``),
a subclass of ``ModelConfig`` whose extra fields hold the settings the JAX
package has no field for (DeepSeek-V2: MLA with no q LoRA, YaRN RoPE,
shared experts, leading dense layers, top-k weights not renormalised).
The shared fields keep the JAX package's meaning, so ``ModelConfig``'s
fields and every configuration the two packages share stay the same.

Layer structure: ``layer_pattern()`` gives the homogeneous (MLA, MoE)
groups only, so the engine's ``n_groups``, the activation statistics and
the placement cover the MoE layers; ``prefix_pattern()`` gives the
``dense_prefix`` leading (MLA, dense MLP) layers, which run ahead of them.
Registered configurations: ``configs/deepseek_v2_lite_mla.py``.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import MLP, MOE, ModelConfig

MLA = "mla"  # block kind: multi-head latent attention


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # YaRN (``rope_scaling``): factor, original context, the correction
    # range's betas, mscale and mscale_all_dim
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    n_shared_experts: int = 2
    dense_prefix: int = 1          # first_k_dense_replace
    dense_d_ff: int = 10944        # the dense layers' SwiGLU width
    norm_topk_prob: bool = False   # renormalise the top-k weights

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def latent_dim(self) -> int:
        """Values a token and layer holds in the latent pool: the normed
        latent ``c`` and the roped ``k_pe``."""
        return self.kv_lora_rank + self.qk_rope_dim

    @property
    def shared_d_ff(self) -> int:
        return self.n_shared_experts * self.d_ff

    def padded_heads(self, ep: int) -> int:
        """MLA's heads share one latent row: nothing to pad."""
        return self.num_heads

    def layer_pattern(self):
        return (MLA, MOE), self.num_layers - self.dense_prefix

    def prefix_pattern(self):
        return (MLA, MLP), self.dense_prefix

    @property
    def has_attention(self) -> bool:
        return True

    def softmax_scale(self) -> float:
        """``qk_head_dim ** -0.5 * m ** 2``, ``m = 0.1 * mscale_all_dim *
        ln(factor) + 1`` (YaRN's attention factor)."""
        m = 0.1 * self.mscale_all_dim * math.log(self.rope_factor) + 1.0
        return self.qk_head_dim ** -0.5 * m * m

    def param_count(self) -> int:
        d, h = self.d_model, self.num_heads
        attn = (d * h * self.qk_head_dim + d * self.latent_dim
                + self.kv_lora_rank * h * (self.qk_nope_dim + self.v_head_dim)
                + h * self.v_head_dim * d + self.kv_lora_rank + d)
        moe = (self.num_experts + self.n_shared_experts) * 3 * d * self.d_ff \
            + d * self.num_experts + d
        dense = 3 * d * self.dense_d_ff + d
        _, n_moe = self.layer_pattern()
        head = self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
        return head + self.dense_prefix * (attn + dense) + n_moe * (attn + moe)

    def reduced(self) -> "MLAConfig":
        """A small variant for tests: one dense and two MoE layers, d_model
        256, 8 experts top-3, small nope, value and expert widths; the
        latent read keeps the paged MLA kernel's widths (16 heads, a
        512-value latent and 64 rope dims)."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=3, d_model=256,
            d_ff=64, vocab_size=512, head_dim=32, num_experts=8, top_k=3,
            qk_nope_dim=32, v_head_dim=32, dense_prefix=1, dense_d_ff=128)

    def active_param_count(self) -> int:
        _, n_moe = self.layer_pattern()
        idle = (self.num_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return self.param_count() - n_moe * idle
