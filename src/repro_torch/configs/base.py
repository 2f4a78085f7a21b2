"""Model / run configuration for the DanceMoE reproduction framework.

One flexible decoder-only stack covers every assigned architecture family:
dense, MoE, SSM (mamba1/mamba2), hybrid (mamba2 + shared attention), and the
VLM / audio backbones (whose modality frontends are stubbed — ``input_specs``
feeds pre-computed patch/frame embeddings of the right shape).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

# Block kinds used by the layer pattern (scan groups).
ATTN = "attn"            # self-attention sublayer
MLP = "mlp"              # dense FFN sublayer
MOE = "moe"              # mixture-of-experts FFN sublayer
MAMBA1 = "mamba1"        # mamba-1 selective-scan block (token+channel mixing)
MAMBA2 = "mamba2"        # mamba-2 (SSD) block
SHARED_ATTN = "shared_attn"  # zamba2-style shared-weight attention block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # MoE FFN every k-th layer (others dense)
    # --- SSM ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # mamba2 head dim
    ssm_version: int = 0           # 1 or 2
    attn_every: int = 0            # hybrid: shared attn block every k SSM layers
    # --- attention details ---
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = full attention
    use_qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- modality frontend stub ---
    frontend: str = "none"         # none | vision | audio
    # --- misc ---
    norm_eps: float = 1e-5
    source: str = ""               # citation for the assigned config

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def padded_heads(self, ep: int) -> int:
        """q heads padded up so the head dim shards evenly over `ep` ranks.

        Padding is realised with zero rows in the qkv/o projections, so the
        model function is exactly preserved (pad heads contribute nothing).
        """
        h = self.num_heads
        hp = int(math.ceil(h / ep) * ep)
        # expanded-kv grouping needs hp % num_kv_heads == 0
        while self.num_kv_heads and hp % self.num_kv_heads:
            hp += ep
        return hp

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ------------------------------------------------------------------
    def layer_pattern(self) -> tuple[tuple[str, ...], int]:
        """Return (block kinds within one scan group, number of groups).

        The model is a ``lax.scan`` over `n_groups` stacked parameter groups;
        each group applies the listed sublayers in order. All groups share a
        single structure so the HLO stays compact at 80 layers.
        """
        if self.family in ("dense", "vlm", "audio"):
            return (ATTN, MLP), self.num_layers
        if self.family == "moe":
            if self.moe_every == 1:
                return (ATTN, MOE), self.num_layers
            pat: list[str] = []
            for i in range(self.moe_every):
                pat += [ATTN, MOE if (i == self.moe_every - 1) else MLP]
            assert self.num_layers % self.moe_every == 0
            return tuple(pat), self.num_layers // self.moe_every
        if self.family == "ssm":
            kind = MAMBA1 if self.ssm_version == 1 else MAMBA2
            return (kind,), self.num_layers
        if self.family == "hybrid":
            assert self.attn_every > 0 and self.num_layers % self.attn_every == 0
            kind = MAMBA1 if self.ssm_version == 1 else MAMBA2
            return (SHARED_ATTN,) + (kind,) * self.attn_every, \
                self.num_layers // self.attn_every
        raise ValueError(f"unknown family {self.family}")

    @property
    def has_attention(self) -> bool:
        pat, _ = self.layer_pattern()
        return ATTN in pat or SHARED_ATTN in pat

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode is supported natively (SSM/hybrid with
        shared-attn treated via full cache) or via sliding window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops and memory)."""
        pat, n_groups = self.layer_pattern()
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += d  # final norm
        per_group = 0
        for kind in pat:
            if kind in (ATTN,):
                qd = self.num_heads * hd
                kvd = self.num_kv_heads * hd
                per_group += d * (qd + 2 * kvd) + qd * d + d  # qkv + o + norm
            elif kind == MLP:
                per_group += 3 * d * self.d_ff + d
            elif kind == MOE:
                per_group += self.num_experts * 3 * d * self.d_ff
                per_group += d * self.num_experts + d  # router + norm
            elif kind in (MAMBA1, MAMBA2):
                di, n = self.d_inner, self.ssm_state
                per_group += d * 2 * di            # in_proj
                per_group += di * self.ssm_conv    # conv
                if kind == MAMBA1:
                    per_group += di * (2 * n) + di * (di // 16) * 2 + di  # B,C,dt
                else:
                    nh = self.ssm_heads
                    per_group += d * (2 * n + nh) + nh * 2  # BC+dt proj, A,D
                per_group += di * d + d            # out proj + norm
        total += per_group * n_groups
        if self.family == "hybrid":
            # shared attention weights counted once, not per group
            qd = self.num_heads * hd
            kvd = self.num_kv_heads * hd
            shared = d * (qd + 2 * kvd) + qd * d + d
            total -= shared * n_groups
            total += shared
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.is_moe:
            return self.param_count()
        pat, n_groups = self.layer_pattern()
        moe_layers = pat.count(MOE) * n_groups
        expert_p = 3 * self.d_model * self.d_ff
        inactive = moe_layers * (self.num_experts - self.top_k) * expert_p
        return self.param_count() - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (<=2 layers,
        d_model<=512, <=4 experts)."""
        pat, _ = self.layer_pattern()
        group = len(pat)
        kv = min(self.num_kv_heads, 2) if self.num_kv_heads else 0
        heads = 4 if self.num_heads else 0
        kw: dict[str, Any] = dict(
            name=self.name + "-smoke",
            family=self.family,
            num_layers=group if self.family == "hybrid" else
                       (2 * self.moe_every if self.family == "moe" else 2),
            d_model=256,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64 if self.num_heads else 0,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            moe_every=self.moe_every,
            ssm_state=self.ssm_state,
            ssm_conv=self.ssm_conv,
            ssm_expand=self.ssm_expand,
            ssm_head_dim=32 if self.ssm_version == 2 else 64,
            ssm_version=self.ssm_version,
            attn_every=self.attn_every,
            rope_theta=self.rope_theta,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            tie_embeddings=self.tie_embeddings,
            frontend=self.frontend,
            source=self.source,
        )
        if self.family == "hybrid":
            kw["num_layers"] = self.attn_every  # one scan group
        return ModelConfig(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> Sequence[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    import importlib
    for mod in (
        "starcoder2_3b", "qwen2_vl_72b", "tinyllama_1_1b", "falcon_mamba_7b",
        "zamba2_2_7b", "musicgen_large", "command_r_plus_104b",
        "llama4_maverick_400b", "yi_6b", "phi3_5_moe_42b",
        "mixtral_8x7b", "deepseek_v2_lite", "deepseek_v2_lite_mla",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
