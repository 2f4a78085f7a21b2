"""The yardstick's arithmetic: the chip's data-sheet peaks, the model FLOPs a
token needs, and the least time ``moe_gmm``'s work can take.

Peaks: NVIDIA H100 SXM data sheet, dense, without sparsity, at the 700 W
limit: 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2  # bytes


def layer_params_active(s: dict) -> int:
    """Parameters one token multiplies by in one layer: the attention
    projections at the published head count, the router and ``top_k``
    experts."""
    d, hd = s["d"], s["hd"]
    q, kv = s["heads"] * hd, s["kv_heads"] * hd
    return d * (q + 2 * kv) + q * d + d * s["experts"] \
        + s["top_k"] * 3 * d * s["ff"]


def token_flops(s: dict, context: np.ndarray, logits: bool) -> float:
    """Model FLOPs of tokens that attend over ``context`` positions each
    (their own included): 2 x active parameters per layer, plus attention's
    4 x heads x head_dim x context per layer; plus the output head where
    the token's logits are produced."""
    context = np.asarray(context, np.float64)
    per_layer = 2.0 * layer_params_active(s) * context.size \
        + 4.0 * s["heads"] * s["hd"] * context.sum()
    head = 2.0 * s["d"] * s["vocab"] * context.size if logits else 0.0
    return s["layers"] * per_layer + head


def prompt_flops(s: dict, prompt_len: int, skipped: int) -> float:
    """A prompt's computed positions ``skipped .. prompt_len - 1``, each
    attending over the positions up to itself; its last position's logits
    give the first token."""
    ctx = np.arange(skipped + 1, prompt_len + 1)
    return token_flops(s, ctx, False) + 2.0 * s["d"] * s["vocab"]


def decode_flops(s: dict, prompt_len: int, k: int) -> float:
    """The decode step that yields output token ``k`` (k >= 1): its input
    sits at position ``prompt_len + k - 1`` and attends over
    ``prompt_len + k`` positions."""
    return token_flops(s, np.array([prompt_len + k]), True)


def gmm_least_seconds(s: dict, counts: np.ndarray) -> float:
    """Least time the chip could take for the expert work routed in one
    step: ``counts [layers, origins, experts]`` routed (token, expert)
    rows. Per layer: FLOPs 2 x 3 x d x d_ff a row; bytes, each expert that
    received a row read once, plus the rows in and out; the bound is the
    larger of FLOPs over the bf16 peak and bytes over HBM bandwidth."""
    d, f = s["d"], s["ff"]
    per_expert = counts.sum(axis=1)  # [L, E]
    rows = per_expert.sum(axis=1)  # [L]
    flops = 2.0 * 3 * d * f * rows
    nbytes = ((per_expert > 0).sum(axis=1) * 3.0 * d * f * BF16
              + rows * 2.0 * d * BF16)
    return float(np.maximum(flops / PEAK_BF16_FLOPS,
                            nbytes / PEAK_HBM_BYTES).sum())
