"""Shared neural-net building blocks (plain PyTorch)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Normal(0, 1 / fan_in) weights drawn from ``gen`` (fp32, then cast).
    On the ``meta`` device (no data) an empty leaf: nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=gen, device=gen.device) / fan_in**0.5
    return w.to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, device=gen.device) * 0.02
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split layout, as the reference's ``apply_rope``)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: broadcastable to [..., T]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # [hd/2]
    ang = positions[..., None].float() * freqs  # [..., T, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_params(gen, d: int, f: int, dtype=torch.float32, device="cuda") -> dict:
    return {
        "w1": dense_init(gen, (d, f), 0, dtype, device),
        "w3": dense_init(gen, (d, f), 0, dtype, device),
        "w2": dense_init(gen, (f, d), 0, dtype, device),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, T, C]; w: [C, K]; b: [C]. The
    reference's K unrolled shifted adds (``F.conv1d`` would run through
    cuDNN, in TF32 by default on the card)."""
    k = w.shape[-1]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):  # sum_j x[t - (K-1) + j] * w[:, j]
        out = out + xp[:, j:j + T, :] * w[:, j]
    return out + b


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy, fp32. logits [..., V], targets [...] int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - gold
