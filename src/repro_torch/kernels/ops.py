"""Device dispatch for the kernels: a CUDA tensor goes to the hand-written
kernel (which raises if it cannot build or launch), a CPU tensor to the
kernel's plain version. There is no other route."""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ssm_scan as _ssm


def _route(t, name: str):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def moe_gmm(x, w1, w3, w2, fill, max_fill: int):
    """Grouped expert FFN [S, C, D] -> [S, C, D] over the filled rows (used
    by the EP MoE layer)."""
    if _route(x, "moe_gmm"):
        return _gmm.launch(x, w1, w3, w2, fill, max_fill)
    return _gmm.plain(x, w1, w3, w2, fill, max_fill)


def flash_attention(q, k, v, *, causal=True, window=0):
    """Attention on [B, T, H, hd] with grouped KV [B, S, KVH, hd]."""
    if _route(q, "flash_attention"):
        return _flash.launch(q, k, v, causal=causal, window=window)
    return _flash.plain(q, k, v, causal=causal, window=window)


def ssm_scan(x, dt, Bs, Cs, A, D):
    """Mamba-1 selective scan x, dt [B, T, d]; Bs, Cs [B, T, N]; A [d, N];
    D [d] -> y [B, T, d]. On the card the forward and backward kernels
    (``SsmScan``); on the CPU the plain version, which autograd
    differentiates."""
    if _route(x, "ssm_scan"):
        return _ssm.SsmScan.apply(x, dt, Bs, Cs, A, D)
    return _ssm.plain(x, dt, Bs, Cs, A, D)
