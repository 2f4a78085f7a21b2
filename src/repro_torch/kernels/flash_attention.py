"""Causal / sliding-window flash attention: the CUDA kernel's wrapper and
its plain version (kernel source: ``csrc/flash_attention.cu``; it replaces
the Pallas TPU kernel ``repro.kernels.flash_attention.flash_attention`` and
the GQA repeat of its wrapper). Layout as the JAX wrapper's:
q [B, T, H, hd], k/v [B, S, KVH, hd] -> [B, T, H, hd].

The kernel has two variants, chosen up front by ``select_variant``:
``"tc"`` (bf16 with hd a multiple of 16, on the tensor cores) and
``"simt"`` (the CUDA cores: fp32, and bf16 with other head sizes)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

launches = 0  # kernel launches in this process (a run resets it to 0)
launches_by_variant = {"tc": 0, "simt": 0}  # the same launches, by variant

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "tc": 1}


def select_variant(dtype, hd: int, aligned: bool = True) -> str:
    """``"tc"`` for bf16 with ``hd % 16 == 0`` (up to 128) and 16-byte
    aligned tensors (the tensor-core kernel's 16-byte copies), else
    ``"simt"``."""
    if (dtype == torch.bfloat16 and hd % 16 == 0 and hd <= MAX_HEAD_DIM
            and aligned):
        return "tc"
    return "simt"


def plain(q, k, v, *, causal=True, window=0):
    """``flash_attention_ref`` with the grouped KV heads expanded to the
    q heads, as ``repro.kernels.ops.flash_attention`` does."""
    B, Tq, H, hd = q.shape
    grp = H // k.shape[2]
    kx = torch.repeat_interleave(k, grp, dim=2)
    vx = torch.repeat_interleave(v, grp, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, Tq, hd)
    kf = kx.transpose(1, 2).reshape(B * H, -1, hd)
    vf = vx.transpose(1, 2).reshape(B * H, -1, hd)
    o = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return o.reshape(B, H, Tq, hd).transpose(1, 2)


def launch(q, k, v, *, causal=True, window=0):
    """Run the CUDA kernel on the current stream (contiguous CUDA tensors
    of one float type, fp32 or bf16; hd <= 128; H % KVH == 0)."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the backward kernel is not written yet, so the "
            "kernel cannot run under autograd (its output would carry no "
            "gradient)")
    B, Tq, H, hd = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    Tk, kvh = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM or H % kvh:
        raise ValueError(f"flash_attention: needs hd <= 128 and H % KVH == 0 "
                         f"(hd={hd}, H={H}, KVH={kvh})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    o = torch.empty_like(q)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, o))
    variant = select_variant(q.dtype, hd, aligned)
    fn = build.library("flash_attention").flash_attention_launch
    rc = fn(
        _DTYPES[q.dtype],
        _VARIANTS[variant],
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        o.data_ptr(),
        B,
        Tq,
        Tk,
        H,
        kvh,
        hd,
        int(bool(causal)),
        int(window),
        float(hd**-0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check("flash_attention", rc)
    launches += 1
    launches_by_variant[variant] += 1
    return o
