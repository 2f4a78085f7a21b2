"""Grouped SwiGLU expert FFN: the CUDA kernel's wrapper and its plain
version (kernel source: ``csrc/moe_gmm.cu``; it replaces the Pallas TPU
kernel ``repro.kernels.moe_gmm.moe_gmm``).

Both take per-slot fill counts: ``fill[s]`` rows of slot ``s`` were routed
there, and rows at or past ``min(fill[s], max_fill)`` come out zero.
``max_fill`` is a host-side bound on every fill (the caller knows how many
token rows it dispatched) that sizes the kernel's ``[S, max_fill, F]``
scratch and its row tile.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_gmm_ref

launches = 0  # kernel launches in this process (a run resets it to 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain(x, w1, w3, w2, fill, max_fill: int):
    """The kernel's function in plain PyTorch: ``moe_gmm_ref`` on the rows
    below the fill, zeros elsewhere (rows at or past ``max_fill`` are never
    computed)."""
    S, C, D = x.shape
    m = max(0, min(int(max_fill), C))
    y = torch.zeros_like(x)
    if m:
        y[:, :m] = moe_gmm_ref(x[:, :m], w1, w3, w2)
    n = torch.clamp(fill.to(device=x.device, dtype=torch.int64), max=m)
    keep = torch.arange(C, device=x.device)[None, :, None] < n[:, None, None]
    return torch.where(keep, y, torch.zeros_like(y))


def launch(x, w1, w3, w2, fill, max_fill: int):
    """Run the CUDA kernel on the current stream. All tensors contiguous on
    one CUDA device: x [S, C, D], w1/w3 [S, D, F], w2 [S, F, D] of one
    float type (fp32 or bf16), fill [S] int32."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, w3, w2)):
        raise NotImplementedError(
            "moe_gmm: the backward kernel is not written yet, so the kernel "
            "cannot run under autograd (its output would carry no gradient)")
    S, C, D = x.shape
    F = w1.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"moe_gmm: unsupported dtype {x.dtype}")
    for name, t, shape in (
        ("x", x, (S, C, D)),
        ("w1", w1, (S, D, F)),
        ("w3", w3, (S, D, F)),
        ("w2", w2, (S, F, D)),
    ):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"moe_gmm: {name} must be on {x.device}")
        if t.dtype != x.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"moe_gmm: {name} is {t.dtype} {tuple(t.shape)}, expected "
                f"{x.dtype} {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"moe_gmm: {name} must be contiguous")
    if (
        fill.device != x.device
        or fill.dtype != torch.int32
        or tuple(fill.shape) != (S,)
        or not fill.is_contiguous()
    ):
        raise ValueError("moe_gmm: fill must be a contiguous [S] int32 on x's device")
    m = max(1, min(int(max_fill), C))
    y = torch.empty_like(x)
    mid = torch.empty((S, m, F), dtype=x.dtype, device=x.device)
    fn = build.library("moe_gmm").moe_gmm_launch
    rc = fn(
        _DTYPES[x.dtype],
        x.data_ptr(),
        w1.data_ptr(),
        w3.data_ptr(),
        w2.data_ptr(),
        fill.data_ptr(),
        mid.data_ptr(),
        y.data_ptr(),
        S,
        C,
        D,
        F,
        m,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("moe_gmm", rc)
    launches += 1
    return y
