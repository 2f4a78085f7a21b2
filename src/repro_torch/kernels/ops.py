"""Device dispatch for the kernels: a CUDA tensor goes to the hand-written
kernel (which raises if it cannot build or launch), a CPU tensor to the
kernel's plain version. Inside ``shape_only()`` a ``meta`` tensor (no data,
no device: the launch tools' dry run) takes the plain version too (the
scan: ``ssm_scan.meta_trace``); outside it a meta tensor raises. There is
no other route. ``on_card`` is that choice; ``paged_attention`` and
``paged_mla`` are the kernels alone, because their plain versions, the
gathered reads, live in the models layer beside the dense caches' reads
whose loops they share (``models.attention.paged_attention`` and
``models.mla.paged_mla`` make the same choice through ``on_card``).

``phase_mark`` launches a phase's marker kernel (``kernels.phase_marks``)
inside a ``marks()`` region on the card, and does nothing anywhere else:
there is nothing to fall back from."""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import paged_mla as _mla
from repro_torch.kernels import phase_marks as _marks
from repro_torch.kernels import ssm_scan as _ssm


_shape_only = False


@contextlib.contextmanager
def shape_only():
    """Let ``meta`` tensors through to the plain versions while the block
    runs: a dry run that traces the step's shapes, types and FLOPs. CUDA
    tensors still launch the kernels (or raise)."""
    global _shape_only
    before, _shape_only = _shape_only, True
    try:
        yield
    finally:
        _shape_only = before


_marking = 0


@contextlib.contextmanager
def marks():
    """Let ``phase_mark`` launch its marker kernels while the block runs:
    a traced runtime's graph capture, a traced engine's migration."""
    global _marking
    _marking += 1
    try:
        yield
    finally:
        _marking -= 1


def phase_mark(phase: str, t) -> None:
    """Mark the start of ``phase`` (``phase_marks.PHASES``) on the stream
    of CUDA tensor ``t``'s device, inside a ``marks()`` region; elsewhere,
    and for a tensor off the card, nothing."""
    if _marking and t.is_cuda:
        _marks.launch(phase, t.device)


_in_plain = 0


@contextlib.contextmanager
def _plain_region():
    global _in_plain
    _in_plain += 1
    try:
        yield
    finally:
        _in_plain -= 1


def in_plain_kernel() -> bool:
    """Whether a kernel's plain version is running: its matmuls stand for
    a hand kernel, which a remat policy cannot save (``transformer.
    _remat_kwargs``), so on the CPU and on meta they are recomputed as the
    kernels are on the card."""
    return _in_plain > 0


def on_card(t, name: str) -> bool:
    """Whether tensor ``t`` goes to kernel ``name`` (on the card) or to its
    plain version (on the CPU, or on ``meta`` inside ``shape_only()``);
    raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu" or (_shape_only and t.device.type == "meta"):
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def _differentiable(*ts) -> bool:
    """Whether autograd records this call: then the kernels' Function runs
    (the forward keeps what its backward kernel reads); else the forward
    kernel alone (no statistics written, nothing kept)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def moe_gmm(x, w1, w3, w2, fill, max_fill: int):
    """Grouped expert FFN [S, C, D] -> [S, C, D] over the filled rows (used
    by the EP MoE layer). On the card the forward and backward kernels
    (``MoeGmm``); on the CPU the plain version, which autograd
    differentiates."""
    if on_card(x, "moe_gmm"):
        if _differentiable(x, w1, w3, w2):
            return _gmm.MoeGmm.apply(x, w1, w3, w2, fill, max_fill)
        return _gmm.launch(x, w1, w3, w2, fill, max_fill)
    with _plain_region():
        return _gmm.plain(x, w1, w3, w2, fill, max_fill)


def flash_attention(q, k, v, *, causal=True, window=0):
    """Attention on [B, T, H, hd] with grouped KV [B, S, KVH, hd]. On the
    card the forward and backward kernels (``FlashAttention``); on the CPU
    the plain version, which autograd differentiates."""
    if on_card(q, "flash_attention"):
        if _differentiable(q, k, v):
            return _flash.FlashAttention.apply(q, k, v, causal, window)
        return _flash.launch(q, k, v, causal=causal, window=window)
    with _plain_region():
        return _flash.plain(q, k, v, causal=causal, window=window)


def paged_attention(q, k_pool, v_pool, page_table, q_offset, k_scale=None,
                    v_scale=None):
    """Causal attention of q [B, Tq, H, hd] over a paged pool [n_blocks,
    bs, KVH, hd] (q's type, or int8 codes with their ``k_scale`` and
    ``v_scale``) through the page table [B, P] from each row's
    ``q_offset`` [B] (the serving steps' read; no gradient): the kernel,
    which refuses tensors off the card. There the caller runs the plain
    version, ``models.attention.gathered_attention``."""
    return _paged.launch(q, k_pool, v_pool, page_table, q_offset, k_scale,
                         v_scale)


def paged_mla(q, pool, page_table, q_offset, scale: float, dv: int):
    """Causal absorbed MLA read of q [B, Tq, H, D] over a paged latent pool
    [n_blocks, bs, D] through the page table [B, P] from each row's
    ``q_offset`` [B], the values each row's first ``dv`` entries (the
    serving steps' read; no gradient): the kernel, which refuses tensors
    off the card. There the caller runs the plain version,
    ``models.mla.gathered_mla``."""
    return _mla.launch(q, pool, page_table, q_offset, scale, dv)


def ssm_scan(x, dt, Bs, Cs, A, D):
    """Mamba-1 selective scan x, dt [B, T, d]; Bs, Cs [B, T, N]; A [d, N];
    D [d] -> y [B, T, d]. On the card the forward and backward kernels
    (``SsmScan``); on the CPU the plain version, which autograd
    differentiates; on meta (``shape_only``) ``ssm_scan.meta_trace``."""
    if on_card(x, "ssm_scan"):
        return _ssm.SsmScan.apply(x, dt, Bs, Cs, A, D)
    with _plain_region():
        if x.device.type == "meta":
            return _ssm.meta_trace(x, dt, Bs, Cs, A, D)
        return _ssm.plain(x, dt, Bs, Cs, A, D)


# ---------------------------------------------------------------------------
# Launch counts across CUDA-graph capture and replay
# ---------------------------------------------------------------------------

_COUNTED = (_gmm, _flash, _ssm, _paged, _mla)
_BY = ("launches_by_variant", "launches_by_design", "launches_by_call")


def launch_counts() -> dict:
    """Every kernel wrapper's launch counters, flat: ``{"moe_gmm": n,
    "moe_gmm.tc": n, "moe_gmm.simt": n, "moe_gmm.stream": n,
    "moe_gmm.rows": n, "flash_attention": n, ..., "ssm_scan.bwd": n,
    "paged_attention": n, "paged_attention.decode": n,
    "paged_attention.chunk": n, "paged_mla": n, "paged_mla.decode": n,
    "paged_mla.chunk": n}`` (by variant, then, for ``moe_gmm``'s ``tc``,
    by design; the paged reads by call)."""
    out = {}
    for mod in _COUNTED:
        name = mod.__name__.rsplit(".", 1)[-1]
        out[name] = mod.launches
        for by in _BY:
            for k, v in getattr(mod, by, {}).items():
                out[f"{name}.{k}"] = v
        if hasattr(mod, "bwd_launches"):
            out[f"{name}.bwd"] = mod.bwd_launches
    return out


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add ``times * delta`` (keys as ``launch_counts`` gives them) to the
    wrappers' counters. A CUDA graph replay runs the kernels its capture
    recorded without running their wrappers: the graph adds its capture's
    delta once per replay, and takes it back once after the capture, which
    launched nothing."""
    for mod in _COUNTED:
        name = mod.__name__.rsplit(".", 1)[-1]
        mod.launches += times * delta.get(name, 0)
        for by in _BY:
            counts = getattr(mod, by, {})
            for k in counts:
                counts[k] += times * delta.get(f"{name}.{k}", 0)
        if hasattr(mod, "bwd_launches"):
            mod.bwd_launches += times * delta.get(f"{name}.bwd", 0)
