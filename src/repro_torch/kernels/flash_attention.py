"""Causal / sliding-window flash attention: the CUDA kernels' wrappers
(forward and backward), their plain versions and the
``torch.autograd.Function`` that joins them (kernel source:
``csrc/flash_attention.cu``; the forward replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention`` and the GQA repeat of its
wrapper, which have no backward). Layout as the JAX wrapper's:
q [B, T, H, hd], k/v [B, S, KVH, hd] -> [B, T, H, hd].

The forward has two variants, chosen up front by ``select_variant``:
``"tc"`` (bf16 with hd a multiple of 16, on the tensor cores) and
``"simt"`` (the CUDA cores: fp32, and bf16 with other head sizes). It can
also write each query row's log-sum-exp ``lse [B, H, Tq]`` (fp32), which
the backward reads instead of recomputing the softmax statistics. The
backward takes the same variants (``"tc"``: ``wgmma`` kernels for hd 64 and
128, ``mma.sync`` ones for the other multiples of 16, see ``bwd_design``;
``"simt"``: the CUDA cores, any hd <= 128)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

launches = 0  # forward kernel launches in this process (a run resets it)
launches_by_variant = {"tc": 0, "simt": 0}  # the same launches, by variant
bwd_launches = 0  # backward launches (each runs the delta, dq and dk/dv
# kernels)

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "tc": 1}
BWD_TILE = 32  # CUDA-core backward: queries and keys per tile (kBwdTile)
TC_BWD_BLOCK = 64  # mma.sync backward: query rows of a dq block, keys of a
# dk/dv block, keys of a dq tile (kTbQ, kTbK)
TC_BWD_QTILE = 32  # mma.sync backward: queries of a dk/dv tile (kTbQt)
WG_BWD_HEAD_DIMS = (64, 128)  # head sizes of the wgmma backward kernels
WG_BWD_BLOCK = 128  # wgmma backward: query rows of a dq block, keys of a
# dk/dv block, 64 per consumer warpgroup (kWgBlock)
WG_BWD_TILE = 64  # wgmma backward: keys of a dq tile, queries of a dk/dv
# tile (kWgTile)
WG_BWD_STAGES = 4  # wgmma backward: walked tiles in the copy ring (kWgStages)
SMEM_PER_SM = 232448  # shared memory an SM gives its blocks


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


def stats_shape(B: int, Tq: int, H: int) -> tuple:
    """The forward's per-row statistics ``lse`` (and the backward's
    ``delta`` scratch): fp32 [B, H, Tq]."""
    return (B, H, Tq)


def bwd_design(dtype, hd: int, aligned: bool = True) -> str:
    """Which backward kernels run: ``"wg"`` (``wgmma``: bf16 tensor-core
    variant at hd 64 or 128), ``"mma"`` (``mma.sync``: the other bf16
    tensor-core head sizes) or ``"simt"`` (the CUDA cores)."""
    if select_variant(dtype, hd, aligned) == "simt":
        return "simt"
    return "wg" if hd in WG_BWD_HEAD_DIMS else "mma"


def bwd_plan(B: int, Tq: int, Tk: int, H: int, KVH: int, hd: int,
             variant: str = "simt") -> dict:
    """The backward kernels' launch plan for ``variant``: which ``design``
    runs, grids of the dq kernel (query blocks x B*H) and of the dk/dv
    kernel (key blocks x B*KVH), the row stride of their shared tiles in
    elements, the shared memory of each, ``(dq, dk/dv)`` bytes, and the
    blocks an SM holds at the occupancy the source asks for, as the source
    computes them, and the ``delta`` scratch shape. ``"simt"``: four fp32
    row tiles of 32 rows at ``row_stride`` (hd rounded up to 4, plus 4
    where that makes the stride 4 x an odd number), P and dS of a 32 x 32
    tile, 32 rows' lse and delta (``bwd_smem_bytes``). ``"tc"`` at hd 64
    and 128 (``"wg"``): blocks of 128 rows (two warpgroups) over tiles of
    64 rows, in 128-byte swizzled rows of 64 elements; dq holds Q and dO
    and a 4-stage ring of K, V tiles, dk/dv K and V and a 4-stage ring of
    Q, dO tiles with their lse and delta rows, each with two 8-byte
    mbarriers a stage and 1 KB of alignment (``wg_dq_smem``,
    ``wg_dkdv_smem``), one block an SM
    (``__launch_bounds__(256, 1)``). ``"tc"`` at other hd (``"mma"``):
    bf16 rows of hd + 8; dq holds Q, dO and two stages of K, V (64 rows
    each), dk/dv holds K, V and two stages of Q, dO tiles of 32 rows
    (``tc_dq_smem``, ``tc_dkdv_smem``), two blocks an SM."""
    delta = stats_shape(B, Tq, H)
    if variant == "tc" and hd in WG_BWD_HEAD_DIMS:
        blk, tile, stages = WG_BWD_BLOCK, WG_BWD_TILE, WG_BWD_STAGES
        # resident pair, ring of walked pairs, mbarriers, alignment
        dq = (2 * blk * hd * 2 + stages * 2 * tile * hd * 2 + 2 * stages * 8
              + 1024)
        return {
            "design": "wg",
            "dq_grid": (-(-Tq // blk), B * H),
            "dkdv_grid": (-(-Tk // blk), B * KVH),
            "row_stride": 64,
            "smem_bytes": (dq, dq + stages * 2 * tile * 4),
            "blocks_per_sm": 1,
            "delta": delta,
        }
    if variant == "tc":
        blk, qt, ld = TC_BWD_BLOCK, TC_BWD_QTILE, hd + 8
        return {
            "design": "mma",
            "dq_grid": (-(-Tq // blk), B * H),
            "dkdv_grid": (-(-Tk // blk), B * KVH),
            "row_stride": ld,
            "smem_bytes": (2 * (2 * blk + 4 * blk) * ld,
                           2 * (2 * blk + 4 * qt) * ld),
            "blocks_per_sm": 2,
            "delta": delta,
        }
    hd4 = -(-hd // 4) * 4
    ld = hd4 + 4 if hd4 % 8 == 0 else hd4
    tile = BWD_TILE
    smem = 4 * (4 * tile * ld + 2 * tile * (tile + 1) + 2 * tile)
    return {
        "design": "simt",
        "dq_grid": (-(-Tq // tile), B * H),
        "dkdv_grid": (-(-Tk // tile), B * KVH),
        "row_stride": ld,
        "smem_bytes": (smem, smem),
        "blocks_per_sm": 2,
        "delta": delta,
    }


def plain_bwd(q, k, v, do, *, causal=True, window=0):
    """The backward kernels' function in plain PyTorch: autograd through
    ``plain``. Returns ``(dq, dk, dv)`` in the inputs' types."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        o = plain(*leaves, causal=causal, window=window)
        return torch.autograd.grad(o, leaves, do)


def _check(q, k, v, extra=()):
    """Raise unless the tensors are what the kernels take; ``extra`` are
    further ``(name, tensor, shape, dtype)`` to check. Returns (B, Tq, Tk,
    H, KVH, hd)."""
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
    want = [("q", q, None, q.dtype), ("k", k, None, q.dtype),
            ("v", v, None, q.dtype), *extra]
    for name, t, shape, dtype in want:
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"flash_attention: {name} is {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_cuda or t.device != q.device or t.dtype != dtype:
            raise ValueError(f"flash_attention: {name} must be {dtype} on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    return B, Tq, Tk, H, kvh, hd


def launch(q, k, v, *, causal=True, window=0, lse=None):
    """Run the forward kernel on the current stream (contiguous CUDA tensors
    of one float type, fp32 or bf16; hd <= 128; H % KVH == 0). With ``lse``
    (fp32 ``stats_shape``), the kernel also writes each row's log-sum-exp
    of the scaled scores there."""
    global launches
    extra = ()
    if lse is not None:
        B, Tq, H = q.shape[:3]
        extra = (("lse", lse, stats_shape(B, Tq, H), torch.float32),)
    B, Tq, Tk, H, kvh, hd = _check(q, k, v, extra)
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
        None if lse is None else lse.data_ptr(),
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


def launch_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    """Run the backward kernels on the current stream over the forward's
    output ``o`` and statistics ``lse``; returns ``(dq, dk, dv)`` as
    ``plain_bwd`` does (dk, dv summed over each KV head's q heads)."""
    global bwd_launches
    B, Tq, H, hd = q.shape
    B, Tq, Tk, H, kvh, hd = _check(q, k, v, (
        ("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
        ("lse", lse, stats_shape(B, Tq, H), torch.float32)))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    variant = select_variant(q.dtype, hd, all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, o, do, dq, dk, dv)))
    plan = bwd_plan(B, Tq, Tk, H, kvh, hd, variant)
    delta = torch.empty(plan["delta"], dtype=torch.float32, device=q.device)
    ts = (q, k, v, o, lse, do, dq, dk, dv, delta)
    fn = build.library("flash_attention").flash_attention_bwd_launch
    rc = fn(_DTYPES[q.dtype], _VARIANTS[variant], *(t.data_ptr() for t in ts),
            B, Tq, Tk, H, kvh, hd,
            int(bool(causal)), int(window), float(hd**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention_bwd", rc)
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``o = flash_attention(q, k, v)`` on the forward kernel, its gradients
    on the backward kernels. The forward writes and keeps the row
    statistics (and keeps q, k, v, o) only when an input needs a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0):
        q, k, v = (t.contiguous() for t in (q, k, v))
        need = any(ctx.needs_input_grad[:3])
        lse = None
        if need:
            B, Tq, H = q.shape[:3]
            lse = torch.empty(stats_shape(B, Tq, H), dtype=torch.float32,
                              device=q.device)
        o = launch(q, k, v, causal=causal, window=window, lse=lse)
        if need:
            ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = launch_bwd(q, k, v, o, lse, do.contiguous(),
                                causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
