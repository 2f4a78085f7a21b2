"""Grouped SwiGLU expert FFN: the CUDA kernels' wrappers (forward and
backward), their plain versions and the ``torch.autograd.Function`` that
joins them (kernel source: ``csrc/moe_gmm.cu``; the forward replaces the
Pallas TPU kernel ``repro.kernels.moe_gmm.moe_gmm``, which has no
backward).

Both take per-slot fill counts: ``fill[s]`` rows of slot ``s`` were routed
there, and rows at or past ``min(fill[s], max_fill)`` come out zero.
``max_fill`` is a host-side bound on every fill (the caller knows how many
token rows it dispatched) that sizes the kernel's ``[S, max_fill, F]``
scratch and its row tile.

The kernel has two variants, chosen up front by ``select_variant`` from the
dtype, the widths and the alignment: ``"tc"`` (bf16 on the tensor cores)
and ``"simt"`` (the CUDA cores: fp32, and bf16 at other widths). The
forward's ``"tc"`` variant has two designs, chosen by ``select_design``
from ``max_fill``: ``"stream"`` (``gmm_tc``, the weight stream for decode
and chunk fills, its row tile and split-K factors from ``tc_plan``) and
``"rows"`` (``gmm_rows``, row tiles fed by TMA on persistent two-block
clusters that multicast the weights, for prefill and train fills, its
grids from ``rows_plan``). The backward takes
the same variants (``"tc"``: four ``wgmma`` kernels, ``bwd_plan``;
``"simt"``: seven products on the CUDA cores): it recomputes ``x w1`` and
``x w3`` over the filled rows and takes every gradient there; rows past the
fill get zero gradient and add nothing to the weight gradients.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_gmm_ref

launches = 0  # forward launches in this process (a run resets it to 0)
launches_by_variant = {"tc": 0, "simt": 0}  # the same launches, by variant
launches_by_design = {"stream": 0, "rows": 0}  # the "tc" ones, by design
bwd_launches = 0  # backward launches (each runs the four wgmma kernels of
# the "tc" variant or the seven products of "simt")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "tc": 1}  # moe_gmm_bwd_launch's variant codes
_DESIGNS = {"simt": 0, "stream": 1, "rows": 2}  # moe_gmm_launch's
# the tensor-core kernel's tiles (they must match tc:: in csrc/moe_gmm.cu)
ROW_TILES = (8, 16, 32, 64, 128)  # rows a block covers at once (8 * NT)
UP_COLS, DOWN_COLS = 64, 128  # weight columns per block: pass 1 (of w1 and
# of w3), pass 2 (of w2)
K_DEPTH = 64  # reduction depth of one pipeline stage (kBK)
MAX_SPLITS = 8
# the row-tile design (they must match rows:: in csrc/moe_gmm.cu): rows a
# tile (two consumer warpgroups), output columns a tile in pass 1 (of w1,
# and the same of w3) and pass 2 (of w2), and one block's shared memory:
# a 4-stage ring of 48 KB stages, two 16 KB output stagings, 8 mbarriers
# and 1 KB of alignment
ROWS_TILE, ROWS_UP_COLS, ROWS_DOWN_COLS = 128, 128, 256
ROWS_CLUSTER = 2  # blocks of a cluster (two row tiles share weight boxes)
ROWS_SMEM = 4 * 49152 + 2 * 16384 + 8 * 8 + 1024
# the design crossover: "rows" when max_fill is above it (see select_design)
ROWS_MIN_FILL = 128
# the tensor-core backward's kernels (they must match wg:: in
# csrc/moe_gmm.cu): output rows a tile (two warpgroups), reduction depth of
# a stage, stages in the ring, and each kernel's tile columns and bytes a
# stage (64-row swizzled atoms of 8 KB)
BWD_ROWS, BWD_DEPTH, BWD_STAGES = 128, 64, 4
BWD_KERNELS = {"gate": (64, 7 * 8192), "dx": (128, 4 * 8192),
               "dw13": (128, 6 * 8192), "dw2": (128, 4 * 8192)}


def select_variant(dtype, D: int, F: int, aligned: bool = True) -> str:
    """``"tc"`` for bf16 with ``D % 8 == F % 8 == 0`` and 16-byte aligned
    tensors (the tensor-core kernel's 16-byte copies), else ``"simt"``."""
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 and aligned:
        return "tc"
    return "simt"


def tc_plan(S: int, D: int, F: int, m: int, sms: int = 132):
    """The tensor-core kernel's launch plan for ``m`` rows per slot at most:
    ``(row_tile, ks_up, ks_down)``. The row tile is the smallest of
    ``ROW_TILES`` that holds ``min(m, 128)`` rows. A pass whose grid (column
    tiles x S slots) gives fewer than 2 blocks per SM is split along its
    reduction axis into enough parts for 4 blocks per SM, at most 8 and at
    most one per pipeline stage of the axis."""
    rows = next(r for r in ROW_TILES if r >= min(max(m, 1), ROW_TILES[-1]))

    def splits(cols: int, block_cols: int, depth: int) -> int:
        blocks = -(-cols // block_cols) * S
        if blocks >= 2 * sms:
            return 1
        return max(1, min(MAX_SPLITS, -(-depth // K_DEPTH),
                          -(-4 * sms // blocks)))

    return rows, splits(F, UP_COLS, D), splits(D, DOWN_COLS, F)


def select_design(variant: str, m: int) -> str:
    """Which forward kernels run for at most ``m`` rows a slot
    (``max_fill``, known on the host and fixed by a CUDA-graph capture; no
    device value decides): ``"simt"`` for the CUDA-core variant; for
    ``"tc"``, ``"rows"`` when ``m > ROWS_MIN_FILL``, else ``"stream"``.

    The stream's largest row tile is 128 rows, so every decode and chunk
    fill (``m`` <= 128) keeps its weight stream and split-K plan
    (``tc_plan``); above it the stream re-reads each weight column once
    per 128-row tile, while ``"rows"`` walks row tiles x column tiles.
    Both designs timed at ``chip_smoke.GMM_CASES``' bf16 rows at
    Mixtral-8x7B width on an NVIDIA H100 80GB HBM3 at 700 W
    (``tools/gmm_designs.py``; PERF.md §6), stream / rows in ms: at or
    below 128, decode 1.131 / 1.259, decode-C8 0.697 / 0.928, chunk
    1.175 / 1.244, the 12-slot cluster step 1.582 / 1.653, full-tile
    1.269 / 1.038 (every slot at 128 rows, which max_fill cannot tell
    from a chunk); above, generate's prefill (400) 1.741 / 1.428, the EP
    train step (2048) 6.185 / 2.446, the 32k prefill 85.195 / 33.543."""
    if variant != "tc":
        return "simt"
    return "rows" if m > ROWS_MIN_FILL else "stream"


def rows_plan(S: int, D: int, F: int, m: int, sms: int = 132) -> dict:
    """The row-tile design's two launches for at most ``m`` rows a slot,
    ``{"up": {...}, "down": {...}}``, each ``{"grid": blocks, "smem":
    bytes, "tiles": the most cluster tiles}``, as the source computes
    them: persistent clusters of ``ROWS_CLUSTER`` blocks of 384 threads,
    one block per SM, fewer clusters where the pass has fewer cluster
    tiles (``ROWS_CLUSTER`` row tiles of 128 rows, at ``m`` rows every
    slot, x ``ROWS_UP_COLS`` columns of F in pass 1 or ``ROWS_DOWN_COLS``
    of D in pass 2), and at least one."""
    pairs = S * -(-max(m, 1) // (ROWS_CLUSTER * ROWS_TILE))
    out = {}
    for name, cols, width in (("up", F, ROWS_UP_COLS),
                              ("down", D, ROWS_DOWN_COLS)):
        tiles = pairs * -(-cols // width)
        clusters = max(1, min(sms // ROWS_CLUSTER, tiles))
        out[name] = {"grid": ROWS_CLUSTER * clusters, "smem": ROWS_SMEM,
                     "tiles": tiles}
    return out


def scratch_shapes(S: int, D: int, F: int, m: int, variant: str,
                   sms: int = 132):
    """What the wrapper allocates beside the output for ``m`` rows per
    slot: ``{"mid": [S, m, F] in x's type, "part": [n] fp32}``. ``part``
    holds the split-K partial sums of the stream design (the larger of
    the two passes'; pass 1 keeps w1's and w3's columns), and is empty when
    neither pass is split, the design is ``"rows"`` (no split-K) or the
    variant is ``"simt"``."""
    n = 0
    if select_design(variant, m) == "stream":
        _, ks_up, ks_down = tc_plan(S, D, F, m, sms)
        n = max(ks_up * 2 * F if ks_up > 1 else 0,
                ks_down * D if ks_down > 1 else 0) * S * m
    return {"mid": (S, m, F), "part": (n,)}


def bwd_scratch_shapes(S: int, D: int, F: int, m: int, variant: str) -> dict:
    """What the backward allocates beside its gradients for ``m`` rows per
    slot: ``{"g": [3, S, m, F] in x's type (da, db and the gated
    intermediate)}``, and for ``"simt"`` also ``"ab": [2, S, m, F]`` fp32
    (the recomputed x w1 and x w3; the ``"tc"`` gate kernel keeps them in
    registers)."""
    if variant == "tc":
        return {"g": (3, S, m, F)}
    return {"ab": (2, S, m, F), "g": (3, S, m, F)}


def bwd_plan(S: int, D: int, F: int, m: int, variant: str = "tc",
             sms: int = 132) -> dict:
    """The tensor-core backward's four launches for ``m`` rows per slot,
    ``{kernel: {"grid": blocks, "smem": bytes}}``, as the source computes
    them: one persistent block of 256 threads per SM, fewer where a kernel
    has fewer tiles (``gate``: at most the row tiles of ``m`` rows x 64
    columns of F of every slot; ``dw13`` / ``dw2``: the 128 x 128 tiles of
    [D, F] / [F, D] of every slot; ``dx`` always one per SM, for its zero
    rows), each with a 4-stage ring plus 1 KB of alignment. The CUDA-core
    backward (``"simt"``) has no plan beyond ``bwd_scratch_shapes``."""
    if variant != "tc":
        raise ValueError(f"moe_gmm: no backward plan for variant {variant!r}")
    rows = -(-max(m, 1) // BWD_ROWS)
    tiles = {"gate": S * rows * -(-F // BWD_KERNELS["gate"][0]),
             "dx": sms,
             "dw13": S * -(-D // BWD_ROWS) * -(-F // BWD_KERNELS["dw13"][0]),
             "dw2": S * -(-F // BWD_ROWS) * -(-D // BWD_KERNELS["dw2"][0])}
    return {name: {"grid": min(sms, tiles[name]),
                   "smem": BWD_STAGES * stage + 1024}
            for name, (_, stage) in BWD_KERNELS.items()}


def plain(x, w1, w3, w2, fill, max_fill: int):
    """The kernel's function in plain PyTorch: ``moe_gmm_ref`` on the rows
    below the fill, zeros elsewhere (rows at or past ``max_fill`` are never
    computed). Rows past the fill are never read, as in the kernel: they
    enter the products as zeros, so whatever they hold (the dispatcher
    leaves them unwritten) reaches neither the output nor a gradient."""
    S, C, D = x.shape
    m = max(0, min(int(max_fill), C))
    n = torch.clamp(fill.to(device=x.device, dtype=torch.int64), max=m)
    keep = torch.arange(C, device=x.device)[None, :, None] < n[:, None, None]
    y = torch.zeros_like(x)
    if m:
        xs = torch.where(keep[:, :m], x[:, :m], torch.zeros_like(x[:, :m]))
        y[:, :m] = moe_gmm_ref(xs, w1, w3, w2)
    return torch.where(keep, y, torch.zeros_like(y))


def plain_bwd(x, w1, w3, w2, fill, max_fill: int, dy):
    """The backward kernel's function in plain PyTorch: autograd through
    ``plain``. Returns ``(dx, dw1, dw3, dw2)`` in the inputs' types."""
    leaves = [t.detach().requires_grad_(True) for t in (x, w1, w3, w2)]
    with torch.enable_grad():
        y = plain(*leaves, fill, max_fill)
        return torch.autograd.grad(y, leaves, dy)


def _check(x, w1, w3, w2, fill, dy=None):
    """Raise unless the tensors are what the kernels take (the backward's
    also ``dy``); returns (S, C, D, F)."""
    S, C, D = x.shape
    F = w1.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"moe_gmm: unsupported dtype {x.dtype}")
    want = [("x", x, (S, C, D)), ("w1", w1, (S, D, F)), ("w3", w3, (S, D, F)),
            ("w2", w2, (S, F, D))]
    if dy is not None:
        want.append(("dy", dy, (S, C, D)))
    for name, t, shape in want:
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
    return S, C, D, F


def launch(x, w1, w3, w2, fill, max_fill: int):
    """Run the CUDA kernel on the current stream. All tensors contiguous on
    one CUDA device: x [S, C, D], w1/w3 [S, D, F], w2 [S, F, D] of one
    float type (fp32 or bf16), fill [S] int32."""
    global launches
    S, C, D, F = _check(x, w1, w3, w2, fill)
    m = max(1, min(int(max_fill), C))
    y = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w1, w3, w2, y))
    variant = select_variant(x.dtype, D, F, aligned)
    design = select_design(variant, m)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    shapes = scratch_shapes(S, D, F, m, variant, sms)
    mid = torch.empty(shapes["mid"], dtype=x.dtype, device=x.device)
    part = torch.empty(shapes["part"], dtype=torch.float32, device=x.device)
    rows, ks_up, ks_down = tc_plan(S, D, F, m, sms)
    fn = build.library("moe_gmm").moe_gmm_launch
    rc = fn(
        _DTYPES[x.dtype],
        _DESIGNS[design],
        x.data_ptr(),
        w1.data_ptr(),
        w3.data_ptr(),
        w2.data_ptr(),
        fill.data_ptr(),
        mid.data_ptr(),
        part.data_ptr() if part.numel() else None,
        y.data_ptr(),
        S,
        C,
        D,
        F,
        m,
        rows // 8,
        ks_up,
        ks_down,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("moe_gmm", rc)
    launches += 1
    launches_by_variant[variant] += 1
    if variant == "tc":
        launches_by_design[design] += 1
    return y


def launch_bwd(x, w1, w3, w2, fill, max_fill: int, dy):
    """Run the backward kernels on the current stream; returns ``(dx, dw1,
    dw3, dw2)`` as ``plain_bwd`` does, over the rows below
    ``min(fill[s], max_fill)`` (rows of dx past it are 0)."""
    global bwd_launches
    S, C, D, F = _check(x, w1, w3, w2, fill, dy)
    m = max(1, min(int(max_fill), C))
    dx = torch.empty_like(x)
    dw1, dw3, dw2 = (torch.empty_like(w) for w in (w1, w3, w2))
    ts = (x, w1, w3, w2, dy, dx, dw1, dw3, dw2)
    variant = select_variant(x.dtype, D, F,
                             all(t.data_ptr() % 16 == 0 for t in ts))
    shapes = bwd_scratch_shapes(S, D, F, m, variant)
    g = torch.empty(shapes["g"], dtype=x.dtype, device=x.device)
    ab = (torch.empty(shapes["ab"], dtype=torch.float32, device=x.device)
          if "ab" in shapes else None)
    fn = build.library("moe_gmm").moe_gmm_bwd_launch
    rc = fn(_DTYPES[x.dtype], _VARIANTS[variant],
            *(t.data_ptr() for t in (x, w1, w3, w2, fill, dy)),
            None if ab is None else ab.data_ptr(),
            *(t.data_ptr() for t in (g, dx, dw1, dw3, dw2)),
            S, C, D, F, m, torch.cuda.current_stream(x.device).cuda_stream)
    build.check("moe_gmm_bwd", rc)
    bwd_launches += 1
    return dx, dw1, dw3, dw2


class MoeGmm(torch.autograd.Function):
    """``y = moe_gmm(x, w1, w3, w2, fill, max_fill)`` on the forward kernel,
    the gradients of x and the weights on the backward kernels (``fill``
    and ``max_fill`` take none). The forward keeps its inputs only when one
    needs a gradient."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2, fill, max_fill):
        args = [t.contiguous() for t in (x, w1, w3, w2)]
        y = launch(*args, fill, max_fill)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(*args, fill)
        ctx.max_fill = max_fill
        return y

    @staticmethod
    def backward(ctx, dy):
        *args, fill = ctx.saved_tensors
        grads = launch_bwd(*args, fill, ctx.max_fill, dy.contiguous())
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None, None)
