"""The paged MLA read of the serving steps, in place from the latent pool:
the CUDA kernel's wrapper (kernel source: ``csrc/paged_mla.cu``). It
replaces no TPU kernel: the JAX package has no MLA. Its plain version, the
gathered read, lives in the models layer (``repro_torch.models.mla.
gathered_mla``).

``q`` [B, Tq, 16, 576] in bf16 or fp32: each head's absorbed query, the
latent part (``q_nope W_kvb_k^T``, 512) then the roped part (64);
``pool`` [n_blocks, bs, 576] of q's type, one latent row a position
(``[c; k_pe]``); ``page_table`` [B, P] physical block ids in logical
order, padded with the null block 0; ``q_offset`` [B] the absolute position
of each row's first query. Query ``t`` of row ``b`` attends causally to the
rows at positions ``<= q_offset[b] + t``, scored against the whole row
times ``scale``; the values are each row's first 512 entries, so the output
is [B, Tq, 16, 512] in q's type. The decode round is ``Tq = 1``, the chunk
call ``Tq = bs``. bf16 runs on the tensor cores, fp32 on the CUDA cores. An
int8 latent pool is refused.

The launch plan (``plan``) follows static shapes only, so a captured CUDA
graph stays valid for any lengths and tables: a block per (row, split,
group of query tokens), the 16 heads of a token one 16-row m-tile, each
block walking only its share of its row's live keys; with more than one
split a combine merges the splits in a fixed order."""

from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches in this process (a run resets it)
launches_by_call = {"decode": 0, "chunk": 0}  # by call: Tq == 1 is a
# decode round, anything else a chunk call

HEADS = 16  # q heads (kH): one m-tile a query token
LATENT = 576  # a latent row (kD): kv_lora_rank + qk_rope_dim
VALUES = 512  # value entries of a row (kDV)
TILE = 32  # keys per tile (kTK)
STAGES = 3  # tiles in the shared-memory ring (kStages)
QUARTERS = 4  # warps an m-tile (kKQ): QK^T split over the row's dims,
# PV over the value dims
MAX_MT = 2  # m-tiles (query tokens) a block (kMaxMT)
MAX_SPLITS = 32  # splits of a row (kMaxSplits: the combine's lanes)
MIN_TILES = 2  # tiles a split's run takes at least
RUN_ROWS = 4  # query rows a block may have per tile of a split's run
SMS = 132  # the H100's streaming multiprocessors
TARGET_BLOCKS = 4 * SMS  # blocks a launch aims for
SP_STRIDE = TILE + 8  # floats a row of a partial score plane
_TYPES = {torch.bfloat16: 0, torch.float32: 1}  # q_type of the launch


def plan(B: int, Tq: int, P: int, bs: int, dtype=torch.bfloat16) -> dict:
    """The launch plan, as the source reads it: ``mt`` query tokens a
    block (bf16: one for a decode round, ``MAX_MT`` for a chunk, on
    ``QUARTERS`` warps each; fp32: one token on four warps) in
    ``mgroups`` groups; ``splits`` runs of each row's keys, enough for
    ``TARGET_BLOCKS`` blocks, at most ``MAX_SPLITS`` and no more than a
    row of ``P * bs`` keys fills at ``min_run`` tiles each (at least
    ``MIN_TILES``, and a tile for every ``RUN_ROWS`` query rows of a block:
    a split's fp32 partial output then costs at most about ``RUN_ROWS /
    4`` of the latent bytes its run reads); ``grid`` (mgroups, splits, B);
    the dynamic shared memory (bf16: the ring of rows padded by 16 bytes
    and the partial score planes; fp32: q and one fp32 tile); the fp32
    scratch shapes of the partial outputs and statistics (None with one
    split)."""
    if dtype == torch.float32:
        mt, warps = 1, 4
        smem = 4 * (HEADS * LATENT + TILE * (LATENT + 1))
    else:
        mt = 1 if Tq == 1 else MAX_MT
        warps = QUARTERS * mt
        smem = (2 * STAGES * TILE * (LATENT + 8)
                + 4 * mt * QUARTERS * 16 * SP_STRIDE)
    mgroups = -(-Tq // mt)
    min_run = max(MIN_TILES, mt * HEADS // RUN_ROWS)
    fill = -(-P * bs // (TILE * min_run))
    splits = max(1, min(MAX_SPLITS, -(-TARGET_BLOCKS // (B * mgroups)),
                        fill))
    scratch = splits > 1
    return {
        "mt": mt,
        "mgroups": mgroups,
        "min_run": min_run,
        "warps": warps,
        "splits": splits,
        "grid": (mgroups, splits, B),
        "smem_bytes": smem,
        "partials": (splits, B, Tq, HEADS, VALUES) if scratch else None,
        "stats": (splits, B, Tq, HEADS, 2) if scratch else None,
    }


def _check(q, pool, page_table, dv):
    if q.dtype not in _TYPES or not q.is_cuda:
        raise TypeError("paged_mla: q must be bf16 or fp32 on the card, got "
                        f"{q.dtype} on {q.device}")
    if pool.dtype == torch.int8:
        raise TypeError("paged_mla: an int8 latent pool is not supported")
    if pool.dtype != q.dtype:
        raise TypeError(f"paged_mla: a pool of {pool.dtype} for {q.dtype} "
                        "queries")
    if q.dim() != 4 or tuple(q.shape[2:]) != (HEADS, LATENT) \
            or dv != VALUES:
        raise ValueError(f"paged_mla: built for q [B, Tq, {HEADS}, {LATENT}]"
                         f" and {VALUES} values, got {tuple(q.shape)}, {dv}")
    if pool.dim() != 3 or pool.shape[2] != LATENT:
        raise ValueError(f"paged_mla: pool {tuple(pool.shape)} is not "
                         f"[n_blocks, bs, {LATENT}]")
    if page_table.dim() != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(f"paged_mla: page table {tuple(page_table.shape)} "
                         f"for {q.shape[0]} rows")
    for name, t in (("q", q), ("pool", pool)):
        if t.device != q.device:
            raise ValueError(f"paged_mla: {name} must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_mla: {name} must be contiguous and "
                             "16-byte aligned")


def launch(q, pool, page_table, q_offset, scale: float, dv: int = VALUES):
    """Run the kernel on the current stream (and, with more than one
    split, its combine); returns the output [B, Tq, 16, 512] in q's type.
    ``page_table`` and ``q_offset`` are taken as int32 on q's device (a
    scalar offset is every row's)."""
    global launches
    _check(q, pool, page_table, dv)
    B, Tq = q.shape[:2]
    n_blocks, bs = pool.shape[:2]
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    offs = torch.as_tensor(q_offset, device=q.device).to(torch.int32)
    offs = offs.reshape(-1).expand(B).contiguous()
    P = table.shape[1]
    p = plan(B, Tq, P, bs, q.dtype)
    o = q.new_empty((B, Tq, HEADS, VALUES))
    part = stats = None
    if p["partials"] is not None:
        part = torch.empty(p["partials"], dtype=torch.float32,
                           device=q.device)
        stats = torch.empty(p["stats"], dtype=torch.float32, device=q.device)
    fn = build.library("paged_mla").paged_mla_launch
    rc = fn(q.data_ptr(), pool.data_ptr(), table.data_ptr(), offs.data_ptr(),
            o.data_ptr(), None if part is None else part.data_ptr(),
            None if stats is None else stats.data_ptr(),
            B, Tq, n_blocks, bs, P, p["splits"], p["mt"], p["min_run"],
            _TYPES[q.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_mla", rc)
    launches += 1
    launches_by_call["decode" if Tq == 1 else "chunk"] += 1
    return o
