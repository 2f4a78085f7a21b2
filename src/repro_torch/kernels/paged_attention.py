"""Paged attention of the serving steps, read in place from the paged KV
pool: the CUDA kernel's wrapper (kernel source: ``csrc/paged_attention.cu``).
It replaces no TPU kernel: the JAX package leaves the paged read to XLA
(``repro.models.attention.paged_gather``, then ``decode_attention`` or
``chunked_attention``), whose port gathered the page table's whole width
for every row and repeated it to every q head in fp32. That gathered read
stays the kernel's plain version, in the models layer beside the dense
caches' reads whose loops it shares
(``repro_torch.models.attention.gathered_attention``).

``q`` [B, Tq, H, hd] in bf16 or fp32; pools ``k_pool``, ``v_pool``
[n_blocks, bs, KVH, hd] in q's type, or int8 codes with bf16 scales
``k_scale``, ``v_scale`` [n_blocks, bs, KVH, 1]; ``page_table`` [B, P]
physical block ids in logical order, padded with the null block 0;
``q_offset`` [B] the absolute position of each row's first query. Query
``t`` of row ``b`` attends causally to the keys at positions ``<=
q_offset[b] + t``. The decode round is ``Tq = 1`` at ``q_offset = pos``, the
chunk call ``Tq = bs`` at its chunks' offsets. bf16 queries run on the
tensor cores (an int8 tile dequantized in shared memory as it arrives),
fp32 queries on the CUDA cores.

The kernel's launch plan (``plan``) follows static shapes only, so a
captured CUDA graph stays valid for any lengths and tables: a block per
(row, kv head, split), the splits chosen so that the small buckets still
fill the card, each block walking only its share of its row's live keys."""

from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches in this process (a run resets it)
launches_by_call = {"decode": 0, "chunk": 0}  # the same, by call: Tq == 1
# is a decode round, anything else a chunk call

HEAD_DIMS = (64, 80, 128)  # the head sizes the kernel is built for
TILE = 32  # keys per tile (kTK)
STAGES = 3  # tiles in the shared-memory ring (kStages)
MAX_WARPS = 8  # 16-row m-tiles a block (kMaxWarps)
SIMT_ROWS = 16  # fp32: query rows a block (kSimtRows), four warps
SIMT_WARPS = 4
MAX_SPLITS = 32  # splits of a row (kMaxSplits: the combine's lanes)
MIN_TILES = 2  # tiles a split's run takes at least; also at least
# grp * Tq / RUN_ROWS per row group (``min_run``)
RUN_ROWS = 4  # query rows a row group may have per tile of a split's run
SMS = 132  # the H100's streaming multiprocessors
TARGET_BLOCKS = 4 * SMS  # blocks a launch aims for: four a multiprocessor
_TYPES = {torch.bfloat16: 0, torch.float32: 1}  # q_type of the launch


def plan(B: int, Tq: int, H: int, KVH: int, hd: int, P: int, bs: int,
         dtype=torch.bfloat16, int8: bool = False) -> dict:
    """The kernel's launch plan for queries of ``dtype`` (over an int8
    pool with ``int8``), as the source reads it: ``mgroups`` row groups
    (bf16: of at most ``MAX_WARPS`` m-tiles of 16 query rows, a warp per
    m-tile, a kv head's ``grp * Tq`` rows making ``ceil(grp * Tq / 16)``;
    fp32: of ``SIMT_ROWS`` rows on ``SIMT_WARPS`` warps); ``splits`` runs
    of each row's keys, enough for ``TARGET_BLOCKS`` blocks, at most
    ``MAX_SPLITS`` and no more than a row of ``P * bs`` keys fills at
    ``min_run`` tiles each (at least ``MIN_TILES``, and a tile for every
    ``RUN_ROWS`` query rows of a row group: a split's partial output,
    written and read once more in fp32, then costs at most about
    ``RUN_ROWS / 4`` of the k/v bytes its run reads); ``grid`` (splits,
    KVH * mgroups, B); the dynamic shared memory (bf16: the K/V ring of
    rows padded by 16 bytes, or for an int8 pool one bf16 K/V tile and
    the ring of int8 rows; fp32: none, its tiles are static); the fp32
    scratch shapes of the partial outputs and statistics (None with one
    split)."""
    grp = H // KVH
    mtiles = -(-grp * Tq // 16)
    if dtype == torch.float32:
        mgroups, warps, smem = -(-grp * Tq // SIMT_ROWS), SIMT_WARPS, 0
    else:
        mgroups = -(-mtiles // MAX_WARPS)
        warps = -(-mtiles // mgroups)
        tile = 2 * TILE * (hd + 8) * 2
        smem = tile + 2 * STAGES * TILE * (hd + 16) if int8 else STAGES * tile
    base = B * KVH * mgroups
    min_run = max(MIN_TILES, grp * Tq // (RUN_ROWS * mgroups))
    fill = -(-P * bs // (TILE * min_run))
    splits = max(1, min(MAX_SPLITS, -(-TARGET_BLOCKS // base), fill))
    scratch = splits > 1
    return {
        "mgroups": mgroups,
        "min_run": min_run,
        "warps": warps,
        "splits": splits,
        "grid": (splits, KVH * mgroups, B),
        "smem_bytes": smem,
        "partials": (splits, B, Tq, H, hd) if scratch else None,
        "stats": (splits, B, Tq, H, 2) if scratch else None,
    }


def _check(q, k_pool, v_pool, page_table, k_scale, v_scale):
    B, Tq, H, hd = q.shape
    if q.dtype not in _TYPES or not q.is_cuda:
        raise TypeError("paged_attention: q must be bf16 or fp32 on the "
                        f"card, got {q.dtype} on {q.device}")
    int8 = k_pool.dtype == torch.int8
    if k_pool.dtype not in (q.dtype, torch.int8) \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: pools of {k_pool.dtype} / "
                        f"{v_pool.dtype} for {q.dtype} queries (q's type or "
                        "int8)")
    if int8 != (k_scale is not None) or int8 != (v_scale is not None):
        raise ValueError("paged_attention: an int8 pool, and only an int8 "
                         "pool, comes with its k and v scales")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != hd:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    kvh = k_pool.shape[2]
    if hd not in HEAD_DIMS or H % kvh:
        raise ValueError(f"paged_attention: needs hd in {HEAD_DIMS} and "
                         f"H % KVH == 0 (hd={hd}, H={H}, KVH={kvh})")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged_attention: page table "
                         f"{tuple(page_table.shape)} for {B} rows")
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)]
    if int8:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.bfloat16 \
                    or s.shape != k_pool.shape[:3] + (1,):
                raise ValueError(f"paged_attention: {name} must be bf16 "
                                 f"{tuple(k_pool.shape[:3]) + (1,)}")
            tensors.append((name, s))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} must be on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             "and 16-byte aligned")


def launch(q, k_pool, v_pool, page_table, q_offset, k_scale=None,
           v_scale=None):
    """Run the kernel on the current stream (and, with more than one
    split, its combine step); returns the output [B, Tq, H, hd] in q's
    type. ``page_table`` and ``q_offset`` are taken as int32 on q's device
    (a scalar offset is every row's); ``k_scale`` and ``v_scale`` go with
    an int8 pool."""
    global launches
    _check(q, k_pool, v_pool, page_table, k_scale, v_scale)
    B, Tq, H, hd = q.shape
    n_blocks, bs, kvh = k_pool.shape[:3]
    int8 = k_pool.dtype == torch.int8
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    offs = torch.as_tensor(q_offset, device=q.device).to(torch.int32)
    offs = offs.reshape(-1).expand(B).contiguous()
    P = table.shape[1]
    p = plan(B, Tq, H, kvh, hd, P, bs, q.dtype, int8)
    o = torch.empty_like(q)
    part = stats = None
    if p["partials"] is not None:
        part = torch.empty(p["partials"], dtype=torch.float32,
                           device=q.device)
        stats = torch.empty(p["stats"], dtype=torch.float32, device=q.device)
    fn = build.library("paged_attention").paged_attention_launch
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None,
            table.data_ptr(), offs.data_ptr(), o.data_ptr(),
            None if part is None else part.data_ptr(),
            None if stats is None else stats.data_ptr(),
            B, Tq, H, kvh, hd, n_blocks, bs, P, p["splits"], p["mgroups"],
            p["min_run"], _TYPES[q.dtype], int(int8), float(hd**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", rc)
    launches += 1
    launches_by_call["decode" if Tq == 1 else "chunk"] += 1
    return o
