"""The CUDA kernels against their plain versions, on the card (marked
``cuda``; every test skips without a CUDA device). This file imports no
JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances are relative to the largest reference value: fp32 1e-4 (the
kernels sum over the reduction axes in another order than the library
products of the plain versions), bf16 3e-2 (one bf16 rounding of the gated
intermediate, resp. of the softmax weights, lands differently). The
selective scan computes in fp32 from the same inputs as its plain version,
so in bf16 only the final rounding of each output differs (one bf16 ulp,
under 1e-2 of the largest value); its fp32 tolerance is 1e-4 for the same
reason as the others (sums over N, T and d in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.kernels import ssm_scan as tssm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GMM_SHAPES = [(1, 128, 64, 256), (2, 128, 128, 512), (4, 256, 64, 256),
              (3, 128, 96, 384), (8, 512, 256, 704)]
FLASH_CASES = [
    (2, 128, 4, 2, 64, True, 0),
    (1, 256, 4, 4, 64, True, 64),
    (2, 128, 2, 1, 128, True, 0),
    (1, 128, 4, 2, 32, False, 0),
    (1, 512, 2, 2, 64, True, 128),
    (2, 200, 32, 8, 128, True, 0),
    (1, 77, 4, 1, 32, True, 20),
]
# (B, T, d, N): ragged T (not a multiple of the 16-step checkpoint tile or
# of the 4-step backward piece: T = 1, one step either side of each), ragged
# d (not a multiple of the 32-channel forward or 64-channel backward block)
# and N of 1, 5 and 12 (padded to the kernels' 16 states) included
SSM_CASES = [(1, 64, 64, 16), (2, 200, 96, 16), (1, 1, 5, 4), (1, 333, 200, 8),
             (3, 65, 256, 16), (2, 130, 8192, 16), (1, 15, 100, 1),
             (2, 17, 33, 5), (1, 3, 70, 12), (1, 5, 64, 16), (2, 1, 130, 12)]
SSM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _gmm_inputs(S, C, D, F, fill):
    x = _np(S * 1000 + C, (S, C, D), 0.5)
    rows = np.arange(C)[None, :] < np.asarray(fill)[:, None]
    x = x * rows[..., None]          # the dispatcher leaves zeros past fill
    w1 = _np(1, (S, D, F), D ** -0.5)
    w3 = _np(2, (S, D, F), D ** -0.5)
    w2 = _np(3, (S, F, D), F ** -0.5)
    return x, w1, w3, w2, rows




@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,D,F", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_kernel_matches_plain(cuda, S, C, D, F, dtype):
    td = DTYPES[dtype]
    fill = [C, 0, 3, C // 2, 1, 2, 5, C - 1][:S]
    x, w1, w3, w2, rows = _gmm_inputs(S, C, D, F, fill)
    args = [torch.from_numpy(a).to(cuda, td) for a in (x, w1, w3, w2)]
    fl = torch.tensor(fill, dtype=torch.int32, device=cuda)
    before = tgmm.launches
    y = tgmm.launch(*args, fl, C)
    torch.cuda.synchronize()
    assert tgmm.launches == before + 1
    r = tgmm.plain(*args, fl, C)
    tol = (1e-4 if dtype == "float32" else 3e-2) * float(r.abs().max())
    assert float((y.float() - r.float()).abs().max()) <= tol
    assert not y[~torch.from_numpy(rows).to(cuda)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,kvh,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, B, T, H, kvh, hd, causal, window,
                                    dtype):
    td = DTYPES[dtype]
    q, k, v = (torch.from_numpy(_np(s, sh)).to(cuda, td) for s, sh in
               ((1, (B, T, H, hd)), (2, (B, T, kvh, hd)), (3, (B, T, kvh, hd))))
    o = tflash.launch(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    r = tflash.plain(q, k, v, causal=causal, window=window)
    tol = (1e-4 if dtype == "float32" else 3e-2) * float(r.abs().max())
    assert float((o.float() - r.float()).abs().max()) <= tol


# the tensor-core moe_gmm at the edges of its tiles: (S, C, D, F, fill,
# max_fill). Fills of 0, 1, 8, 9, 64, 65, 128 and 129 rows against row tiles
# of 8..128 rows (129 loops over two tiles); max_fill below a fill; D and F
# multiples of 8 but not of the 64 / 128-column tiles; split-K in one pass,
# in both and in neither. Past max_fill 128 the row-tile design: fills of
# 0, 1, 127, 128, 129, 255, 256 and 1000 rows against its 128-row tiles, a
# fill above max_fill, C not a multiple of 128, D and F multiples of 8 but
# not of its 64-deep stages or 128 / 256-column tiles, and more column tiles
# than one band of 8 (F 2048: 16 in pass 1).
GMM_TC_CASES = [
    (8, 160, 96, 704, [0, 1, 8, 9, 64, 65, 128, 129], 160),
    (8, 160, 96, 704, [0, 1, 8, 9, 64, 65, 128, 129], 64),
    (8, 160, 96, 704, [0, 1, 8, 9, 64, 65, 128, 129], 9),
    (4, 16, 256, 512, [1, 2, 0, 3], 4),
    (3, 40, 128, 384, [40, 17, 9], 40),
    (2, 300, 64, 200, [300, 150], 300),
    (8, 8, 4352, 256, [1, 3, 0, 8, 2, 5, 7, 4], 8),
    (8, 8, 128, 2112, [1, 3, 0, 8, 2, 5, 7, 4], 8),
    (2, 64, 4096, 1024, [64, 33], 64),
    (8, 1000, 136, 200, [0, 1, 127, 128, 129, 255, 256, 1000], 1000),
    (8, 1000, 136, 200, [0, 1, 127, 128, 129, 255, 256, 1000], 300),
    (3, 520, 264, 392, [517, 129, 0], 512),
    (2, 700, 1024, 2048, [700, 333], 700),
    (1, 130, 4096, 1024, [130], 130),
]


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,D,F,fill,max_fill", GMM_TC_CASES)
@pytest.mark.parametrize("forced", [False, True])
def test_moe_gmm_tensor_core_kernel_matches_plain(cuda, monkeypatch, S, C, D,
                                                  F, fill, max_fill, forced):
    """bf16 on the tensor cores against ``plain``, on the design
    ``select_design`` picks and forced onto the other one: rows past the
    fill hold NaN (the dispatcher leaves them unwritten) and never reach
    the output, every fresh allocation is NaN-filled (an element the
    kernel does not write shows), a second run gives the same bits, and
    the counters show the design's launches."""
    assert tgmm.select_variant(torch.bfloat16, D, F) == "tc"
    design = tgmm.select_design("tc", min(max_fill, C))
    assert design == ("rows" if min(max_fill, C) > 128 else "stream")
    if forced:
        design = {"rows": "stream", "stream": "rows"}[design]
        monkeypatch.setattr(tgmm, "select_design", lambda *a: design)
    x, w1, w3, w2, rows = _gmm_inputs(S, C, D, F, fill)
    x[~rows] = np.nan
    args = [torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in (x, w1, w3, w2)]
    fl = torch.tensor(fill, dtype=torch.int32, device=cuda)
    want = tgmm.plain(*args, fl, max_fill)
    _poison(monkeypatch)
    before = (tgmm.launches_by_variant["tc"], tgmm.launches_by_design[design])
    y = tgmm.launch(*args, fl, max_fill)
    y2 = tgmm.launch(*args, fl, max_fill)
    torch.cuda.synchronize()
    assert (tgmm.launches_by_variant["tc"],
            tgmm.launches_by_design[design]) == (before[0] + 2, before[1] + 2)
    assert torch.equal(y, y2)
    assert bool(torch.isfinite(y).all())
    assert _rel_err(y, want) <= 3e-2
    n = torch.clamp(fl.long(), max=min(max_fill, C))
    past = torch.arange(C, device=cuda)[None, :] >= n[:, None]
    assert not y[past].any()


# the tensor-core flash kernel: hd 32 / 64 / 80 / 128, ragged T, window on
# and off, KVH 1 and H, causal and not
FLASH_TC_CASES = [
    (B, T, 4, kvh, hd, causal, window)
    for hd in (32, 64, 80, 128)
    for T in (77, 200)
    for kvh in (1, 4)
    for causal, window in ((True, 0), (True, 48), (False, 0))
    if not (kvh == 4 and not causal and T == 77)
    for B in (2,)
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,kvh,hd,causal,window", FLASH_TC_CASES)
def test_flash_tensor_core_kernel_matches_plain(cuda, monkeypatch, B, T, H,
                                                kvh, hd, causal, window):
    assert tflash.select_variant(torch.bfloat16, hd) == "tc"
    q, k, v = (torch.from_numpy(_np(s, sh)).to(cuda, torch.bfloat16)
               for s, sh in ((1, (B, T, H, hd)), (2, (B, T, kvh, hd)),
                             (3, (B, T, kvh, hd))))
    want = tflash.plain(q, k, v, causal=causal, window=window)
    _poison(monkeypatch)
    before = tflash.launches_by_variant["tc"]
    o = tflash.launch(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tflash.launches_by_variant["tc"] == before + 1
    assert bool(torch.isfinite(o).all())
    assert _rel_err(o, want) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [24, 40])
def test_bf16_flash_with_other_head_sizes_runs_on_the_cuda_cores(cuda, hd):
    q, k, v = (torch.from_numpy(_np(s, (1, 50, 2, hd))).to(cuda, torch.bfloat16)
               for s in (1, 2, 3))
    before = dict(tflash.launches_by_variant)
    o = tflash.launch(q, k, v, window=16)
    torch.cuda.synchronize()
    assert tflash.launches_by_variant == {"tc": before["tc"],
                                          "simt": before["simt"] + 1}
    want = tflash.plain(q, k, v, window=16)
    assert _rel_err(o, want) <= 3e-2


# The paged attention read: (label, B, Tq, H, KVH, hd, P, bs). The three
# cells' shapes (48 padded q heads over 8 kv heads of 128, blocks of 16):
# a chat decode round at the widest bucket over 320 pages, a chat chunk
# call of 4 rows, the docs chunk call of 16 rows over 528 pages; then the
# other head sizes and groups the port serves (grp 1 at hd 80, grp 8 at hd
# 64 with blocks of 8, grp 12: two row groups of 6 m-tiles in a chunk)
PAGED_CASES = [
    ("chat-decode", 32, 1, 48, 8, 128, 320, 16),
    ("chat-chunk", 4, 16, 48, 8, 128, 320, 16),
    ("docs-chunk", 16, 16, 48, 8, 128, 528, 16),
    ("grp1-hd80-decode", 8, 1, 8, 8, 80, 40, 16),
    ("grp1-hd80-chunk", 3, 16, 8, 8, 80, 40, 16),
    ("grp8-hd64-decode", 8, 1, 32, 4, 64, 24, 8),
    ("grp8-hd64-chunk", 4, 8, 32, 4, 64, 24, 8),
    ("grp12-chunk", 3, 16, 24, 2, 128, 40, 16),
]
# Pool layouts by (query type, pool): bf16 queries over a bf16 pool or an
# int8 one (codes and bf16 scales, dequantized to bf16 as they arrive),
# fp32 queries over an fp32 pool or an int8 one
PAGED_POOLS = {"bfloat16": (torch.bfloat16, False),
               "int8": (torch.bfloat16, True),
               "float32": (torch.float32, False),
               "int8-fp32": (torch.float32, True)}
# Each query's largest error against its own largest output. bf16: the
# kernel and its plain version compute in fp32 from the same bf16 inputs;
# they round P to bf16 at different points (the plain decode after
# normalising, the kernel before; a split's partial sums are merged in
# fp32) and sum in other orders, and both round the output to bf16: a few
# bf16 ulps of a query's outputs, well under 1e-2 of its largest. fp32:
# only the summation orders differ, as the CUDA-core flash kernel's 1e-4
PAGED_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _paged_inputs(dev, B, Tq, H, KVH, hd, P, bs, ends, seed=0,
                  pool="bfloat16"):
    """(q, cache, table, offsets): row b's last query sees ``ends[b]``
    keys (offset ``ends[b] - Tq``), over shuffled physical blocks, the
    table padded with the null block 0; rows past ``len(ends)`` are vacant
    (an all-null table at offset 0). ``pool`` names the layout
    (``PAGED_POOLS``); an int8 cache holds ``quantize_kv``'s codes and
    scales."""
    from repro_torch.models import attention as TA

    dtype, int8 = PAGED_POOLS[pool]
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * P
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((B, P), np.int32)
    offs = np.zeros((B,), np.int32)
    for b, end in enumerate(ends):
        n = -(-end // bs)
        table[b, :n] = perm[b * P:b * P + n]
        offs[b] = end - Tq
    q, k, v = (torch.from_numpy(_np(seed + i, shape)).to(dev, dtype)
               for i, shape in ((1, (B, Tq, H, hd)),
                                (2, (n_blocks, bs, KVH, hd)),
                                (3, (n_blocks, bs, KVH, hd))))
    if int8:
        (k, ks), (v, vs) = TA.quantize_kv(k), TA.quantize_kv(v)
        cache = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        cache = {"k": k, "v": v}
    return (q, cache) + tuple(torch.from_numpy(a).to(dev)
                              for a in (table, offs))


def _paged_launch(q, cache, table, offs):
    return tpaged.launch(q, cache["k"], cache["v"], table, offs,
                         cache.get("k_scale"), cache.get("v_scale"))


def _paged_check(o, args, n_live):
    """The kernel's output ``o`` against the plain version on ``args``:
    each query of the first ``n_live`` rows within PAGED_TOL of its own
    largest output (a short query is held to its own scale, not a long
    row's); each vacant row on its own scale too, and its first query,
    which sees one null-block key, equal to that key's value exactly."""
    from repro_torch.models import attention as TA

    want = TA.gathered_attention(*args)
    assert o.dtype == want.dtype
    B, Tq = want.shape[:2]
    diff = (o.float() - want.float()).abs().reshape(B, Tq, -1).amax(-1)
    scale = want.float().abs().reshape(B, Tq, -1).amax(-1)
    tol = PAGED_TOL[o.dtype]
    bad = (diff > tol * scale).nonzero().tolist()
    assert not bad, [(b, t, float(diff[b, t]), float(scale[b, t]))
                     for b, t in bad[:8]]
    assert torch.equal(o[n_live:, 0], want[n_live:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(PAGED_POOLS))
@pytest.mark.parametrize("label,B,Tq,H,KVH,hd,P,bs", PAGED_CASES)
def test_paged_attention_kernel_matches_plain(cuda, label, B, Tq, H, KVH, hd,
                                              P, bs, pool):
    """Ragged lengths drawn over the table's width (one row at its full
    width, one vacant), each ending anywhere in a page; every row checked,
    the vacant one and the padded q heads included, in every pool
    layout."""
    rng = np.random.default_rng(B * P + Tq)
    ends = list(rng.integers(Tq, P * bs + 1, B - 2)) + [P * bs]
    if Tq > 1:   # chunks start block-aligned, as the runtime issues them
        ends = [max(Tq, e // bs * bs) for e in ends]
    before = dict(tpaged.launches_by_call)
    args = _paged_inputs(cuda, B, Tq, H, KVH, hd, P, bs, ends, pool=pool)
    o = _paged_launch(*args)
    torch.cuda.synchronize()
    _paged_check(o, args, len(ends))
    call = "decode" if Tq == 1 else "chunk"
    assert tpaged.launches_by_call[call] == before[call] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(PAGED_POOLS))
@pytest.mark.parametrize("Tq", [1, 16])
def test_paged_attention_at_split_and_tile_edges(cuda, Tq, pool):
    """Lengths of 1 (decode), bs, P * bs, each side of a 32-key tile, of
    the smallest split run and of where the runs grow past it (min_run x
    splits tiles), one row each; a chunk's queries start anywhere (its
    causal edge inside the chunk and across a tile)."""
    dtype, int8 = PAGED_POOLS[pool]
    # an fp32 block takes 16 query rows: a chunk of 16 over 2 q heads a kv
    # head, so that 14 rows still split
    H = 16 if dtype == torch.float32 and Tq > 1 else 48
    B, KVH, hd, P, bs = 14, 8, 128, 64 if Tq == 1 else 256, 16
    plan = tpaged.plan(B, Tq, H, KVH, hd, P, bs, dtype, int8)
    s = plan["splits"]
    assert s > 1
    edge = plan["min_run"] * tpaged.TILE * s
    assert edge < P * bs
    ends = [1, bs, bs + 1, 31, 32, 33, 64, 65, edge - 1, edge, edge + 1,
            P * bs - 1, P * bs, 47]
    ends = [max(e, Tq) for e in ends]
    args = _paged_inputs(cuda, B, Tq, H, KVH, hd, P, bs, ends, seed=4,
                         pool=pool)
    o = _paged_launch(*args)
    torch.cuda.synchronize()
    _paged_check(o, args, B)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(PAGED_POOLS))
@pytest.mark.parametrize("Tq", [1, 16])
def test_paged_attention_replays_in_a_graph_with_new_lengths(cuda, Tq, pool):
    """Captured once in a CUDA graph, the kernel replays over new lengths,
    page tables, queries and pool contents written into the captured
    tensors, and matches the plain version on each: its grid is fixed by
    shapes, everything else it reads on the device. The last row stays
    vacant."""
    B, H, KVH, hd, P, bs = 6, 48, 8, 128, 96, 16
    rng = np.random.default_rng(Tq)
    static = _paged_inputs(cuda, B, Tq, H, KVH, hd, P, bs, [Tq] * (B - 1),
                           pool=pool)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _paged_launch(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _paged_launch(*static)
    flat = lambda args: [args[0], *args[1].values(), *args[2:]]  # noqa: E731
    for k in range(3):
        ends = [int(e) for e in rng.integers(Tq, P * bs + 1, B - 1)]
        fresh = _paged_inputs(cuda, B, Tq, H, KVH, hd, P, bs, ends,
                              seed=10 + k, pool=pool)
        for dst, src in zip(flat(static), flat(fresh)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _paged_check(out, static, B - 1)


def _ssm_inputs(B, T, d, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, T, d)) - 2))
    Bs = rng.standard_normal((B, T, N)) * 0.3
    Cs = rng.standard_normal((B, T, N)) * 0.3
    A = -np.exp(rng.standard_normal((d, N)) * 0.5)
    D = 1 + 0.1 * rng.standard_normal(d)
    dy = rng.standard_normal((B, T, d))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, dt, Bs, Cs, A, D, dy)]


def _poison(monkeypatch):
    """Fill every fresh allocation with NaN, so that an output element the
    kernel does not write shows."""
    def poisoned(alloc):
        def fn(*args, **kw):
            t = alloc(*args, **kw)
            return t.fill_(float("nan")) if t.is_floating_point() else t
        return fn

    monkeypatch.setattr(torch, "empty", poisoned(torch.empty))
    monkeypatch.setattr(torch, "empty_like", poisoned(torch.empty_like))


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,d,N", SSM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernels_match_plain(cuda, monkeypatch, B, T, d, N, dtype):
    td = DTYPES[dtype]
    x, dt, Bs, Cs, A, D, dy = (a.to(cuda) for a in _ssm_inputs(B, T, d, N))
    x, dt, Bs, Cs, dy = (a.to(td) for a in (x, dt, Bs, Cs, dy))
    want_y = tssm.plain(x, dt, Bs, Cs, A, D)
    want_g = tssm.plain_bwd(x, dt, Bs, Cs, A, D, dy)
    _poison(monkeypatch)
    before = tssm.launches, tssm.bwd_launches
    y, states = tssm.launch(x, dt, Bs, Cs, A, D, save_states=True)
    grads = tssm.launch_bwd(x, dt, Bs, Cs, A, D, dy, states)
    torch.cuda.synchronize()
    assert (tssm.launches, tssm.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert y.dtype == td and states.shape == (B, -(-T // tssm.CHUNK), d, N)
    assert _rel_err(y, want_y) <= SSM_TOL[dtype]
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dD"), grads, want_g):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel_err(g, w) <= SSM_TOL[dtype], name
    # the states are not kept unless asked for, and do not change y
    y2, none = tssm.launch(x, dt, Bs, Cs, A, D)
    assert none is None and torch.equal(y2, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_backward_gives_the_same_bits_twice(cuda, dtype):
    """The channel sums of dB and dC (and the batch sums of dA and dD) run
    in a fixed order with no float atomics: two backward runs over the
    same inputs give identical bits."""
    td = DTYPES[dtype]
    x, dt, Bs, Cs, A, D, dy = (a.to(cuda) for a in _ssm_inputs(2, 130, 8192,
                                                                 16, seed=5))
    x, dt, Bs, Cs, dy = (a.to(td) for a in (x, dt, Bs, Cs, dy))
    _, states = tssm.launch(x, dt, Bs, Cs, A, D, save_states=True)
    first = tssm.launch_bwd(x, dt, Bs, Cs, A, D, dy, states)
    second = tssm.launch_bwd(x, dt, Bs, Cs, A, D, dy, states)
    for name, g, g2 in zip(("dx", "ddt", "dB", "dC", "dA", "dD"), first,
                           second):
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_ssm_scan_autograd_function_matches_autograd_through_plain(cuda):
    """``SsmScan`` (forward and backward kernels) against autograd through
    the plain version, for all six inputs in fp32, on non-contiguous inputs
    as the Mamba-1 block passes them (B and C are views of one
    projection); runs of the backward give the same bits."""
    x, dt, Bs, Cs, A, D, dy = (a.to(cuda) for a in _ssm_inputs(2, 150, 160, 16))
    proj = torch.cat([Bs, Cs], -1)
    leaves = [x, dt, proj, A, D]
    for t in leaves:
        t.requires_grad_(True)

    def run(fn):
        Bv, Cv = proj[..., :16], proj[..., 16:]
        y = fn(x, dt, Bv, Cv, A, D)
        return torch.autograd.grad(y, leaves, dy)

    before = tssm.launches, tssm.bwd_launches
    got = run(tssm.SsmScan.apply)
    again = run(tssm.SsmScan.apply)
    assert (tssm.launches, tssm.bwd_launches) == (before[0] + 2, before[1] + 2)
    want = run(tssm.plain)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert _rel_err(g, w) <= 1e-4
    with torch.no_grad():
        tssm.SsmScan.apply(x, dt, proj[..., :16], proj[..., 16:], A, D)


@pytest.mark.cuda
def test_falcon_mamba_train_step_on_the_card_matches_the_cpu(cuda):
    """Reduced Falcon-Mamba in fp32, same weights: loss, every gradient
    leaf and the parameters after one AdamW step agree between the card
    (scan kernels) and the CPU (plain versions); the step launched the
    forward kernel twice per layer (once more under checkpointing) and
    the backward once."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.training.train_loop import loss_and_grads

    cfg = get_config("falcon-mamba-7b").reduced()
    rt, params, state, step = build_trainer(cfg, device="cpu",
                                            dtype=torch.float32, lr=1e-2,
                                            steps=4, seed=1)
    grt = dataclasses.replace(rt, device="cuda")
    gparams = tree_map(lambda a: a.to(cuda), params)
    gstate = {k: tree_map(lambda a: a.to(cuda), state[k]) for k in ("m", "v")}
    gstate["step"] = state["step"]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 100))
    tgt = np.roll(tok, -1, 1)
    loss, _, grads = loss_and_grads(rt, params, tok, tgt)
    before = tssm.launches, tssm.bwd_launches
    gloss, _, ggrads = loss_and_grads(grt, gparams, tok, tgt)
    assert tssm.launches - before[0] == 2 * cfg.num_layers
    assert tssm.bwd_launches - before[1] == cfg.num_layers
    assert float(gloss) == pytest.approx(float(loss), rel=1e-5)
    for g, w in zip(tree_leaves(ggrads), tree_leaves(grads)):
        assert _rel_err(g.cpu(), w) <= 1e-4
    step(params, state, tok, tgt)
    step(gparams, gstate, tok, tgt)
    for g, w in zip(tree_leaves(gparams), tree_leaves(params)):
        # AdamW's first step moves each weight by lr * g / (|g| + eps): only
        # a gradient near 0 whose sign differs can move it differently, by
        # at most twice the first step's learning rate (1e-3 in warmup)
        assert float((g.detach().cpu() - w.detach()).abs().max()) <= 2e-3


# flash backward: (B, T, H, KVH, hd, causal, window): the wgmma kernels (hd
# 64 / 128) and the mma.sync ones (hd 80, 32) on bf16's own choice, GQA
# groups of 2 and 4, windows with and without causal masking, ragged T (no
# multiple of the 32- or 64-row tiles or the 128-row blocks), non-causal
FLASH_BWD_CASES = [
    (2, 128, 4, 2, 64, True, 0),
    (1, 50, 4, 2, 24, True, 0),
    (1, 200, 4, 4, 80, True, 0),
    (2, 130, 8, 2, 128, True, 0),
    (1, 257, 4, 1, 64, True, 48),
    (1, 77, 2, 1, 32, False, 0),
    (1, 96, 4, 2, 80, False, 20),
    (1, 300, 8, 2, 128, True, 100),
    (1, 160, 8, 2, 64, False, 0),
    (1, 190, 4, 1, 128, False, 40),
    (1, 200, 4, 1, 80, True, 30),
]
# moe_gmm backward: (S, C, D, F, fill, max_fill): ragged fills, an empty
# slot, max_fill below C and below a fill; (D, F) multiples of 64, (96, 200)
# and (64, 136) (ragged column tiles) on the wgmma kernels, (20, 36) on the
# CUDA cores; fills of several 128-row tiles
GMM_BWD_CASES = [
    (4, 64, 128, 256, [64, 0, 17, 40], 48),
    (2, 16, 20, 36, [16, 5], 12),
    (3, 40, 96, 200, [1, 40, 0], 40),
    (8, 256, 256, 704, [256, 3, 0, 100, 255, 7, 64, 128], 192),
    (3, 520, 64, 136, [517, 129, 0], 512),
    (2, 200, 1024, 512, [200, 77], 200),
]
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# (dtype, variant): bf16 on its own choice (the tensor cores where the
# widths allow) and forced onto the CUDA cores
BWD_VARIANTS = [("float32", "auto"), ("bfloat16", "auto"),
                ("bfloat16", "simt")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,kvh,hd,causal,window", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype,variant", BWD_VARIANTS)
def test_flash_backward_kernels_match_plain(cuda, monkeypatch, B, T, H, kvh,
                                            hd, causal, window, dtype,
                                            variant):
    """The forward's statistics equal the scores' log-sum-exp; dq, dk, dv
    match ``plain_bwd``; a second run gives the same bits."""
    td = DTYPES[dtype]
    if variant == "simt":
        monkeypatch.setattr(tflash, "select_variant", lambda *a, **k: "simt")
    q, do = (torch.from_numpy(_np(s, (B, T, H, hd))).to(cuda, td)
             for s in (1, 2))
    k, v = (torch.from_numpy(_np(s, (B, T, kvh, hd))).to(cuda, td)
            for s in (3, 4))
    lse = torch.empty(tflash.stats_shape(B, T, H), device=cuda)
    o = tflash.launch(q, k, v, causal=causal, window=window, lse=lse)
    assert torch.equal(o, tflash.launch(q, k, v, causal=causal,
                                        window=window))
    before = tflash.bwd_launches
    got = tflash.launch_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    again = tflash.launch_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert tflash.bwd_launches == before + 2
    kx = k.float().repeat_interleave(H // kvh, 2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * hd ** -0.5
    qp = torch.arange(T, device=cuda)[:, None]
    kp = torch.arange(T, device=cuda)[None]
    mask = torch.ones((T, T), dtype=torch.bool, device=cuda)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    want_lse = torch.logsumexp(sc.masked_fill(~mask, -1e30), -1)
    assert float((lse - want_lse).abs().max()) <= 1e-4 * float(
        want_lse.abs().max())
    want = tflash.plain_bwd(q, k, v, do, causal=causal, window=window)
    for g, g2, w in zip(got, again, want):
        assert g.dtype == td and torch.equal(g, g2)
        assert _rel_err(g, w) <= REL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,D,F,fill,max_fill", GMM_BWD_CASES)
@pytest.mark.parametrize("dtype,variant", BWD_VARIANTS)
def test_moe_gmm_backward_kernel_matches_plain(cuda, monkeypatch, S, C, D, F,
                                               fill, max_fill, dtype,
                                               variant):
    """dx, dw1, dw3, dw2 match ``plain_bwd`` over the rows below the fill
    (rows of dx past it are 0, whatever x holds there); a second run gives
    the same bits."""
    td = DTYPES[dtype]
    if variant == "simt":
        monkeypatch.setattr(tgmm, "select_variant", lambda *a, **k: "simt")
    x, w1, w3, w2, _ = _gmm_inputs(S, C, D, F, fill)
    args = [torch.from_numpy(a).to(cuda, td) for a in (x, w1, w3, w2)]
    for s, n in enumerate(fill):        # past the fill: never read
        args[0][s, min(n, max_fill):] = float("nan")
    dy = torch.from_numpy(_np(7, (S, C, D))).to(cuda, td)
    fl = torch.tensor(fill, dtype=torch.int32, device=cuda)
    before = tgmm.bwd_launches
    got = tgmm.launch_bwd(*args, fl, max_fill, dy)
    again = tgmm.launch_bwd(*args, fl, max_fill, dy)
    torch.cuda.synchronize()
    assert tgmm.bwd_launches == before + 2
    want = tgmm.plain_bwd(*args, fl, max_fill, dy)
    for g, g2, w in zip(got, again, want):
        assert g.dtype == td and bool(torch.isfinite(g).all())
        assert torch.equal(g, g2)
        assert _rel_err(g, w) <= REL_TOL[dtype]
    for s, n in enumerate(fill):
        assert not got[0][s, min(n, max_fill):].any()


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernels_only_when_recorded(cuda):
    """Through ``ops``: a call autograd records runs the Functions (the
    flash forward writes its statistics; one backward launch each), a call
    under ``torch.no_grad`` runs the forward kernel alone, keeps nothing
    and launches no backward."""
    from repro_torch.kernels import ops

    q = torch.randn((1, 40, 4, 64), device=cuda, requires_grad=True)
    kv = torch.randn((1, 40, 2, 64), device=cuda, requires_grad=True)
    x = torch.randn((2, 8, 64), device=cuda, requires_grad=True)
    w = (torch.randn((2, 64, 64), device=cuda) / 8).requires_grad_(True)
    fill = torch.tensor([5, 8], dtype=torch.int32, device=cuda)
    counts = (tflash.launches, tflash.bwd_launches, tgmm.launches,
              tgmm.bwd_launches)
    with torch.no_grad():
        o = ops.flash_attention(q, kv, kv)
        y = ops.moe_gmm(x, w, w, w, fill, 8)
    assert o.grad_fn is None and y.grad_fn is None
    o = ops.flash_attention(q, kv, kv)
    y = ops.moe_gmm(x, w, w, w, fill, 8)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert type(y.grad_fn).__name__ == "MoeGmmBackward"
    (o.sum() + y.sum()).backward()
    torch.cuda.synchronize()
    assert (tflash.launches, tflash.bwd_launches, tgmm.launches,
            tgmm.bwd_launches) == tuple(c + d for c, d in zip(counts,
                                                              (2, 1, 2, 1)))
    for t in (q, kv, x, w):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


@pytest.mark.cuda
def test_autograd_forward_at_a_large_fill_runs_the_row_tiles(cuda):
    """``MoeGmm`` at an EP train fill (max_fill 1024, a slot past one
    row tile): the forward runs the row-tile design and matches ``plain``,
    the backward kernels run once and give finite gradients."""
    S, C, D, F, fill = 4, 1100, 256, 512, [1024, 700, 0, 129]
    x, w1, w3, w2, rows = _gmm_inputs(S, C, D, F, fill)
    args = [torch.from_numpy(a).to(cuda, torch.bfloat16).requires_grad_(True)
            for a in (x, w1, w3, w2)]
    fl = torch.tensor(fill, dtype=torch.int32, device=cuda)
    before = (tgmm.launches_by_design["rows"], tgmm.bwd_launches)
    y = tgmm.MoeGmm.apply(*args, fl, 1024)
    assert type(y.grad_fn).__name__ == "MoeGmmBackward"
    assert (tgmm.launches_by_design["rows"], tgmm.bwd_launches) == (
        before[0] + 1, before[1])
    with torch.no_grad():
        want = tgmm.plain(*args, fl, 1024)
    assert _rel_err(y, want) <= 3e-2
    assert not y[~torch.from_numpy(rows).to(cuda)].any()
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert tgmm.bwd_launches == before[1] + 1
    for t in args:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


def _train_pair(arch, n_ep, seed=1, lr=1e-2):
    """One reduced model on the CPU and its copy on the card, with AdamW
    states and train steps: the dense-MoE trainer of ``launch.train``, or
    (``n_ep``) the EP model of ``launch.serve.build_engine`` over ``n_ep``
    virtual ranks, uniform placement, capacities cut to a train batch's.
    Returns ((rt, params, state, step, placement) on the CPU, the same on
    the card)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import moe as tmoe
    from repro_torch.optim.adamw import adamw, cosine_schedule, tree_map
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(arch).reduced()
    if n_ep:
        eng, _ = build_engine(cfg, device="cpu", dtype=torch.float32,
                              max_len=8, policy="uniform", review_rounds=1000,
                              seed=seed, n_ep=n_ep)
        spec = dataclasses.replace(eng.rt.ep_spec, capacity=256,
                                   slot_capacity=512)
        rt = dataclasses.replace(eng.rt, ep_spec=spec)
        params, placement = eng.params, eng.placement
        opt = adamw(schedule=cosine_schedule(lr, 10, 4))
        state, step = opt.init(params), make_train_step(rt, opt)
    else:
        rt, params, state, step = build_trainer(
            cfg, device="cpu", dtype=torch.float32, lr=lr, steps=4, seed=seed)
        placement = None
    gparams = tree_map(lambda a: a.to("cuda"), params)
    gstate = {k: tree_map(lambda a: a.to("cuda"), state[k]) for k in ("m", "v")}
    gstate["step"] = state["step"]
    gplacement = (tmoe.EPPlacement(*(a.to("cuda") for a in placement))
                  if placement is not None else None)
    grt = dataclasses.replace(rt, device="cuda")
    return ((rt, params, state, step, placement),
            (grt, gparams, gstate, step, gplacement))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_ep,grad_tol", [
    ("mixtral-8x7b", 0, 1e-4),
    ("mixtral-8x7b", 3, 1e-4),
    # Zamba2's fp32 gradients are not reproducible to 1e-4 of a leaf's
    # largest value on any device (``tools/train_checks.py grads``: the
    # CPU's own fp32 run is up to 3.1e-4 from its float64 run, the card
    # 3.4e-4 from the CPU's fp32 at this seed and length)
    ("zamba2-2.7b", 0, 1e-3)])
def test_attention_and_moe_train_steps_on_the_card_match_the_cpu(
        cuda, arch, n_ep, grad_tol):
    """Reduced dense Mixtral, EP Mixtral over 3 virtual ranks and Zamba2
    (shared attention) in fp32, same weights: loss, every gradient leaf and
    the parameters after one AdamW step agree between the card (the flash
    and, for EP, moe_gmm kernels forward and backward) and the CPU (plain
    versions); each attention layer ran the
    flash forward twice (once more under checkpointing) and its backward
    once, each EP layer likewise moe_gmm."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.train_loop import loss_and_grads

    cpu, card = _train_pair(arch, n_ep)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cpu[0].cfg.vocab_size, (2, 100))
    tgt = np.roll(tok, -1, 1)
    loss, _, grads = loss_and_grads(cpu[0], cpu[1], tok, tgt,
                                    placement=cpu[4])
    before = (tflash.launches, tflash.bwd_launches, tgmm.launches,
              tgmm.bwd_launches)
    gloss, _, ggrads = loss_and_grads(card[0], card[1], tok, tgt,
                                      placement=card[4])
    torch.cuda.synchronize()
    fa_f, fa_b, gm_f, gm_b = (a - b for a, b in zip(
        (tflash.launches, tflash.bwd_launches, tgmm.launches,
         tgmm.bwd_launches), before))
    assert fa_b >= 1 and fa_f == 2 * fa_b
    assert (gm_f, gm_b) == ((2 * cpu[0].cfg.num_layers, cpu[0].cfg.num_layers)
                            if n_ep else (0, 0))
    assert float(gloss) == pytest.approx(float(loss), rel=1e-5)
    for g, w in zip(tree_leaves(ggrads), tree_leaves(grads)):
        assert _rel_err(g.cpu(), w) <= grad_tol
    cpu[3](cpu[1], cpu[2], tok, tgt, cpu[4])
    card[3](card[1], card[2], tok, tgt, card[4])
    for g, w in zip(tree_leaves(card[1]), tree_leaves(cpu[1])):
        # AdamW's first step moves each weight by lr * g / (|g| + eps): only
        # a gradient near 0 whose sign differs can move it differently, by
        # at most twice the first step's learning rate (1e-3 in warmup)
        assert float((g.detach().cpu() - w.detach()).abs().max()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,mode", [(4, 16, "chunk"), (32, 1, "decode")])
def test_ep_moe_at_the_chat_cells_widths_sizes_buffers_by_routed_rows(
        cuda, B, T, mode):
    """Two EP MoE layers at the Mixtral chat cell's widths (d 4096, d_ff
    14336, 8 experts top-2 over 3 ranks of 4 slots, C 8192, C2 16384,
    bf16) through a chat chunk call (4 rows x 16 tokens) or decode round
    (32 rows): each layer's routed output equals the CPU's plain path
    (fp32, over the same bf16 values) within the bf16 tolerance, with the
    same routing counts, and the device memory the call takes grows by no
    more than a bound computed from the rows in force (tens of MB; buffers
    sized by the capacities took over 2 GB a layer). Each token lies along
    its two experts' router columns, so the top-2 is decided by a wide
    margin on both devices."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe

    cfg = get_config("mixtral-8x7b")
    n, S = 3, 4
    D, F, E, K = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.top_k
    spec = tmoe.EPSpec(n, S, 8192, 16384)
    pl = tmoe.uniform_placement(n, S, E)
    g = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randn((D, E), generator=g, device=cuda)
    u = u / u.norm(dim=0)   # unit router directions
    # a token along two of them has logits near 0.5 there and near 0
    # elsewhere: small logits keep the bf16 rounding of the top-2 weights
    # (the card's router product) under the tolerance
    router = u * (0.5 / (D / 2) ** 0.5)

    def weight(shape, fan_in):
        return (torch.randn(shape, generator=g, device=cuda)
                * fan_in ** -0.5).to(torch.bfloat16)

    layers = [{"norm": torch.ones((D,), dtype=torch.bfloat16, device=cuda),
               "router": router.to(torch.bfloat16),
               "w1": weight((n, S, D, F), D), "w3": weight((n, S, D, F), D),
               "w2": weight((n, S, F, D), F)} for _ in range(2)]
    rng = np.random.default_rng(1)
    a = rng.integers(0, E, B * T)
    b = (a + 1 + rng.integers(0, E - 1, B * T)) % E
    x = ((u[:, a] + u[:, b]).T * (D / 8) ** 0.5
         + 0.05 * torch.randn((B * T, D), generator=g, device=cuda))
    x = x.reshape(B, T, D).to(torch.bfloat16)

    def call(p, h, placement):
        return tmoe.moe_apply_ep(p, cfg, h, spec=spec, placement=placement,
                                 mode=mode)

    on_card = tmoe.placement_to(pl, cuda)
    for p in layers:   # builds the kernels and the library's workspaces
        call(p, x, on_card)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ins, outs, stats = [x], [], []
    for p in layers:
        out, st = call(p, ins[-1], on_card)
        outs.append(out)
        stats.append(st)
        ins.append(out)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    send, slot = tmoe.ep_call_capacities(spec, K, B, T, mode)
    R = -(-B * T // n) if mode == "chunk" else B * T
    max_fill = min(slot, n * R if mode == "chunk" else R)
    # the in-force exchange and slot buffers, the rows, moe_gmm's [n S,
    # max_fill, F] intermediate, and 16 MiB for indices and statistics
    bound = (8 * (n * n * send + n * S * slot + B * T) * D * 2
             + n * S * max_fill * F * 2 + 16 * 2 ** 20)
    assert (send, slot) == ((44, 66) if mode == "chunk" else (0, 32))
    assert grown <= bound < 256 * 2 ** 20, (grown, bound)

    on_cpu = tmoe.placement_to(pl, "cpu")
    for p, h, out, st in zip(layers, ins, outs, stats):
        want, wst = call({k: v.float().cpu() for k, v in p.items()},
                         h.float().cpu(), on_cpu)
        routed = (out.float() - h.float()).cpu()
        assert _rel_err(routed, want - h.float().cpu()) <= 3e-2
        assert torch.equal(st["counts_per_rank"].cpu(),
                           wst["counts_per_rank"])
        assert float(st["local_frac"]) == float(wst["local_frac"])


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 4, 8), device=cuda)
    w = torch.zeros((2, 8, 8), device=cuda)
    fill = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tgmm.launch(x, w.transpose(1, 2), w, w, fill, 4)
    with pytest.raises(ValueError):
        tgmm.launch(x, w, w, w, fill.long(), 4)
    with pytest.raises(TypeError):
        tgmm.launch(x.half(), w.half(), w.half(), w.half(), fill, 4)
    q = torch.zeros((1, 4, 2, 256), device=cuda)
    with pytest.raises(ValueError):
        tflash.launch(q, q[:, :, :1], q[:, :, :1])
    # paged attention: fp32 queries over a bf16 pool, an int8 pool without
    # its scales, a head size it is not built for, a table for other rows
    q, cache, table, offs = _paged_inputs(cuda, 2, 1, 4, 2, 64, 3, 8, [5])
    kp, vp = cache["k"], cache["v"]
    with pytest.raises(TypeError):
        tpaged.launch(q.float(), kp, vp, table, offs)
    with pytest.raises(ValueError):
        tpaged.launch(q, kp.to(torch.int8), vp.to(torch.int8), table, offs)
    with pytest.raises(ValueError):
        tpaged.launch(q[..., :32], kp[..., :32], vp[..., :32], table, offs)
    with pytest.raises(ValueError):
        tpaged.launch(q, kp, vp, table[:1], offs)


@pytest.mark.cuda
def test_serving_on_the_card_matches_the_cpu_and_ignores_garbage(cuda,
                                                                  monkeypatch):
    """Reduced Mixtral, fp32, one EP rank: greedy tokens on the card (the
    kernels) equal the CPU's (plain versions) over the same weights, and
    stay the same when every fresh allocation is NaN-filled (no kernel or
    dispatch step reads memory it did not write)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.moe import EPPlacement
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("mixtral-8x7b").reduced()
    eng, _ = build_engine(cfg, device="cuda", dtype=torch.float32,
                          max_len=40, policy="dancemoe", review_rounds=8)

    def cpu(tree):
        return ({k: cpu(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.cpu())

    import dataclasses

    ceng = ServingEngine(rt=dataclasses.replace(eng.rt, device="cpu"),
                         params=cpu(eng.params),
                         placement=EPPlacement(*(a.cpu() for a in
                                                 eng.placement)),
                         max_len=40)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 19))
    want = ceng.generate(toks, steps=8)[0]
    before = tgmm.launches, tflash.launches
    np.testing.assert_array_equal(eng.generate(toks, steps=8)[0], want)
    assert tgmm.launches > before[0] and tflash.launches > before[1]

    def poisoned(alloc):
        def fn(*args, **kw):
            t = alloc(*args, **kw)
            return t.fill_(float("nan")) if t.is_floating_point() else t
        return fn

    monkeypatch.setattr(torch, "empty", poisoned(torch.empty))
    monkeypatch.setattr(torch, "empty_like", poisoned(torch.empty_like))
    monkeypatch.setattr(torch.Tensor, "new_empty",
                        poisoned(torch.Tensor.new_empty))
    np.testing.assert_array_equal(eng.generate(toks, steps=8)[0], want)


@pytest.mark.cuda
def test_cluster_on_the_card_matches_the_cpu(cuda):
    """Reduced Mixtral in fp32 over 3 virtual EP ranks: ``chip_smoke.py``'s
    cluster scenario (a DanceMoE controller, server 2 crashing mid-run with
    failover) gives the same tokens, merged event stream, controller
    decisions, faults section and activation counts on the card (kernels)
    as on the CPU (plain versions), over the same weights."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine

    cfg = get_config("mixtral-8x7b").reduced()
    ceng, _ = build_engine(cfg, device="cpu", dtype=torch.float32,
                           max_len=cs.CLUSTER_PROMPT + cs.CLUSTER_NEW + 8,
                           policy="dancemoe", review_rounds=1000,
                           n_ep=cs.N_SERVERS, seed=2)
    geng = cs.engine_on(ceng, "cuda")
    requests = cs.cluster_requests(cfg)
    before = tgmm.launches
    finite: list = []
    card = cs.run_cluster_once(geng, requests, finite)
    assert tgmm.launches > before
    cs.check_cluster(*card[:2], finite)
    want = cs.cluster_record(*cs.run_cluster_once(ceng, requests)[:2])
    got = cs.cluster_record(*card[:2])
    for key in want:
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# The warmed serving loop: the CUDA-graph ladder and the zero-stall loop
# ---------------------------------------------------------------------------


def _warm_engine(dtype=torch.float32):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine

    cfg = get_config("mixtral-8x7b").reduced()
    eng, _ = build_engine(cfg, device="cuda", dtype=dtype, max_len=64,
                          policy="dancemoe", review_rounds=8)
    return eng


def _warm_stream(rtm, vocab, temperature=0.0):
    """Four staggered arrivals through buckets 1 -> 2 -> 4, a drain to one
    slot, three more (refill 1 -> 4); returns the handles. At a
    ``temperature`` above 0 every other request samples, each with its own
    seed."""
    from repro_torch.serving.api import Request

    rng = np.random.default_rng(0)
    n = iter(range(7))

    def request(p, new):
        k = next(n)
        return Request(prompt=p, max_new_tokens=new, seed=1000 + k,
                       temperature=temperature if k % 2 else 0.0)

    handles = []
    for k in range(4):
        p = rng.integers(0, vocab, 8 + 8 * (k % 2)).astype(np.int32)
        handles.append(rtm.enqueue(request(p, 3 + 2 * k)))
        rtm.step()
    while rtm.active > 1:
        rtm.step()
    handles += [rtm.enqueue(request(rng.integers(
        0, vocab, 16).astype(np.int32), 4)) for _ in range(3)]
    rtm.run()
    return handles


@pytest.mark.cuda
def test_warm_ladder_replays_every_round_with_the_sync_tokens(cuda):
    """Reduced Mixtral, fp32: the ladder has 7 graphs at 4 slots untagged;
    across every occupancy no round runs eagerly; the tokens equal the
    synchronous loop's exactly (the same kernels on the same inputs); a
    drain counts at most one host sync (on the H100 the device is the
    slower side even at this size, so nearly every drain waits for its
    copies); a second runtime made after the first is gone replays its
    graphs over the same buffers without capturing."""
    import gc

    from repro_torch.serving.runtime import ServingRuntime

    eng = _warm_engine()
    vocab = eng.rt.cfg.vocab_size
    sync = _warm_stream(ServingRuntime(eng, max_slots=4, block_size=8), vocab)
    rtm = ServingRuntime(eng, max_slots=4, block_size=8, warmup=True,
                         warmup_origins="untagged")
    assert rtm.executables_compiled == 7 and rtm.warmup_seconds > 0
    warm = _warm_stream(rtm, vocab)
    assert [h.result().tolist() for h in warm] == \
        [h.result().tolist() for h in sync]
    assert rtm.traces_after_warmup == 0
    assert rtm.host_syncs <= rtm.rounds + rtm.prefill_calls
    rtm.check_invariants()
    pool_ptr, seconds = rtm._last_buf.data_ptr(), rtm.warmup_seconds
    del rtm, warm
    gc.collect()
    again = ServingRuntime(eng, max_slots=4, block_size=8, warmup=True,
                           warmup_origins="untagged")
    assert again._last_buf.data_ptr() == pool_ptr
    assert again.executables_compiled == 7
    assert again.warmup_seconds < seconds
    assert [h.result().tolist() for h in _warm_stream(again, vocab)] == \
        [h.result().tolist() for h in sync]
    assert again.traces_after_warmup == 0


@pytest.mark.cuda
def test_warm_copy_on_write_clone_replays_with_the_sync_tokens(cuda):
    """A prompt that is not block-aligned (12 tokens, block 8), served
    twice, one request after the other: the second is a full prefix hit
    whose shared tail block is cloned before its first decode write. On
    the warmed runtime the clone is the captured one, replayed with this
    request's source and destination blocks: no step runs eagerly, and the
    tokens equal the synchronous loop's and the first request's (a clone
    of the wrong block, or of the blocks fixed at capture, would change
    the cached positions 8-11 the hit decodes over). fp32, exact."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    eng = _warm_engine()
    prompt = np.random.default_rng(7).integers(
        0, eng.rt.cfg.vocab_size, 12).astype(np.int32)
    got = {}
    for warmup in (False, True):
        rtm = ServingRuntime(eng, max_slots=4, block_size=8, warmup=warmup,
                             warmup_origins="untagged")
        toks = []
        for _ in range(2):
            h = rtm.enqueue(Request(prompt=prompt, max_new_tokens=6))
            rtm.run()
            toks.append(h.result().tolist())
        assert rtm.cow_copies == 1 and rtm.prefix_hits == 1
        assert rtm.traces_after_warmup == 0
        rtm.check_invariants()
        got[warmup] = toks
    assert got[True] == got[False]
    assert got[True][1] == got[True][0]


@pytest.mark.cuda
def test_serving_steps_make_no_host_sync(cuda):
    """One eager decode step and one eager chunk step on device inputs
    under ``set_sync_debug_mode("error")``: any host sync left in the
    model, the EP dispatch or the sampling (a greedy row and a sampled one)
    raises (a CUDA graph could not hold it)."""
    eng = _warm_engine(torch.bfloat16)
    from repro_torch.models import transformer as tr

    B, bs, P = 2, 8, 4
    pool = tr.init_paged_cache(eng.rt, 1 + B * P, bs)
    last = torch.zeros((B + 1,), dtype=torch.int32, device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    rows = torch.arange(B, **i32)
    tbl = torch.arange(1, 1 + B * P, **i32).view(B, P)
    # one greedy row, one sampled (the seed as the int32 of its bits)
    temps = torch.tensor([0.0, 0.8], device=cuda)
    seeds = torch.tensor([3, -2], **i32)
    chunk = (eng.params, pool, last, rows,
             torch.randint(0, eng.rt.cfg.vocab_size, (B, bs), **i32), tbl,
             tbl[:, 0].contiguous(), torch.zeros((B,), **i32),
             torch.full((B,), bs - 1, **i32), eng.placement,
             torch.ones((B, bs), device=cuda), temps, seeds, None)
    dec = (eng.params, pool, last, rows, torch.full((B,), bs, **i32), tbl,
           eng.placement, torch.ones((B,), device=cuda), temps, seeds, None)
    eng._chunk_step(*chunk)          # first use: kernel builds, workspaces
    eng._dec_step(*dec)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, logits, mstats = eng._chunk_step(*chunk)
        nxt, _, mstats = eng._dec_step(*dec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert first.shape == (B,) and nxt.shape == (B,)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("warmup", [False, True])
def test_paged_rounds_and_chunks_launch_the_paged_kernel(cuda, warmup, pool):
    """Reduced Mixtral in bf16 (over a bf16 or an int8 pool) and in fp32:
    every decode round and every chunk call of the occupancy stream runs
    the paged-attention kernel once per attention layer, eagerly or
    replayed from the ladder (whose graphs carry the launches of their
    captures)."""
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.runtime import ServingRuntime

    dtype, int8 = PAGED_POOLS[pool]
    eng = _warm_engine(dtype)
    if int8:
        eng = ServingEngine(rt=dataclasses.replace(eng.rt, kv_quant=True),
                            params=eng.params, placement=eng.placement,
                            dense_master=eng.dense_master,
                            max_len=eng.max_len)
    pattern, n_groups = eng.rt.cfg.layer_pattern()
    n_attn = n_groups * sum(k in (tr.ATTN, tr.SHARED_ATTN) for k in pattern)
    rtm = ServingRuntime(eng, max_slots=4, block_size=8, warmup=warmup,
                         warmup_origins="untagged")
    leaf = next(iter(rtm.pool.values()))
    assert leaf["k"].dtype == (torch.int8 if int8 else dtype)
    before = dict(tpaged.launches_by_call)
    _warm_stream(rtm, eng.rt.cfg.vocab_size)
    assert rtm.rounds > 0 and rtm.prefill_calls > 0
    assert tpaged.launches_by_call["decode"] - before["decode"] == \
        rtm.rounds * n_attn
    assert tpaged.launches_by_call["chunk"] - before["chunk"] == \
        rtm.prefill_calls * n_attn
    if warmup:
        assert rtm.traces_after_warmup == 0


@pytest.mark.cuda
def test_replays_count_their_kernel_launches(cuda):
    """A capture launches nothing, so it counts nothing; each replay adds
    the launches its capture recorded: one ``moe_gmm`` per MoE layer and
    one paged attention per attention layer (reduced Mixtral has one of
    each a layer)."""
    from repro_torch.serving import graphs
    from repro_torch.serving.runtime import ServingRuntime

    eng = _warm_engine()
    n_moe = eng.n_groups
    before = tgmm.launches
    rtm = ServingRuntime(eng, max_slots=2, block_size=8, warmup=True,
                         warmup_origins="untagged")
    steps = len(graphs.ladder_keys(2, "untagged")) - 1
    # only the eager warm-up runs before each capture launched the kernel
    assert tgmm.launches - before == graphs.WARM_ITERS * steps * n_moe
    g = eng.paged_executable("dec", 8, rtm.max_pages, 2, False,
                             last_buf=rtm._last_buf)
    assert g.launches == {"moe_gmm": n_moe, "moe_gmm.simt": n_moe,
                          "paged_attention": n_moe,
                          "paged_attention.decode": n_moe}
    before = tgmm.launches, tgmm.launches_by_variant["simt"]
    eng.replay(g)
    assert (tgmm.launches, tgmm.launches_by_variant["simt"]) == (
        before[0] + n_moe, before[1] + n_moe)


def _kernels(prof) -> list:
    """(name, stream) of a profile's kernels, in the order they ran."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not e.name().startswith(("Memcpy", "Memset"))]
    return [(e.name(), e.device_resource_id())
            for e in sorted(evs, key=lambda e: e.start_ns())]


@pytest.mark.cuda
def test_traced_ladder_marks_its_phases_and_an_untraced_one_holds_none(
        cuda):
    """A decode graph captured for a traced runtime replays its phase marks
    on the serving stream in order: the round's start, attention and MoE
    of each layer, the head, the end; the same graph captured untraced
    holds no mark, and both count the same launches. A traced engine's
    migration marks its re-gather."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import phase_marks
    from repro_torch.serving.obs import Tracer
    from repro_torch.serving.runtime import ServingRuntime

    eng = _warm_engine()
    n = eng.n_groups
    seen = {}
    for traced in (False, True):
        rtm = ServingRuntime(eng, max_slots=2, block_size=8, warmup=True,
                             warmup_origins="untagged",
                             tracer=Tracer() if traced else None)
        g = eng.paged_executable("dec", 8, rtm.max_pages, 2, False,
                                 last_buf=rtm._last_buf)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.replay(g)
            torch.cuda.synchronize()
        kernels = _kernels(prof)
        marks = [(name[len(phase_marks.PREFIX):], stream)
                 for name, stream in kernels
                 if name.startswith(phase_marks.PREFIX)]
        seen[traced] = marks, g.launches, {s for _, s in kernels}
        del rtm
        gc.collect()
    assert seen[False][0] == []
    marks, launches, streams = seen[True]
    assert [m for m, _ in marks] == (["decode"] + ["attention", "moe"] * n
                                     + ["head", "end"])
    assert len(streams) == 1 and {s for _, s in marks} == streams
    assert launches == seen[False][1] == {
        "moe_gmm": n, "moe_gmm.simt": n, "paged_attention": n,
        "paged_attention.decode": n}
    assert eng.tracer.enabled
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.migrate(tuple(t.cpu().numpy() for t in eng.placement))
        torch.cuda.synchronize()
    assert [name for name, _ in _kernels(prof)
            if name.startswith(phase_marks.PREFIX)] == [
        "phase_mark_regather", "phase_mark_end"]
    assert eng.tracer.by_kind("MIGRATE")


@pytest.mark.cuda
def test_migration_between_replays_equals_a_fresh_engine(cuda):
    """A migration adopted while graphs are captured (written in place)
    changes what the next replays compute exactly as a fresh engine built
    at the new placement computes it: the same tokens, the same gating
    counts per slot's expert."""
    from repro_torch.core.placement import PlacementPlan, build_ep_placement
    from repro_torch.models import moe as TM
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.runtime import ServingRuntime

    eng = _warm_engine()
    cfg = eng.rt.cfg
    E, S, G = cfg.num_experts, eng.rt.ep_spec.slots, eng.n_groups
    rtm = ServingRuntime(eng, max_slots=4, block_size=8, warmup=True,
                         warmup_origins="untagged", prefix_cache=False)
    rng = np.random.default_rng(5)
    ps = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
          for _ in range(3)]
    for p in ps:
        rtm.enqueue(Request(prompt=p, max_new_tokens=3))
    rtm.run()
    # slot s of layer g holds expert (s + g + 1) mod E: every slot moves
    plan = PlacementPlan(assign=[[[(s + g + 1) % E for s in range(E)]]
                                 for g in range(G)],
                         counts=np.full((G, 1), E), num_experts=E)
    new_pl = build_ep_placement(plan, S)
    ptrs = [t.data_ptr() for t in eng.placement]
    eng.migrate(new_pl)
    assert [t.data_ptr() for t in eng.placement] == ptrs
    for got, want in zip(eng.placement, new_pl):
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    hs = [rtm.enqueue(Request(prompt=p, max_new_tokens=6)) for p in ps]
    rtm.run()
    assert rtm.traces_after_warmup == 0
    fresh_params = dict(eng.params)
    fresh_params["groups"] = TM.regather_ep_groups(eng.dense_master, new_pl,
                                                   G)
    fresh = ServingEngine(rt=eng.rt, params=fresh_params, placement=new_pl,
                          dense_master=eng.dense_master, max_len=64)
    frt = ServingRuntime(fresh, max_slots=4, block_size=8, prefix_cache=False)
    fs = [frt.enqueue(Request(prompt=p, max_new_tokens=6)) for p in ps]
    frt.run()
    assert [h.result().tolist() for h in hs] == \
        [h.result().tolist() for h in fs]


# ---------------------------------------------------------------------------
# Seeded sampling and the int8 KV pool on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_threefry_on_the_card_equals_the_cpu(cuda):
    """Bit for bit: the threefry keys, random bits and uniforms on CUDA
    tensors equal those on CPU tensors (fp32 and bf16), for seeds up to
    2**32 - 1 and positions up to 2**20; the Gumbel noise within 2 ulp
    at ``max(|g|, 1)`` (the two devices' ``log`` may differ in the last
    bit) and the sampled tokens equal."""
    from repro_torch.serving import sampling as S

    seeds = np.array([0, 1, 2**31 - 1, 2**32 - 1], np.uint32)
    pos = np.array([0, 5, 2**20, 77], np.uint32)
    k_cpu = S.keys(seeds, pos)
    k_gpu = S.keys(seeds, pos, cuda)
    for a, b in zip(k_cpu, k_gpu):
        assert torch.equal(a, b.cpu())
    bits_cpu = S.random_bits(*k_cpu, 32000)
    bits_gpu = S.random_bits(*k_gpu, 32000)
    assert torch.equal(bits_cpu, bits_gpu.cpu())
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(S.uniform(bits_cpu, dt),
                           S.uniform(bits_gpu, dt).cpu())
        g_cpu = S.gumbel(*k_cpu, 32000, dt).float()
        g_gpu = S.gumbel(*k_gpu, 32000, dt).float().cpu()
        scale = torch.exp2(torch.floor(torch.log2(g_cpu.abs().clamp_min(1))))
        assert bool(((g_cpu - g_gpu).abs()
                     <= 2 * torch.finfo(dt).eps * scale).all())
    logits = torch.from_numpy(_np(4, (4, 32000), 3.0))
    temps = np.array([0.0, 0.5, 0.8, 2.0], np.float32)
    assert torch.equal(S.sample_tokens(logits, temps, seeds, pos),
                       S.sample_tokens(logits.to(cuda), temps, seeds,
                                       pos).cpu())


def _engine_variant(eng, **changes):
    import dataclasses

    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(rt=dataclasses.replace(eng.rt, **changes),
                         params=eng.params, placement=eng.placement,
                         dense_master=eng.dense_master, max_len=eng.max_len)


@pytest.mark.cuda
def test_int8_warm_ladder_replays_with_the_sync_tokens(cuda):
    """Reduced Mixtral, fp32, int8 KV pool: the 7-graph ladder (its
    captures bound to the pool's codes and scales) replays every round of
    the occupancy stream with the synchronous loop's tokens exactly."""
    from repro_torch.serving.runtime import ServingRuntime

    eng = _engine_variant(_warm_engine(), kv_quant=True)
    vocab = eng.rt.cfg.vocab_size
    sync = _warm_stream(ServingRuntime(eng, max_slots=4, block_size=8), vocab)
    rtm = ServingRuntime(eng, max_slots=4, block_size=8, warmup=True,
                         warmup_origins="untagged")
    leaf = next(iter(rtm.pool.values()))
    assert leaf["k"].dtype == torch.int8 and "k_scale" in leaf
    assert rtm.executables_compiled == 7
    warm = _warm_stream(rtm, vocab)
    assert [h.result().tolist() for h in warm] == \
        [h.result().tolist() for h in sync]
    assert rtm.traces_after_warmup == 0
    rtm.check_invariants()


@pytest.mark.cuda
def test_sampled_warm_ladder_replays_with_the_sync_tokens(cuda):
    """Reduced Mixtral, fp32: every other request samples at temperature
    0.8 with its own seed; the replayed ladder (temperatures and seeds in
    its static inputs) draws the synchronous loop's tokens exactly, a
    second warmed runtime that leases the ladder the same again, and the
    sampled streams are not the greedy ones."""
    import gc

    from repro_torch.serving.runtime import ServingRuntime

    eng = _warm_engine()
    vocab = eng.rt.cfg.vocab_size

    def tokens(handles):
        return [h.result().tolist() for h in handles]

    sync = tokens(_warm_stream(ServingRuntime(eng, max_slots=4, block_size=8),
                               vocab, 0.8))
    greedy = tokens(_warm_stream(ServingRuntime(eng, max_slots=4,
                                                block_size=8), vocab))
    rtm = ServingRuntime(eng, max_slots=4, block_size=8, warmup=True,
                         warmup_origins="untagged")
    g = eng.paged_executable("dec", 8, rtm.max_pages, 4, False,
                             last_buf=rtm._last_buf)
    assert g.tail is not None      # the draw, replayed only when hot
    assert tokens(_warm_stream(rtm, vocab, 0.8)) == sync
    assert rtm.traces_after_warmup == 0
    del rtm
    gc.collect()
    again = ServingRuntime(eng, max_slots=4, block_size=8, warmup=True,
                           warmup_origins="untagged")   # leases the ladder
    assert tokens(_warm_stream(again, vocab, 0.8)) == sync
    assert again.traces_after_warmup == 0
    assert sync != greedy


def _remat_step(policy, tok):
    """Reduced EP Mixtral in bf16 on the card (one rank of 4 slots, the
    launch tools' runtime and placement tables), weights from seed 0, one
    forward and backward under ``policy``. Returns (loss, gradient leaves,
    (flash, moe_gmm) forward launches, ``perf.remat_bytes``' bytes)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun, perf
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as ttr
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.train_loop import loss_and_grads

    cfg = get_config("mixtral-8x7b").reduced()
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                global_batch=tok.shape[0],
                                seq_len=tok.shape[1])
    rt = dryrun.make_runtime(cfg, shape, device="cuda", remat_policy=policy)
    params = ttr.init_params(rt, 0)
    table = dryrun.placement_specs(cfg, rt)
    tgt = np.roll(tok, -1, 1)
    before = (tflash.launches, tgmm.launches)
    loss, _, grads = loss_and_grads(rt, params, tok, tgt,
                                    placement=tmoe.placement_to(table, "cuda"))
    torch.cuda.synchronize()
    ran = (tflash.launches - before[0], tgmm.launches - before[1])
    held = perf.remat_bytes(rt, {
        "params": params, "placement": tmoe.EPPlacement(*(
            torch.as_tensor(a) for a in table)),
        "tokens": torch.as_tensor(tok, device="cuda"),
        "targets": torch.as_tensor(tgt, device="cuda")})
    return float(loss), [g.float().cpu() for g in tree_leaves(grads)], ran, held


@pytest.mark.cuda
def test_dots_remat_on_the_card_gives_nones_step_and_holds_more(cuda):
    """Under ``remat_policy="dots"`` the matmul outputs are kept for the
    backward and the hand kernels recomputed: the loss and every gradient
    leaf equal ``none``'s (bf16 backward-kernel tolerance: 3e-2 of a leaf's
    largest value), the flash and ``moe_gmm`` forward kernels still launch
    twice a layer a step, and the forward leaves more bytes allocated for
    the backward, and peaks higher."""
    tok = np.random.default_rng(0).integers(0, 512, (4, 256))
    loss, grads, ran, held = _remat_step("none", tok)
    dloss, dgrads, dran, dheld = _remat_step("dots", tok)
    assert dloss == pytest.approx(loss, rel=1e-5)
    for g, w in zip(dgrads, grads):
        assert _rel_err(g, w) <= 3e-2
    assert ran == dran == (4, 4)  # 2 layers x (forward + recompute)
    assert dheld["saved_bytes"] > held["saved_bytes"], (dheld, held)
    assert dheld["fwd_peak_bytes"] > held["fwd_peak_bytes"], (dheld, held)


@pytest.mark.cuda
def test_shape_only_leaves_cuda_tensors_on_the_kernels(cuda):
    from repro_torch.kernels import ops

    q = torch.randn((1, 64, 4, 64), device=cuda, dtype=torch.bfloat16)
    kv = torch.randn((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    before = tflash.launches
    with ops.shape_only():
        out = ops.flash_attention(q, kv, kv)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1 and out.is_cuda
    meta = torch.empty((1, 64, 4, 64), device="meta", dtype=torch.bfloat16)
    with ops.shape_only():
        assert ops.flash_attention(meta, meta[:, :, :2], meta[:, :, :2]
                                   ).device.type == "meta"
    assert tflash.launches == before + 1


# -- the paged MLA read (``kernels/paged_mla.py``) ----------------------------
# (B, Tq, P, bs): the longdocs cell's decode round and chunk call (32 rows,
# tables of 2060 pages: 32,960 positions), and smaller ones
MLA_CASES = [
    ("longdocs-decode", 32, 1, 2060, 16),
    ("longdocs-chunk", 32, 16, 2060, 16),
    ("decode-B4", 4, 1, 300, 16),
    ("chunk-B3", 3, 16, 300, 16),
]
MLA_POOLS = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _mla_inputs(dev, B, Tq, P, bs, ends, seed=0, dtype=torch.bfloat16):
    """(q, pool, table, offsets) at the published widths (16 heads over
    576-value latent rows): row b's last query sees ``ends[b]`` rows over
    shuffled physical blocks, the table padded with the null block 0; rows
    past ``len(ends)`` are vacant (an all-null table at offset 0)."""
    from repro_torch.kernels import paged_mla as tmla

    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * P
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((B, P), np.int32)
    offs = np.zeros((B,), np.int32)
    for b, end in enumerate(ends):
        n = -(-end // bs)
        table[b, :n] = perm[b * P:b * P + n]
        offs[b] = end - Tq
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, Tq, tmla.HEADS, tmla.LATENT), generator=gen,
                     device=dev) * 0.5).to(dtype)
    pool = torch.randn((n_blocks, bs, tmla.LATENT), generator=gen,
                       device=dev).to(dtype)
    return (q, {"ckv": pool}, torch.from_numpy(table).to(dev),
            torch.from_numpy(offs).to(dev))


MLA_SCALE = 0.1147  # DeepSeek-V2-Lite's softmax scale, to three figures


def _mla_check(o, args, n_live):
    """The kernel's output against the plain version (``gathered_mla``):
    each query of the first ``n_live`` rows within PAGED_TOL of its own
    largest output (the same reasons as the paged attention's: the two
    round P to bf16 at different points and sum in other orders); each
    vacant row's first query, which sees one null-block row, equal to that
    row's values exactly."""
    from repro_torch.models import mla

    want = mla.gathered_mla(*args, MLA_SCALE, 512)
    assert o.dtype == want.dtype and o.shape == want.shape
    B, Tq = want.shape[:2]
    diff = (o.float() - want.float()).abs().reshape(B, Tq, -1).amax(-1)
    scale = want.float().abs().reshape(B, Tq, -1).amax(-1)
    bad = (diff > PAGED_TOL[o.dtype] * scale).nonzero().tolist()
    assert not bad, [(b, t, float(diff[b, t]), float(scale[b, t]))
                     for b, t in bad[:8]]
    assert torch.equal(o[n_live:, 0], want[n_live:, 0])


def _mla_launch(q, pool, table, offs):
    from repro_torch.kernels import paged_mla as tmla

    return tmla.launch(q, pool["ckv"], table, offs, MLA_SCALE, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(MLA_POOLS))
@pytest.mark.parametrize("label,B,Tq,P,bs", MLA_CASES)
def test_paged_mla_kernel_matches_plain(cuda, label, B, Tq, P, bs, pool):
    """Ragged lengths over the table's width (one row at its full width,
    one vacant), each ending anywhere in a page (a chunk's start
    block-aligned), in both pool types; one launch counted by call."""
    from repro_torch.kernels import paged_mla as tmla

    rng = np.random.default_rng(B * P + Tq)
    ends = list(rng.integers(Tq, P * bs + 1, B - 2)) + [P * bs]
    if Tq > 1:
        ends = [max(Tq, e // bs * bs) for e in ends]
    plan = tmla.plan(B, Tq, P, bs, MLA_POOLS[pool])
    assert plan["splits"] > 1 or B * plan["mgroups"] >= tmla.TARGET_BLOCKS
    before = dict(tmla.launches_by_call)
    args = _mla_inputs(cuda, B, Tq, P, bs, ends, dtype=MLA_POOLS[pool])
    o = _mla_launch(*args)
    torch.cuda.synchronize()
    _mla_check(o, args, len(ends))
    call = "decode" if Tq == 1 else "chunk"
    assert tmla.launches_by_call[call] == before[call] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(MLA_POOLS))
@pytest.mark.parametrize("Tq", [1, 16])
def test_paged_mla_at_split_and_tile_edges(cuda, Tq, pool):
    """Lengths of 1, bs, each side of a 32-key tile, of the smallest split
    run and of where the runs grow past it, and the table's full width,
    one row each; a chunk's queries start anywhere."""
    from repro_torch.kernels import paged_mla as tmla

    dtype = MLA_POOLS[pool]
    # a decode block is one row's token: a table wide enough that the
    # splits stop at MAX_SPLITS before the row runs out of tiles
    B, P, bs = 14, 512 if Tq == 1 else 256, 16
    plan = tmla.plan(B, Tq, P, bs, dtype)
    s = plan["splits"]
    assert s > 1
    edge = plan["min_run"] * tmla.TILE * s
    assert edge < P * bs
    ends = [1, bs, bs + 1, 31, 32, 33, 64, 65, edge - 1, edge, edge + 1,
            P * bs - 1, P * bs, 47]
    ends = [max(e, Tq) for e in ends]
    args = _mla_inputs(cuda, B, Tq, P, bs, ends, seed=4, dtype=dtype)
    o = _mla_launch(*args)
    torch.cuda.synchronize()
    _mla_check(o, args, B)


@pytest.mark.cuda
@pytest.mark.parametrize("Tq", [1, 16])
def test_paged_mla_replays_in_a_graph_with_new_lengths(cuda, Tq):
    """Captured once in a CUDA graph, the kernel replays over new lengths,
    tables, queries and pool contents written into the captured tensors;
    the last row stays vacant."""
    B, P, bs = 6, 96, 16
    rng = np.random.default_rng(Tq)
    static = _mla_inputs(cuda, B, Tq, P, bs, [Tq] * (B - 1))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _mla_launch(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _mla_launch(*static)
    flat = lambda a: [a[0], a[1]["ckv"], a[2], a[3]]  # noqa: E731
    for k in range(3):
        ends = [int(e) for e in rng.integers(Tq, P * bs + 1, B - 1)]
        fresh = _mla_inputs(cuda, B, Tq, P, bs, ends, seed=10 + k)
        for dst, src in zip(flat(static), flat(fresh)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _mla_check(out, static, B - 1)


@pytest.mark.cuda
def test_paged_mla_refuses_bad_inputs(cuda):
    """An int8 latent pool, another width, a pool of another type and a
    tensor off the card are refused before any launch."""
    from repro_torch.kernels import paged_mla as tmla

    q, pool, table, offs = _mla_inputs(cuda, 2, 1, 8, 16, [5, 9])
    with pytest.raises(TypeError, match="int8"):
        tmla.launch(q, pool["ckv"].to(torch.int8), table, offs, 0.1)
    with pytest.raises(ValueError, match="built for"):
        tmla.launch(q[..., :512].contiguous(), pool["ckv"], table, offs, 0.1)
    with pytest.raises(TypeError, match="pool of"):
        tmla.launch(q, pool["ckv"].float(), table, offs, 0.1)
    with pytest.raises(TypeError, match="on the card"):
        tmla.launch(q.cpu(), pool["ckv"], table, offs, 0.1)


def _mla_engine(dtype=torch.bfloat16):
    """DeepSeek-V2-Lite reduced (one dense and two MoE layers at the
    kernel's latent widths) over three virtual EP ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine

    cfg = get_config("deepseek-v2-lite-mla").reduced()
    eng, _ = build_engine(cfg, device="cuda", dtype=dtype, max_len=64,
                          policy="dancemoe", review_rounds=8, n_ep=3,
                          slots=4)
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(MLA_POOLS))
@pytest.mark.parametrize("warmup", [False, True])
def test_mla_rounds_and_chunks_launch_one_paged_mla_a_layer(cuda, warmup,
                                                            pool):
    """Every decode round and every chunk call of the occupancy stream runs
    the paged MLA kernel once per MLA layer, the dense layer's included,
    eagerly or replayed from the ladder; the GQA kernel never runs."""
    from repro_torch.serving.runtime import ServingRuntime
    from repro_torch.kernels import paged_mla as tmla

    eng = _mla_engine(MLA_POOLS[pool])
    n_mla = eng.rt.cfg.num_layers
    rtm = ServingRuntime(eng, max_slots=4, block_size=16, warmup=warmup,
                         warmup_origins="untagged")
    assert set(rtm.pool) == {"prefix.b0", "b0"}
    before = dict(tmla.launches_by_call), tpaged.launches
    _warm_stream(rtm, eng.rt.cfg.vocab_size)
    assert rtm.rounds > 0 and rtm.prefill_calls > 0
    assert tmla.launches_by_call["decode"] - before[0]["decode"] == \
        rtm.rounds * n_mla
    assert tmla.launches_by_call["chunk"] - before[0]["chunk"] == \
        rtm.prefill_calls * n_mla
    assert tpaged.launches == before[1]
    if warmup:
        assert rtm.traces_after_warmup == 0
        g = eng.paged_executable("dec", 16, rtm.max_pages, 4, False,
                                 last_buf=rtm._last_buf)
        assert g.launches["paged_mla"] == n_mla
        assert "paged_attention" not in g.launches


@pytest.mark.cuda
def test_mla_warm_tokens_equal_the_sync_tokens(cuda):
    """bf16, the same requests through the synchronous loop and the warmed
    ladder (the prefix layer's pool and the copy-on-write clone captured
    with the rest) give the same tokens."""
    from repro_torch.serving.runtime import ServingRuntime

    eng = _mla_engine()
    out = []
    for warmup in (False, True):
        rtm = ServingRuntime(eng, max_slots=4, block_size=16, warmup=warmup,
                             warmup_origins="untagged")
        out.append([list(h.tokens) for h in
                    _warm_stream(rtm, eng.rt.cfg.vocab_size)])
    assert out[0] == out[1]


@pytest.mark.cuda
def test_gqa_ladder_launches_no_mla(cuda):
    """Reduced Mixtral's captured decode and chunk graphs launch what they
    did before the MLA read came: ``moe_gmm`` and paged attention once a
    layer, nothing of the MLA kernel."""
    from repro_torch.serving.runtime import ServingRuntime

    eng = _warm_engine(torch.bfloat16)
    n = eng.n_groups
    rtm = ServingRuntime(eng, max_slots=2, block_size=8, warmup=True,
                         warmup_origins="untagged")
    for kind, call in (("dec", "decode"), ("chunk", "chunk")):
        g = eng.paged_executable(kind, 8, rtm.max_pages, 2, False,
                                 last_buf=rtm._last_buf)
        assert g.launches == {"moe_gmm": n, "moe_gmm.tc": n,
                              "moe_gmm.stream": n, "paged_attention": n,
                              f"paged_attention.{call}": n}
