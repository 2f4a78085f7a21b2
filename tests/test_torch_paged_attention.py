"""The paged-attention read of the serving steps, on the CPU: the read
off the card (``models.attention.paged_attention``, the kernel's plain
version ``gathered_attention``) against the serving steps' arithmetic
before the kernel, bit for bit, and against the oracle
``paged_attention_ref``; ``attn_apply``'s choice of the read by device for
every pool layout; the kernel's launch plan. The kernel itself runs on the
card (``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.models import attention as TA

BS, P = 8, 6  # block size and pages a row of the small pools


def _paged_case(grp, hd, Tq, seed=0):
    """Three rows over a pool of shuffled physical blocks: row 0 ends
    mid-page on its third page, row 1 fills five of its six pages, row 2
    is vacant (an all-null table at offset 0); unused table entries are
    the null block 0."""
    rng = np.random.default_rng(seed)
    kvh, B = 2, 3
    n_blocks = 1 + 2 * P
    ends = [2 * BS + 3, 5 * BS]  # keys the last query of rows 0, 1 sees
    offs = np.array([ends[0] - Tq, ends[1] - Tq, 0], np.int32)
    blocks = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((B, P), np.int32)
    table[0, :3] = blocks[:3]
    table[1, :5] = blocks[3:8]
    q = rng.standard_normal((B, Tq, grp * kvh, hd))
    pools = rng.standard_normal((2, n_blocks, BS, kvh, hd))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, *pools)]
    return (*bf, torch.from_numpy(table), torch.from_numpy(offs))


@pytest.mark.parametrize("Tq", [1, BS])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("grp", [1, 6, 8])
def test_plain_is_the_gathered_read_bit_for_bit(grp, hd, Tq):
    """The read off the card equals ``paged_gather`` then
    ``decode_attention`` (Tq 1) or the causal ``chunked_attention`` (Tq =
    bs) exactly, and the oracle within two bf16 ulps of the largest output
    (the plain version rounds q * hd^-0.5 and the softmax weights to bf16,
    the oracle does not)."""
    q, kp, vp, table, offs = _paged_case(grp, hd, Tq, seed=grp * hd + Tq)
    got = TA.paged_attention(q, {"k": kp, "v": vp}, table, offs)
    kc, vc = TA.paged_gather({"k": kp, "v": vp}, table, q.dtype)
    if Tq == 1:
        want = TA.decode_attention(q, kc, vc, offs)
    else:
        want = TA.chunked_attention(q, kc, vc, causal=True, q_offset=offs)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    oracle = paged_attention_ref(q, kp, vp, table, offs).float()
    err = float((got.float() - oracle).abs().max())
    assert err <= 2 * 2 ** -8 * float(oracle.abs().max())


@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("mode", ["decode", "chunk"])
def test_attn_apply_routes_every_pool_by_device(monkeypatch, mode, pool):
    """On the CPU every pool layout's paged read is the gathered read
    (``gathered_attention`` on the pool as written) and the kernel is not
    called; with the query on the card (``ops.on_card`` answering yes),
    every layout goes to ``ops.paged_attention``, an int8 pool with its
    scales."""
    cfg = get_config("mixtral-8x7b").reduced()
    dtype = torch.float32 if pool == "float32" else torch.bfloat16
    gen = torch.Generator().manual_seed(1)
    params = TA.attn_params(gen, cfg, 1, dtype=dtype, device="cpu")
    T = 1 if mode == "decode" else BS
    pos = torch.tensor([9, 8] if mode == "decode" else [8, 0],
                       dtype=torch.int32)
    table = torch.tensor([[3, 5, 0], [6, 2, 8]], dtype=torch.int32)
    paged = {"page_table": table}
    if mode == "chunk":
        paged["write_blocks"] = torch.tensor([5, 6], dtype=torch.int32)
    x = torch.randn((2, T, cfg.d_model), generator=gen).to(dtype)
    calls = []

    def spy(q, k_pool, v_pool, page_table, q_offset, k_scale, v_scale):
        calls.append((k_pool.dtype, k_scale is not None, v_scale is not None))
        cache = {"k": k_pool, "v": v_pool}
        if k_scale is not None:
            cache.update(k_scale=k_scale, v_scale=v_scale)
        return TA.gathered_attention(q, cache, page_table, q_offset)

    monkeypatch.setattr(TA.ops, "paged_attention", spy)
    outs = []
    for card in (False, True):
        monkeypatch.setattr(TA.ops, "on_card", lambda t, name: card)
        cache = TA.init_paged_kv(cfg, 9, BS, dtype=dtype,
                                 quantized=pool == "int8", device="cpu")
        got, cache = TA.attn_apply(params, cfg, x, ep=1, mode=mode,
                                   cache=cache, pos=pos, paged=paged,
                                   residual=False, norm_eps=cfg.norm_eps)
        assert len(calls) == int(card)
        outs.append(got)
    int8 = pool == "int8"
    assert calls == [(torch.int8 if int8 else dtype, int8, int8)]
    h = TA.rms_norm(x, params["norm"], cfg.norm_eps)
    q = TA._project_qkv(params, h, cfg, 1)[0]
    positions = (pos[:, None] + torch.arange(T)[None])
    q = TA.apply_rope(q, positions, cfg.rope_theta)
    want = TA.gathered_attention(q, cache, table, pos)
    want = want.reshape(2, T, -1) @ params["wo"]
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)


@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False),
                                        (torch.bfloat16, True),
                                        (torch.float32, False)])
@pytest.mark.parametrize("B,Tq,H,KVH,hd,P,bs", [
    (32, 1, 48, 8, 128, 320, 16),    # chat decode, the widest bucket
    (1, 1, 48, 8, 128, 320, 16),     # chat decode, one row
    (2, 16, 48, 8, 128, 320, 16),    # a chat chunk call
    (16, 16, 48, 8, 128, 528, 16),   # the docs chunk call
    (4, 16, 96, 8, 128, 40, 16),     # grp 12: two row groups
    (2, 1, 4, 4, 80, 3, 8),          # grp 1 at hd 80, a short table
    (8, 8, 64, 8, 64, 12, 8),        # grp 8 at hd 64
])
def test_paged_attention_plan(B, Tq, H, KVH, hd, P, bs, dtype, int8):
    """The grid follows static shapes: bf16, a warp per 16 query rows, at
    most 8 a block; fp32, a block of 4 warps per 16 query rows; splits fill
    the card's target of blocks where a row of the table's width has tiles
    enough, never more than 32; the shared memory fits an SM's; scratch
    only with more than one split."""
    p = tpaged.plan(B, Tq, H, KVH, hd, P, bs, dtype, int8)
    grp = H // KVH
    mtiles = -(-grp * Tq // 16)
    if dtype == torch.float32:
        assert p["mgroups"] == -(-grp * Tq // tpaged.SIMT_ROWS)
        assert p["warps"] == tpaged.SIMT_WARPS and p["smem_bytes"] == 0
    else:
        assert p["warps"] <= tpaged.MAX_WARPS
        assert p["warps"] * p["mgroups"] >= mtiles
        assert (p["warps"] - 1) * p["mgroups"] < mtiles
        ring = 2 * tpaged.STAGES * tpaged.TILE * (hd + (16 if int8 else 8))
        ring *= 1 if int8 else 2
        tile = 2 * tpaged.TILE * (hd + 8) * 2 if int8 else 0
        assert p["smem_bytes"] == ring + tile <= 232448
    s = p["splits"]
    assert 1 <= s <= tpaged.MAX_SPLITS
    assert p["grid"] == (s, KVH * p["mgroups"], B)
    assert p["min_run"] == max(tpaged.MIN_TILES,
                               grp * Tq // (tpaged.RUN_ROWS * p["mgroups"]))
    longest = -(-P * bs // (tpaged.TILE * p["min_run"]))
    blocks = B * KVH * p["mgroups"]
    assert (s * blocks >= tpaged.TARGET_BLOCKS or s == tpaged.MAX_SPLITS
            or s == longest)
    assert (s - 1) * blocks < tpaged.TARGET_BLOCKS
    if s == 1:
        assert p["partials"] is None and p["stats"] is None
    else:
        assert p["partials"] == (s, B, Tq, H, hd)
        assert p["stats"] == (s, B, Tq, H, 2)


def test_cpu_paged_read_counts_no_launch():
    """The read off the card launches nothing, and the kernel's entry
    refuses a tensor off the card (its plain version is the caller's)."""
    q, kp, vp, table, offs = _paged_case(6, 64, 1)
    before = (tpaged.launches, dict(tpaged.launches_by_call))
    TA.paged_attention(q, {"k": kp, "v": vp}, table, offs)
    assert before == (tpaged.launches, dict(tpaged.launches_by_call))
    with pytest.raises(TypeError):
        tops.paged_attention(q, kp, vp, table, offs)
    counts = tops.launch_counts()
    assert {"paged_attention", "paged_attention.decode",
            "paged_attention.chunk"} <= set(counts)
